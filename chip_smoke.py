"""Drive the PyTorch/CUDA port (buckgnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require CUDA; print the card's name and power limit; turn TF32 off;
  2. build the native host library (csrc/native.cpp, g++; a failed build
     is fatal) and every CUDA kernel of the port from the sources (nvcc,
     sm_90a), one nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card, at the
     flagship shape (weights with a nonzero bias) and on one small ragged
     batch: the forward's serving and training variants (z, the emitted
     table, the residuals y, inv and agg, and the dropped positions at
     dropout 0.1), and the backward (dx, dW_l, dW_r, db_l and the own star
     table, with the next layer's star on and off, the skip on and off, at
     dropout 0 and 0.1); show that the gates fail a wrong norm, a dropped
     bias, a norm backward without its s term and a backward that ignores
     the next layer's star;
  4. serve the flagship model (6 layers, hidden 512, bf16, 128 supernode
     panels) through eval_step: a few requests on the packed batch, the
     serving benchmark and the INFERENCE_TIMER protocol; check the kernel
     launch counts and finite outputs, and hold the whole forward against
     the plain path on the card. Then train it (dropout 0.1, Adam, lr
     1e-3): a few checked steps, the training benchmark and a profile of
     the step, with the launch counts of that run (6 of each kernel per
     step) and one line per pass of the SAGE kernels (device ms,
     operations, TFLOP/s); and hold one step's loss and gradients against
     the plain path on the card, from the same dropout seeds;
  5. the virtual-edge cell (``config="virtual"``: 128 panels with
     virtual edges, whose out-of-band edges take the spill path): hold
     the forward's spill term (serving and training variants), the split
     backward's tile kernel (skip on and off, dropout 0 and 0.1, and a
     supernode + spill batch) and the banded SpMM (spill window, acc and
     table, alone and together) against their plain versions at the
     virtual shape and on small ragged batches, the two split kernels'
     determinism, and gates that fail a forward and a banded product
     without their spill term; serve the cell (6 forward launches per
     forward, the forward against the plain path) and train it (6
     forward, 6 tile and 6 banded launches per step and no merged
     backward; one step's gradients against the plain path; its SAGE
     passes by line);
  6. the ea-virtual cell (``config="ea-virtual"``: EA_GNN_Shared on 64
     virtual-edge panels, tile 128, width 64): hold the fused EA block's
     forward (zx, ze, e1s, m1s and both dropout masks) and backward
     (folded dx, de_win, every dW and dbias) against their plain versions
     at the cell's shape and on two small ragged batches (one whose slot
     count is not a multiple of the kernels' 64-slot blocks), in plain and
     encoder
     mode, skip on and off, dropout 0 and 0.1; show that the gates fail a
     forward without its far senders, its cnt * b_p1 term or its skip,
     a backward without its halo or far fold, and faults confined to a few
     rows of dx (one node's sender run, one far rank, one clamped tile's
     halo) and to dW_sp; the same bits twice; serve
     the cell (6 ea_block_fwd launches per forward, the forward against
     the plain path) and train it (6 ea_block_fwd and 6 ea_block_bwd per
     step and no SAGE kernel; one step's loss, and the gradients of a
     linear readout of the pooled features, against the plain path at
     three generator seeds), printing one line per pass of both kernels
     from the train step's profile (device ms, operations, TFLOP/s) and
     the train step's peak device memory;
  7. time each kernel beside its bound, its plain version and a PyTorch
     composition of the same function, at the shape its main path gives;
  8. general graphs, the csr-virtual cell (``config="csr-virtual"``: the
     virtual cell's 128 panels packed without a band, impl "pallas") and
     its twin ``csr-virtual-xla`` (impl "xla", the JAX package's default):
     hold the CSR segment sum (forward, and backward over the transposed
     CSR; add and mean) against its plain version at the cell's shape (H
     512 and 128), on a small graph with an 800-degree hub and on a ragged
     batch packed by suggest_capacities whose dead row owns thousands of
     pad edges; hold the epilogue's forward and backward, with and without
     the skip at dropout 0.1, to their plain versions bit for bit; show
     that the gates fail a CSR sum without the last edge of each run, a
     mean that divides before it rounds, an epilogue mask from the wrong
     seed word and a backward without the relu mask; the same bits twice;
     serve csr-virtual (6 CSR launches per forward, no other kernel) and
     train it (6 + 6 CSR launches, 6 epilogue forwards and 6 backwards per
     step, no SAGE or EA kernel; one step's gradients against the plain
     path at two generator seeds), serve and train the xla twin (no CSR
     launch, the epilogue kernels in training), time the three kernels
     and print #7's tail (its time beside the batch's longest runs, and
     on the 800-degree hub);
  9. the unfused banded path (ops/banded.py) and the rest of the model
     family: ``virtual-remat`` and ``flagship-remat`` (the virtual and
     flagship cells with remat=True: per layer kernel #4 in the forward,
     again in the recompute and in the backward, the epilogue kernels; no
     fused SAGE kernel), each served and trained, gated against the plain
     path, with one train step's own memory beside the virtual cell's;
     the spill2 batch (a hub whose tile's spill window overflows) through
     the banded aggregation forward and backward at H 512 against its
     plain version, with a gate that fails a sum without spill2;
     ``virtual-bandless`` (materialize_band=False: the device-built band
     bit for bit the packed one, its serve against the packed batch's);
     ``virtual-meanaggr`` (GraphSage_meanAggr: per-layer weights,
     MaskedBatchNorm, mean by degree; 6 #4 per forward, 12 per step, the
     epilogue kernels); ``ea-windowed`` (EA_GNN with remat=True on the
     ea-virtual batch: the unfused windowed blocks, no kernel), with its
     step memory beside ea-virtual's; and the family: every model_name
     under every pooling (buckling, banded_pallas) and every node-level
     head (impl pallas) at H 128, 3 layers, its pred and one train step's
     loss against the plain path;
 10. the training run (``run``): train_gnn for 3 epochs at the flagship
     cell's config (bench.py::cell_config: dropout 0.1, lr 1e-3, batch 128)
     on 256 train and 64 val supernode panels it packs itself (band
     geometry, RCM, 4-tile alignment), with its launch counts (6 #1 per
     train step and val batch, 6 #2 per train step), finite epochs and its
     last and best checkpoints; the resume check at dropout 0 (2 epochs
     resumed to 3 against 3, the third epoch's losses and the parameters,
     and whether they are bit-equal); run_inference on weights/best (6 #1
     per batch, its MAPE the best epoch's val MAPE); the epoch loop's step
     time beside the flagship bench's (``run/loop_overhead``) and the line
     of ``python -m buckgnn_tpu_torch.bench``; the runs' log folders (the
     trainer's own MetricsWriter) stay for phase 15;
 11. the command line on folder datasets (``cli``), in the README's order
     through ``cli.main``: three ``python -m buckgnn_tpu_torch datagen``
     processes at once (256 cases with stiffeners into D/Train, 64 into
     D/Validation, 96 into a folder of the default flags' own), ``split``
     of D/Train with the flagship's data flags (the manifest's sizes add
     up to 256), ``train --data-dir D`` at the flagship's flags for 3
     epochs (the launches its batches imply: #1 per layer for each train
     step and val batch, #2 for each step on a batch without spill edges,
     #3 and #4 for each one with them; no other kernel), ``infer`` on its
     weights/best (#1 only; its MAPE within PRED_TOL of the best val
     MAPE), ``timer`` (#1 only; nastran null), ``train`` at the JAX
     package's default flags (float32, impl xla, H 128, virtual edges; #8
     and #9 only, in float32), the same with ``--segment-impl
     banded_pallas`` on D for 2 epochs (phase 13's: the float32 variants
     of #1, #3 and #4 as its batches imply, no engine kernel) and
     ``infer`` on its weights/best (#1's variant; its MAPE the run's best
     val MAPE), the same with ``--model-name EA_GNN_Shared`` (phase 14's:
     the float32 variants of #5 and #6, 6 of each per train step and 6
     of #5 per val batch, no other kernel) and ``infer`` on it (#5's
     variant only; its MAPE the run's best val MAPE), ``tune --synthetic
     64 --max-concurrent 2``
     (two trials on the card in overlapping intervals, SAGE kernels only)
     and ``python -m buckgnn_tpu_torch --help``;
 12. multi-GPU (``multi``): the ea-virtual batch split into 2 and 4 tile
     ranges (parallel/ea_shard.py); on every shard #5 and #6 in 'hybrid'
     mode (and 'autodiff' at D = 2; dropout 0 and 0.1 on one shard)
     against their plain versions, the appended far rows' gradient
     included; the shards adding up, with no collective, to the unsharded
     block (zx and ze concatenated, dx and every dW summed); the gates
     failing a backward that folds the remote rows into the shard's own
     rows and a forward that reads the far rows from the shard's own x.
     Then one process per card (``spawn``, NCCL, world =
     ``torch.cuda.device_count()``, printed): the dry run
     (parallel/dryrun.py: the DP x partitioned flagship step and the DP x
     tile-sharded EA step, each against its one-device oracle),
     ``train_gnn(segment_impl="banded_partitioned")`` for 2 epochs at the
     flagship's config on the run phase's panels (#8 and #9) and at
     EA_GNN_Shared on the ea-virtual panels (#5 and #6 in 'hybrid' through
     ``ea_tp_stack``), the DP step on the flagship batch (#1 and #2 on each
     rank), each with exact launches; the DP step's loss and update
     against the plain train step's, the partitioned model's forward and
     gradients (float32) and the tile-sharded model's forward and readout
     gradients against the unpartitioned paths; then ``python -m
     buckgnn_tpu_torch scale --n-devices <world>``. One ``multi`` line per
     run with its world and step ms beside the card;
 13. float32 and every H % 128 == 0 (``widths``): kernels #1-#4's simple
     variants (csrc/sage_simple.cu, chosen by
     ops/banded_matmul.py::kernel_variant) against their plain versions,
     each launch counted under its own name, in float32 at H 128, 384,
     512, 640 and 1024 and in bf16 at 384, 640 and 1024, on the flagship
     batch (#1 serving with local windows and emit, training with the
     whole table at dropout 0.1; #2 with the next layer's star at dropout
     0.1 and without at 0), the virtual batch (#1's spill term; #3 at
     dropout 0.1 and 0; #4 as the split backward calls it, in x's dtype and
     in float32) and the supernode + spill batch (#4 with the table),
     within bm.variant_tol (float32: 1e-5 of max|plain|); the gates
     failing a wrong norm, a dropped bias, a forward without its spill
     term, a norm backward without its s term, a backward without the
     next layer's star and a band product without its spill messages;
     float32 kept (the products run in 3xTF32 on the tensor cores, on
     csrc/wtile.cuh's weight tile): #3's outputs at every float32 width within 1e-5 of
     max|ref| of a float64 evaluation of its plain version, and at H 512
     one TF32 pass (bm.mm_3xtf32 without its lo terms) of two of its
     products on the card's operands outside that gate; the flagship-f32
     and virtual-f32 cells served and trained (6 #1 per forward; 6 #1 and
     6 #2, or 6 #1, 6 #3 and 6 #4, per step; no engine kernel), each
     against the plain path, with each product pass's device ms and
     TFLOP/s a step (``sage_tile``: the forward's product, the backward's
     dagg | dxp and its weight pass, all on wtile_kernel; the pre-splits,
     the weight pass's partial sums and the code sums beside them; it
     fails if a SAGE product ran on gemm_kernel); #1's float32 variant
     twice the same bits; each
     variant's time at its float32 main path's shape
     beside its bound (3 tf32 products for each float32 one at 495
     TFLOP/s, other f32 operations at 67, against bytes), its plain
     version and the float32 torch composition (TF32 off);
 14. float32 and every H % 128 == 0 for the EA kernels (``ea_widths``):
     #5 and #6's simple variants (csrc/ea_simple.cu, the same rule)
     against their plain versions, each launch counted under its own
     name, at every (dtype, H) of phase 13 on three small ragged EA
     batches (one ends in a partial 64-slot block, one at tile 64 has N /
     64 odd) and in float32 at H 512 on the ea-virtual batch, in plain and
     encoder mode, skip on and off, dropout 0 and 0.1, within
     eb.variant_fwd_tol (float32: 1e-5 of max|plain|) and eb.bwd_tol; in
     'hybrid' and 'autodiff' on one shard of a two-way tile split, the
     appended far rows' gradient included; the gates failing, at the
     float32 tolerance, a forward without its far senders, its cnt * b_p1
     term or its skip, a backward without its sender fold and a dW_sp
     without the far slots; the same bits twice (also at float32 H 512 on
     the ea-virtual batch, plain and encoder mode); #6's float32 outputs on
     the ea-virtual batch against a float64 evaluation of its plain
     version at its gates, and one TF32 pass of two of its products
     outside the float32 gate; the ea-virtual-f32 cell
     (EA_GNN_Shared in float32, H 512) served and trained (6 #5s per
     forward, 6 #5s and 6 #6s per step, no engine or SAGE kernel; the
     forward, the loss and its gradients against the plain path at
     PRED_TOL and GRAD_TOL), one line per pass of each variant from the
     train step's profile (with each product tile's own ms and TFLOP/s:
     wtile_kernel for the products of weights as stored or transposed,
     gemm_kernel for the weight pass, `ea_tile_flops`; it fails if another
     EA product ran on gemm_kernel),
     its step memory, and each variant's time beside its bound, its plain
     version and the float32 composition;
 15. the host side (``host``): fail unless utils/native.py loaded its C++
     library; native RCM against ``_rcm_order_numpy`` on the flagship's
     and the virtual cell's 128 panels (the mesh-only edge sets
     rcm_reorder orders, graph/build.py::rcm_edges), ``band_fraction``
     native against its NumPy branch at widths 64, 128 and 256 under those
     orders, ``shell_edges_native`` against the NumPy path on 32 meshes of
     24-32 a side, ``select_band_geometry`` on the flagship panels native
     against NumPy (the same geometry); utils/harvest.py on phase 10's
     folder (the run found with its train_config.json, its
     Perf/train_step_ms series the values phase 10 read, run_index.json
     and the metric .npz files); ``segment_softmax_weights`` on the card
     against the CPU over the flagship batch's graphs, each weight and
     each non-empty segment's total (1) within ``softmax_tol``, the float32
     summation bound of the largest segment; the feature names of
     utils/visualization.py as wide as the flagship's x, and its feature
     table. One ``host`` line: the seconds of each native and NumPy pair,
     the card and the host CPU's model. The plots and the connectivity
     reports need matplotlib and networkx, which the card's machine lacks:
     this phase does not call them (the CPU tests hold them).
Prints JSON lines (serving and training numbers, then the kernel table),
the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from buckgnn_tpu_torch.bench import (
    build_serve_setup, build_train_setup, pack_exact, run_serve_bench,
    run_train_bench,
)
from buckgnn_tpu_torch.eval.timer import time_gnn_forward
from buckgnn_tpu_torch.graph.batch import (
    batch_iterator, select_band_geometry, star_table_geometry,
    suggest_capacities,
)
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.buckgnn import star_threading
from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import csr_segment as cs
from buckgnn_tpu_torch.ops import ea_block as eb
from buckgnn_tpu_torch.ops import epilogue as ep
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context
from buckgnn_tpu_torch.ops.dropout import (
    apply_dropout, dropout_scale, keep_mask,
)
from buckgnn_tpu_torch.utils import cuda_build, native
from buckgnn_tpu_torch.utils.logging import MetricsWriter

# kernel vs plain (allclose-style, atol + rtol * |ref|), reasons beside
# their definitions: z within sl.KERNEL_Z_TOL, the emitted table within
# sl.KERNEL_TABLE_TOL of the plain emission of the kernel's own z.
# whole 6-layer forward, kernel path vs plain path: the per-layer bf16
# flips are averaged by the mean pool over ~800 rows, so pred (|pred| ~
# 0.1) moved by about 1e-4 on the card; 2e-3 leaves room for other data.
PRED_TOL = (2e-3, 2e-3)
# one train step, kernel path vs plain path from the same dropout seeds:
# the loss as the forward's pred; each parameter's gradient by the norm of
# its difference over its norm. Each layer's bf16 roundings (z, dout, dagg,
# dx) can flip to the neighbouring value, 2^-8 relative, in a small share
# of entries, and the gradients are sums over ~1e5 rows of such products:
# flips of random sign move them by far less than 1%; a wrong mask, a lost
# star, a lost spill term or a lost norm term moves them by O(1). The
# pooled decoder's parameters see only 128 graphs' sums, and a flip there
# can move a decoder relu across its hinge: on an H100 the virtual-edge
# step's worst parameter over generator seeds 11-14 was decoder.lin_0.bias
# at seed 11, 1.63% (0 at seeds 12-14), every SAGE weight under 0.31%, and
# the flagship's worst at seed 11 0.73%.
GRAD_TOL = 2e-2
# the EA cell's whole forward, kernel path vs plain path: the blocks carry
# no norm, so each layer's bf16 roundings reach the pooled features and
# the decoder's bf16 output as an absolute noise of about one ulp of a
# unit-scale prediction, whatever the prediction's own size: 0.0156 at
# |pred| = 2.07 with the earlier untruncated weights, and 0.0020-0.0078
# at |pred| <= 0.48 with the lecun-normal ones, while each bf16 path lies
# 0.003-0.027 from the float32 forward of the same weights
# (tools/ea_bf16_noise.py on an H100, generator seeds 11-18, fresh and
# after 15 steps). Two ulps of a unit prediction, 1.6e-2, absolute and
# relative. A lost far sender, bias term or skip in any layer moves zx by
# O(1) and pred by far more.
EA_PRED_TOL = (1.6e-2, 1.6e-2)
# The EA cell's loss gradients cannot be held to the plain path at
# GRAD_TOL: with the lecun-normal weights they are chaotic in bf16. In
# the same measurement both bf16 paths lie 1.7-58% (max over the
# parameters) from the float32 plain path's loss gradients, the kernel
# path no farther than the plain one in distribution, and 0.4-14% from
# each other: the decoder sees 64 graphs, 0-7 of whose relu decisions
# flip between the two bf16 paths, each moving every upstream gradient. A
# fixed random linear readout of the pooled features (the decoder's
# input) has no such hinge: from it the kernel path's gradients lie
# 0.54-0.70% from the plain path's, and both 1.3-2.0% from float32. So
# the EA step holds the loss within EA_PRED_TOL and the readout's
# gradients (every parameter but the decoder's, which both paths compute
# in PyTorch) within GRAD_TOL.
READOUT_SEED = 5
PEAK_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM (data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM (data sheet)
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores, H100 SXM (data sheet)
PEAK_TF32 = 495e12  # dense TF32 tensor-core peak, H100 SXM (data sheet)
TPU_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:231"
TPU_BWD_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:706"
TPU_TILE_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:600"
TPU_BANDED_KERNEL = "buckgnn_tpu/ops/pallas_banded.py:80"
TPU_EA_FWD_KERNEL = "buckgnn_tpu/ops/pallas_ea_block.py:234"
TPU_EA_BWD_KERNEL = "buckgnn_tpu/ops/pallas_ea_block.py:383"
TPU_CSR_KERNEL = "buckgnn_tpu/ops/pallas_segment.py:48"
TPU_EPI_FWD_KERNEL = "buckgnn_tpu/ops/pallas_epilogue.py:62"
TPU_EPI_BWD_KERNEL = "buckgnn_tpu/ops/pallas_epilogue.py:78"
SEED = (0x1234567, 0x89ABCDEF)  # dropout seed words of the layer checks
RATE = 0.1  # the flagship's dropout rate (TrainConfig default)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def within(got, ref, tol):
    atol, rtol = tol
    err = (got.float() - ref.float()).abs()
    ok = (bool(torch.isfinite(got.float()).all())
          and not bool((err > atol + rtol * ref.float().abs()).any()))
    return ok, float(err.max())


def check_close(name, got, ref, tol):
    ok, max_err = within(got, ref, tol)
    print(json.dumps({"check": name, "max_abs_err": max_err, "atol": tol[0],
                      "rtol": tol[1], "ok": ok}))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {max_err})")
    return max_err


def check_caught(name, wrong, ref, tol):
    """A deliberately wrong layer output must fail the gate `tol`."""
    ok, max_err = within(wrong, ref, tol)
    print(json.dumps({"gate": name, "max_abs_err": max_err, "atol": tol[0],
                      "rtol": tol[1], "caught": not ok}))
    if ok:
        fail(f"{name}: the kernel-vs-plain gate lets a wrong layer pass")


def check_weights(h, x, mask, seed, dtype=torch.bfloat16):
    """(W_l, b_l, W_r) in ``dtype`` from a seeded generator: lecun-normal
    weights and a bias as large as a row of x @ W_r (|x| rms per entry),
    so a kernel that drops or misplaces b_l fails the z gate."""
    g = torch.Generator().manual_seed(seed)
    w_l, w_r = (torch.randn(h, h, generator=g) / math.sqrt(h)
                for _ in range(2))
    rms = float(x[mask].float().pow(2).mean().sqrt())
    b_l = torch.randn(h, generator=g) * rms
    return tuple(t.to(x.device, dtype) for t in (w_l, b_l, w_r))


def layer_inputs(batch, x, weights, windows, emit, skip):
    if not windows:
        batch = batch.replace(gwin=None, lcode=None, lacc=None)
    code, gwin, gw, acc = sl.star_codes(batch)
    t0, tg = star_table_geometry(batch.n_graph_cap)
    table = sl._super_tables(x, batch.node_graph, batch.node_mask,
                             batch.supernode_index, batch.n_graph_cap, tg)
    w_l, b_l, w_r = weights
    kw = dict(tile=batch.band_tile, width=batch.band_width, table=table,
              code=code, gwin=gwin, gw=gw, t0=t0,
              acc_code=acc if emit else None, skip=skip, emit=emit)
    return (x, w_l, b_l, w_r, make_agg_context(batch).band), kw, batch


def kernel_vs_plain(name, batch, x, weights, windows, emit, skip):
    args, kw, b = layer_inputs(batch, x, weights, windows, emit, skip)
    return fwd_vs_plain(name, args, kw, b.node_mask)


def fwd_vs_plain(name, args, kw, m):
    """The serving variant against the plain one on prepared inputs: z
    within its gate, and the emitted table (emit) within its own."""
    z, tab = sl.sage_layer_fwd(*args, **kw)
    zp, _ = sl.sage_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = check_close(f"{name}/z", z[m], zp[m], sl.KERNEL_Z_TOL)
    if kw.get("emit"):
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], kw["tile"])
        err = max(err, check_close(f"{name}/table", tab, tabp,
                                   sl.KERNEL_TABLE_TOL))
    return err


def gate_catches_faults(batch, x, weights):
    """The z gate fails a layer whose norm is rsqrt of 7/8 of the sum of
    squares (z = relu(y) scaled by sqrt(8/7) without the skip), and one
    that drops b_l: both from the plain version on the flagship inputs."""
    args, kw, b = layer_inputs(batch, x, weights, True, False, False)
    m = b.node_mask
    zp, _ = sl.sage_layer_plain(*args, **kw)
    scaled = (zp.float() * math.sqrt(8 / 7)).to(zp.dtype)
    check_caught("flagship/norm-7/8", scaled[m], zp[m], sl.KERNEL_Z_TOL)
    args = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
    no_bias, _ = sl.sage_layer_plain(*args, **kw)
    check_caught("flagship/no-bias", no_bias[m], zp[m], sl.KERNEL_Z_TOL)


def train_fwd_vs_plain(name, batch, x, weights, windows, emit):
    """The training variant (skip on, dropout RATE) against the plain one:
    z and the residuals within their gates, and the dropped positions
    exactly those of the hashed keep mask on both sides."""
    args, kw, b = layer_inputs(batch, x, weights, windows, emit, True)
    return train_fwd_checks(name, args, kw, b.node_mask)


def train_fwd_checks(name, args, kw, m):
    """The training variant on prepared inputs (skip on), at dropout RATE:
    see `train_fwd_vs_plain`."""
    x = args[0]
    kw = dict(kw, save_res=True, rate=RATE, seed=SEED)
    z, tab, y, inv, agg = sl.sage_layer_fwd(*args, **kw)
    zp, _, yp, invp, aggp = sl.sage_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for what, got, ref, tol in (("z", z, zp, sl.KERNEL_Z_TOL),
                                ("y", y, yp, sl.KERNEL_Z_TOL),
                                ("agg", agg, aggp, sl.KERNEL_Z_TOL),
                                ("inv", inv, invp, sl.KERNEL_INV_TOL)):
        e = check_close(f"{name}/train/{what}", got[m], ref[m], tol)
        if what != "inv":
            err = max(err, e)
    # dropped entries are zero on both sides; a kept entry the plain
    # version holds above the z gate's atol is nonzero in the kernel (a
    # kept entry near zero may round to zero on one side only)
    dropped = ~keep_mask(SEED, x.shape[0], x.shape[1], RATE, x.device)
    kept_big = ~dropped & (zp.float().abs() > sl.KERNEL_Z_TOL[0])
    same = (bool((z[dropped] == 0).all()) and bool((zp[dropped] == 0).all())
            and bool((z[kept_big] != 0).all()))
    print(json.dumps({"check": f"{name}/train/dropped",
                      "share": float(dropped.float().mean()), "ok": same}))
    if not same:
        fail(f"{name}: the kernel drops other positions than the plain "
             "version")
    if kw.get("emit"):
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], kw["tile"])
        err = max(err, check_close(f"{name}/train/table", tab, tabp,
                                   sl.KERNEL_TABLE_TOL))
    return err


def bwd_inputs(batch, x, weights, windows, apply_prev, skip, rate, seed):
    """Arguments of one backward call: the residuals of the kernel's own
    training forward, a seeded dz of x's scale and (apply_prev) a seeded
    next-layer table of a star sum's scale."""
    args, kw, b = layer_inputs(batch, x, weights, windows, False, skip)
    fkw = dict(kw, save_res=True, rate=rate, seed=SEED if rate else None)
    _, _, y, inv, agg = sl.sage_layer_fwd(*args, **fkw)
    g = torch.Generator(device=x.device).manual_seed(seed)
    dz = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    code, gwin, gw, acc = sl.star_codes(b)
    bkw = dict(tile=kw["tile"], width=kw["width"], code=code, gwin=gwin,
               gw=gw, t0=kw["t0"], acc_code=acc, has_super=True, skip=skip,
               rate=rate, seed=SEED if rate else None)
    if apply_prev:
        bkw["table_prev"] = (torch.randn(kw["table"].shape, generator=g,
                                         device=x.device) * 8).to(x.dtype)
    x_, w_l, _, w_r, band = args
    return (dz, y, inv, agg, x_, w_l, w_r, band), bkw, b


BWD_NAMES = ("dx", "dw_l", "dw_r", "db_l", "town")


def bwd_errors(got, ref, node_mask):
    """{output: (ok, max abs err)} of the backward's gates."""
    out = {}
    for name, g, r in zip(BWD_NAMES, got, ref):
        if name == "dx":
            g, r = g[node_mask], r[node_mask]
        out[name] = within(g, r, sl.gate_tol(r, sl.KERNEL_BWD_TOL[name]))
    return out


def bwd_vs_plain(name, batch, x, weights, windows, apply_prev, skip, rate):
    args, kw, b = bwd_inputs(batch, x, weights, windows, apply_prev, skip,
                             rate, seed=3)
    got = sl.sage_layer_bwd(*args, **kw)
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = bwd_errors(got, ref, b.node_mask)
    ok = all(v[0] for v in errs.values())
    print(json.dumps({"check": f"{name}/bwd", "ok": ok,
                      "max_abs_err": {k: v[1] for k, v in errs.items()},
                      "tol": sl.KERNEL_BWD_TOL}))
    if not ok:
        fail(f"{name}/bwd: kernel disagrees with its plain version {errs}")
    return max(v[1] for v in errs.values())


def bwd_gate_catches_faults(batch, x, weights):
    """The backward gates fail a plain backward whose norm backward drops
    its s term (dout = dy * inv) and one that ignores the next layer's
    star table, each held against the kernel on the flagship inputs."""
    args, kw, b = bwd_inputs(batch, x, weights, True, True, True, RATE,
                             seed=4)
    got = sl.sage_layer_bwd(*args, **kw)
    real = sl._norm_backward
    sl._norm_backward = lambda dz, y, inv: torch.where(y > 0.0, dz, 0.0) * inv
    try:
        no_s = sl.sage_layer_bwd_plain(*args, **kw)
    finally:
        sl._norm_backward = real
    no_prev = sl.sage_layer_bwd_plain(*args, **dict(kw, table_prev=None))
    for fault, wrong in (("no-s-term", no_s), ("no-apply-prev", no_prev)):
        errs = bwd_errors(wrong, got, b.node_mask)
        caught = not all(v[0] for v in errs.values())
        print(json.dumps({"gate": f"flagship/bwd/{fault}", "caught": caught,
                          "max_abs_err": {k: v[1] for k, v in errs.items()}}))
        if not caught:
            fail(f"{fault}: the backward gate lets a wrong backward pass")


def event_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def library_layer(x, w_l, b_l, w_r, band, *, tile, width, table, code, gwin,
                  gw, t0, acc_code, skip, emit, keep=None):
    """The same layer as one PyTorch composition in bf16 (bmm + matmul +
    norm), a yardstick only: the port never calls it. ``keep``: the
    training variant's keep mask, precomputed as a library dropout would
    store it (the composition keeps y and agg as its residuals)."""
    n, h = x.shape
    nt = n // tile
    starts = bm.slab_starts(n, tile, width, x.device)
    xs = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    acc = torch.bmm(band.to(x.dtype), xs)
    rows = sl._window_rows(gwin, gw, t0, nt, x.device)
    sel = (code.reshape(nt, tile, 1)
           == torch.arange(2 * gw, device=x.device)).to(x.dtype)
    agg = (acc + torch.bmm(sel, table[rows])).reshape(n, h)
    out = torch.addmm(b_l, agg, w_l) + x @ w_r
    y = out * torch.rsqrt((out.float() ** 2).sum(-1, keepdim=True)
                          .clamp_min(1e-24)).to(x.dtype)
    z = torch.relu(y) + x if skip else torch.relu(y)
    if keep is not None:
        z = torch.where(keep, z * dropout_scale(RATE), 0.0)
    ftab = None
    if emit:
        sela = (acc_code.reshape(nt, 1, tile)
                == torch.arange(2 * gw, device=x.device)[:, None]).to(x.dtype)
        tb = torch.bmm(sela, z.reshape(nt, tile, h)).float()
        ftab = torch.zeros((2 * t0, h), dtype=torch.float32, device=x.device)
        ftab.index_add_(0, rows.reshape(-1), tb.reshape(-1, h))
    return z, ftab


def library_bwd(dz, y, inv, agg, x, w_l, w_r, band, *, keep, tile, width,
                table_prev, code, gwin, gw, t0, acc_code, has_super, skip,
                rate, seed):
    """The same backward as a PyTorch composition in bf16 (gathers, bmm,
    matmul, index_add), a yardstick only: the port never calls it. The
    keep mask comes in precomputed (``keep``), as a library dropout would
    store it."""
    n, h = x.shape
    nt = n // tile
    rows = sl._window_rows(gwin, gw, t0, nt, x.device)
    sel = (code.reshape(nt, tile, 1)
           == torch.arange(2 * gw, device=x.device)).to(x.dtype)
    dze = dz + torch.bmm(sel, table_prev[rows]).reshape(n, h)
    if rate:
        dze = torch.where(keep, dze * dropout_scale(rate), 0.0)
    yf = y.float()
    dy = torch.where(yf > 0, dze.float(), 0.0)
    dout = ((dy - yf * (dy * yf).sum(-1, keepdim=True))
            * inv[:, None]).to(x.dtype)
    both = dout @ torch.cat([w_l.t(), w_r.t()], 1)
    dagg, dxp = both[:, :h], both[:, h:]
    if skip:
        dxp = dxp + dze
    dw = torch.cat([agg, x], 1).t() @ dout
    db = dout.float().sum(0)
    sela = (acc_code.reshape(nt, 1, tile)
            == torch.arange(2 * gw, device=x.device)[:, None]).to(x.dtype)
    tb = torch.bmm(sela, dagg.reshape(nt, tile, h)).float()
    town = torch.zeros((2 * t0, h), dtype=torch.float32, device=x.device)
    town.index_add_(0, rows.reshape(-1), tb.reshape(-1, h))
    starts = bm.slab_starts(n, tile, width, x.device)
    slab = dagg[starts[:, None] + torch.arange(tile + width,
                                               device=x.device)]
    dx = dxp + torch.bmm(band.to(x.dtype), slab).reshape(n, h)
    return dx, dw[:h], dw[h:], db, town


def layer_bound(args, kw):
    """Least time for one layer call: each input read once and each output
    written once at the HBM rate, against its dense bf16 products at the
    tensor-core peak."""
    x, w_l, b_l, w_r, band = args
    n, h = x.shape
    flops = sl.pass_flops(n, h, kw["tile"], kw["width"], kw.get("gw", 0),
                          has_super=kw.get("table") is not None,
                          emit=kw.get("emit", False))["fwd"]
    ins = [x, w_l, b_l, w_r, band] + [kw.get(k) for k in (
        "table", "code", "gwin", "acc_code")]
    nbytes = sum(t.numel() * t.element_size() for t in ins if t is not None)
    nbytes += x.numel() * x.element_size()  # z
    if kw.get("emit"):
        nbytes += kw["table"].shape[0] * h * 4  # ftab
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def bwd_bound(args, kw):
    """Least time for one backward call: [dagg | dxp] = dout @ [W_l^T |
    W_r^T] and dW = [agg | x]^T @ dout (4 N H^2 each), the band product
    (2 N (T+W) H) and the two star selections (2 N 2GW H each, one without
    apply_prev) at the bf16 tensor-core peak, against each input read once
    and each output written once at the HBM rate."""
    dz, y, inv, agg, x, w_l, w_r, band = args
    n, h = x.shape
    passes = sl.pass_flops(n, h, kw["tile"], kw["width"], kw["gw"],
                           has_super=kw["has_super"],
                           apply_prev=kw.get("table_prev") is not None)
    flops = sum(passes[k] for k in sl.BWD_PASSES)
    ins = [dz, y, inv, agg, x, w_l, w_r, band, kw.get("table_prev"),
           kw["code"], kw["gwin"], kw["acc_code"]]
    nbytes = sum(t.numel() * t.element_size() for t in ins if t is not None)
    nbytes += x.numel() * x.element_size() + (2 * h * h + h) * 4  # dx, dW, db
    nbytes += 2 * kw["t0"] * h * 4  # town
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def step_profile(label, step, step_ms, card, steps=3, rows_out=None):
    """Device time of a few steps by kernel (torch.profiler), and the
    device's busy share of the host-clock step time. Only the device-side
    kernel events count: an operator's own row repeats its kernels' time.
    ``rows_out``, a list, receives every (name, ms per step, calls per
    step) row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if rows_out is not None:
        rows_out.extend((k, ms, c // steps) for k, ms, c in rows)
    return {"profile": f"{label}, device ms per step by kernel",
            "card": card, "device_ms": busy_ms, "step_ms": step_ms,
            "busy_share": busy_ms / step_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": c // steps}
                    for k, ms, c in rows[:14]]}


def step_grads(setup, gen_seed, readout=False):
    """Loss and every parameter's gradient of one train-step forward and
    backward (no optimizer step), dropout seeds from ``gen_seed``. With
    ``readout`` the backward starts from a fixed random linear readout of
    the pooled features (the decoder's input, see READOUT_SEED) instead of
    the loss, and the decoder's parameters have no gradient."""
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import make_loss_and_metrics

    model, batch, cfg = setup["state"].model, setup["batch"], setup["cfg"]
    compute_loss, _ = make_loss_and_metrics(
        get_loss_function(cfg.loss_function), cfg, setup["normalizer"])
    model.zero_grad(set_to_none=True)
    pooled = []
    hook = model.decoder.register_forward_pre_hook(
        lambda mod, args: pooled.append(args[0]))
    try:
        pred, aux = model(batch, deterministic=False,
                          generator=torch.Generator().manual_seed(gen_seed))
    finally:
        hook.remove()
    loss = compute_loss(pred, aux, batch)
    if readout:
        p = pooled[0].float()
        w = torch.randn(p.shape, generator=torch.Generator().manual_seed(
            READOUT_SEED)).to(p.device)
        (p * w)[batch.graph_mask].sum().backward()
    else:
        loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper takes its plain version (the reference path)."""
    real = (sl._launch, sl._launch_bwd, sl._launch_bwd_tile, bm._launch,
            eb._launch_fwd, eb._launch_bwd, cs._launch, ep._launch_fwd,
            ep._launch_bwd)
    (sl._launch, sl._launch_bwd, sl._launch_bwd_tile, bm._launch,
     eb._launch_fwd, eb._launch_bwd, cs._launch, ep._launch_fwd,
     ep._launch_bwd) = (
        sl.sage_layer_plain, sl.sage_layer_bwd_plain,
        sl.sage_layer_bwd_tile_plain, bm.banded_matmul_plain,
        eb.ea_block_fwd_plain, eb.ea_block_bwd_plain,
        cs.csr_segment_sum_plain, ep.epilogue_fwd_plain,
        ep.epilogue_bwd_plain)
    try:
        yield
    finally:
        (sl._launch, sl._launch_bwd, sl._launch_bwd_tile, bm._launch,
         eb._launch_fwd, eb._launch_bwd, cs._launch, ep._launch_fwd,
         ep._launch_bwd) = real


def train_vs_plain(setup, label="flagship", gen_seeds=(11,),
                   pred_tol=PRED_TOL, readout=False):
    """One train step's loss (within ``pred_tol``) and gradients (within
    GRAD_TOL in norm), kernel path against the plain path on the card,
    from the same dropout seeds, for each generator seed in ``gen_seeds``;
    ``readout``: the gradients of `step_grads`' pooled readout. Returns the
    largest relative gradient error."""
    worst = 0.0
    for gen_seed in gen_seeds:
        loss, grads = step_grads(setup, gen_seed, readout)
        with plain_kernels():
            loss_p, grads_p = step_grads(setup, gen_seed, readout)
        name = f"{label}/train/seed{gen_seed}"
        check_close(f"{name}/loss", loss, loss_p, pred_tol)
        rel = {k: float((grads[k].float() - grads_p[k].float()).norm()
                        / grads_p[k].float().norm().clamp_min(1e-30))
               for k in grads_p}
        ok = all(bool(torch.isfinite(g).all()) for g in grads.values()) and \
            grads.keys() == grads_p.keys() and max(rel.values()) <= GRAD_TOL
        print(json.dumps({"check": f"{name}/grads", "ok": ok,
                          "readout": readout, "tol": GRAD_TOL,
                          "rel_err": rel}))
        if not ok:
            fail(f"{name} gradients: kernel path disagrees with the plain "
                 f"path {rel}")
        worst = max(worst, max(rel.values()))
    return worst


# ---- the spill path (virtual-edge cell) ----------------------------------

def spill_inputs(batch, x, weights, skip):
    """(args, kw) of one forward call on a batch with spill edges: the
    spill window of x's rows, and the star operands on a supernode batch
    (its local windows when it has them)."""
    w_l, b_l, w_r = weights
    kw = dict(tile=batch.band_tile, width=batch.band_width, skip=skip,
              spill_offsets=batch.spill_offsets, spill_lo=batch.spill_lo,
              spill_hi=batch.spill_hi,
              spill_messages=x[batch.spill_senders.long()])
    if batch.has_supernode_edges:
        code, gwin, gw, _ = sl.star_codes(batch)
        t0, tg = star_table_geometry(batch.n_graph_cap)
        kw.update(table=sl._super_tables(x, batch.node_graph,
                                         batch.node_mask,
                                         batch.supernode_index,
                                         batch.n_graph_cap, tg),
                  code=code, gwin=gwin, gw=gw, t0=t0)
    return (x, w_l, b_l, w_r, make_agg_context(batch).band), kw


def no_spill(kw):
    return {k: v for k, v in kw.items() if not k.startswith("spill")}


def spill_gates_catch_faults(name, batch, x, weights):
    """The forward gates fail a plain forward without its spill term, held
    against the kernel: z (serving) and agg (training)."""
    args, kw = spill_inputs(batch, x, weights, True)
    m = batch.node_mask
    z, _ = sl.sage_layer_fwd(*args, **kw)
    zp, _ = sl.sage_layer_plain(*args, **no_spill(kw))
    check_caught(f"{name}/fwd/no-spill", zp[m], z[m], sl.KERNEL_Z_TOL)
    tkw = dict(kw, save_res=True, rate=RATE, seed=SEED)
    agg = sl.sage_layer_fwd(*args, **tkw)[4]
    aggp = sl.sage_layer_plain(*args, **no_spill(tkw))[4]
    check_caught(f"{name}/train/agg/no-spill", aggp[m], agg[m],
                 sl.KERNEL_Z_TOL)


def tile_inputs(batch, x, weights, skip, rate, seed):
    """Arguments of one split tile call: the residuals of the kernel's own
    spill forward, a seeded dz of x's scale and, on a supernode batch, the
    global accumulate codes."""
    args, kw = spill_inputs(batch, x, weights, skip)
    _, _, y, inv, agg = sl.sage_layer_fwd(
        *args, **dict(kw, save_res=True, rate=rate,
                      seed=SEED if rate else None))
    g = torch.Generator(device=x.device).manual_seed(seed)
    dz = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    _, tg = star_table_geometry(batch.n_graph_cap)
    x_, w_l, _, w_r, _ = args
    tkw = dict(tile=batch.band_tile, skip=skip, rate=rate,
               seed=SEED if rate else None, tg=tg,
               acc_code=batch.gacc if batch.has_supernode_edges else None)
    return (dz, y, inv, agg, x_, w_l, w_r), tkw


TILE_NAMES = ("dagg", "dxp", "dw_l", "dw_r", "db_l", "tbwd")


def tile_vs_plain(name, batch, x, weights, skip, rate):
    args, kw = tile_inputs(batch, x, weights, skip, rate, seed=7)
    got = sl.sage_layer_bwd_tile(*args, **kw)
    ref = sl.sage_layer_bwd_tile_plain(*args, **kw)
    torch.cuda.synchronize()
    m = batch.node_mask
    errs = {}
    for what, g, r in zip(TILE_NAMES, got, ref):
        if r is None:
            continue
        if what in ("dagg", "dxp"):
            g, r = g[m], r[m]
        errs[what] = within(g, r, sl.gate_tol(r, sl.KERNEL_BWD_TOL[what]))
    ok = all(v[0] for v in errs.values())
    print(json.dumps({"check": f"{name}/bwd_tile", "ok": ok,
                      "max_abs_err": {k: v[1] for k, v in errs.items()}}))
    if not ok:
        fail(f"{name}/bwd_tile: kernel disagrees with its plain version "
             f"{errs}")
    return max(v[1] for v in errs.values())


def banded_inputs(batch, x, seed, spill, table, acc):
    """(args, kw) of one banded call as the split backward makes it: x
    stands for dagg, ``acc`` for dxp (seeded, x's scale) and the table for
    the own star table (seeded bf16, tg rows, at the batch's global
    codes)."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    kw = dict(tile=batch.band_tile, width=batch.band_width,
              out_dtype=torch.bfloat16)
    if spill:
        kw.update(spill_offsets=batch.spill_offsets, spill_lo=batch.spill_lo,
                  spill_hi=batch.spill_hi,
                  spill_messages=x[batch.spill_senders.long()])
    if table:
        _, tg = star_table_geometry(batch.n_graph_cap)
        kw.update(gcode=batch.gcode, table=torch.randn(
            (tg, x.shape[1]), generator=g, device=x.device).to(x.dtype))
    if acc:
        kw["acc"] = torch.randn(x.shape, generator=g,
                                device=x.device).to(x.dtype)
    return (make_agg_context(batch).band, x), kw


def banded_vs_plain(name, args, kw):
    got = bm.banded_matmul(*args, **kw)
    ref = bm.banded_matmul_plain(*args, **kw)
    torch.cuda.synchronize()
    return check_close(f"{name}/banded", got, ref,
                       sl.gate_tol(ref, bm.KERNEL_BANDED_TOL))


def banded_gate_catches_faults(name, args, kw):
    """The banded gate fails a plain product that drops the spill
    messages, held against the kernel."""
    got = bm.banded_matmul(*args, **kw)
    wrong = bm.banded_matmul_plain(*args, **no_spill(kw))
    check_caught(f"{name}/banded/no-spill", wrong, got,
                 sl.gate_tol(got, bm.KERNEL_BANDED_TOL))


def split_kernels_deterministic(batch, x, weights):
    """No float atomics: two calls of each split kernel give the same
    bits."""
    args, kw = tile_inputs(batch, x, weights, True, RATE, seed=21)
    first = sl.sage_layer_bwd_tile(*args, **kw)
    second = sl.sage_layer_bwd_tile(*args, **kw)
    bargs, bkw = banded_inputs(batch, first[0], 22, True, False, True)
    out1 = bm.banded_matmul(*bargs, **bkw)
    out2 = bm.banded_matmul(*bargs, **bkw)
    torch.cuda.synchronize()
    same = all(a is None and c is None or torch.equal(a, c)
               for a, c in zip(first + (out1,), second + (out2,)))
    print(json.dumps({"check": "virtual/split-kernels/deterministic",
                      "ok": same}))
    if not same:
        fail("two calls of a split kernel gave different bits")


def library_spill_layer(x, w_l, b_l, w_r, band, *, recv, tile, width, skip,
                        spill_offsets, spill_lo, spill_hi, spill_messages):
    """The virtual-edge layer as one PyTorch composition in bf16 (bmm,
    index_add_ of the spill messages at their receivers, matmul, norm), a
    yardstick only: the port never calls it."""
    n, h = x.shape
    starts = bm.slab_starts(n, tile, width, x.device)
    xs = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    agg = torch.bmm(band.to(x.dtype), xs).reshape(n, h)
    agg.index_add_(0, recv, spill_messages)
    out = torch.addmm(b_l, agg, w_l) + x @ w_r
    y = out * torch.rsqrt((out.float() ** 2).sum(-1, keepdim=True)
                          .clamp_min(1e-24)).to(x.dtype)
    return torch.relu(y) + x if skip else torch.relu(y)


def library_bwd_tile(dz, y, inv, agg, x, w_l, w_r, *, keep, tile, skip, rate,
                     seed, acc_code, tg):
    """The split tile kernel's function as a PyTorch composition in bf16
    (the keep mask precomputed), a yardstick only."""
    h = x.shape[1]
    dze = torch.where(keep, dz * dropout_scale(rate), 0.0) if rate else dz
    yf = y.float()
    dy = torch.where(yf > 0, dze.float(), 0.0)
    dout = ((dy - yf * (dy * yf).sum(-1, keepdim=True))
            * inv[:, None]).to(x.dtype)
    both = dout @ torch.cat([w_l.t(), w_r.t()], 1)
    dagg, dxp = both[:, :h], both[:, h:]
    if skip:
        dxp = dxp + dze
    dw = torch.cat([agg, x], 1).t() @ dout
    return dagg, dxp, dw[:h], dw[h:], dout.float().sum(0)


def library_banded(band, x, *, recv, tile, width, out_dtype, spill_offsets,
                   spill_lo, spill_hi, spill_messages, acc):
    """The main path's banded call as a PyTorch composition in bf16 (bmm,
    index_add_ of the spill messages, add), a yardstick only."""
    n, h = x.shape
    starts = bm.slab_starts(n, tile, width, x.device)
    slab = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    out = torch.bmm(band.to(x.dtype), slab).reshape(n, h)
    out.index_add_(0, recv, spill_messages)
    return out + acc


def nbytes_of(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bf16_flops, f32_flops, nbytes, tf32_flops=0):
    """(bound ms, what bounds it): bf16 products at the tensor-core peak
    plus f32 adds at the f32 peak plus tf32 products at the TF32 peak,
    against the bytes at the HBM rate."""
    t_ops = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
             + tf32_flops / PEAK_TF32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def spill_layer_bound(args, kw):
    """Least time for one virtual-edge layer call: `layer_bound`'s products
    and bytes plus the spill term's useful work, Es * H f32 adds, and its
    bytes (the messages, offsets and lo/hi, each read once); not the TPU's
    dense one-hot product."""
    _, _, flops, nbytes = layer_bound(args, kw)
    msgs = kw["spill_messages"]
    return bound(flops, msgs.numel(), nbytes + nbytes_of(
        msgs, kw["spill_offsets"], kw["spill_lo"], kw["spill_hi"]))


def tile_bound(args, kw):
    """Least time for one split tile call: [dagg | dxp] = dout @ [W_l^T |
    W_r^T] and dW = [agg | x]^T @ dout (4 N H^2 each) at the bf16 peak (and
    the own table's 2 N tg H on a supernode batch), against dz, y, inv,
    agg, x and the weights read once and dagg, dxp, dW and db written
    once."""
    dz, y, inv, agg, x, w_l, w_r = args
    n, h = x.shape
    passes = sl.pass_flops(n, h, kw["tile"], 0, 0, tg=kw["tg"],
                           has_super=kw["acc_code"] is not None)
    flops = sum(passes[k] for k in sl.TILE_PASSES)
    nbytes = nbytes_of(dz, y, inv, agg, x, w_l, w_r, kw["acc_code"])
    nbytes += 2 * x.numel() * x.element_size() + (2 * h * h + h) * 4
    if kw["acc_code"] is not None:
        nbytes += kw["tg"] * h * 4
    return bound(flops, 0, nbytes)


def banded_bound(args, kw):
    """Least time for one banded call: the band product (2 N (T+W) H, the
    band as the dense int8 operand the kernel multiplies) at the bf16 peak
    and the spill, table and acc adds (Es H, N H, N H) at the f32 peak,
    against each operand read once and the output written once."""
    band, x = args
    n, h = x.shape
    flops = 2 * n * (kw["tile"] + kw["width"]) * h
    adds = 0
    if kw.get("spill_messages") is not None:
        adds += kw["spill_messages"].numel()
    adds += n * h * ((kw.get("table") is not None) + (kw.get("acc")
                                                        is not None))
    nbytes = nbytes_of(band, x, *(kw.get(k) for k in (
        "spill_messages", "spill_offsets", "spill_lo", "spill_hi", "gcode",
        "table", "acc")))
    nbytes += n * h * torch.empty((), dtype=kw["out_dtype"]).element_size()
    return bound(flops, adds, nbytes)


def scrambled_spill_batch(dev):
    """A supernode batch with spill edges: 3 panels with their node order
    scrambled inside each graph (tests/test_fused_layer.py:213-236), tile
    128, width 64."""
    import dataclasses as dc

    from buckgnn_tpu_torch.graph.batch import pack_graphs

    rng = np.random.default_rng(1)
    ds = []
    for g in generate_dataset(3, seed=9, min_side=8, max_side=11,
                              use_super_node=True, use_virtual_edges=False):
        perm = rng.permutation(g.n_node)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(g.n_node)
        ds.append(dc.replace(
            g, x=g.x[perm], senders=inv[g.senders].astype(np.int32),
            receivers=inv[g.receivers].astype(np.int32),
            supernode=int(inv[g.supernode])))
    tile, width = 128, 64
    n = sum(g.n_node for g in ds) + 1
    ncap = ((max(n, tile + width) + tile - 1) // tile) * tile
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = pack_graphs(ds, ncap, ecap, 4, band_width=width, band_tile=tile,
                    device=dev)
    if not (b.has_spill_edges and b.has_supernode_edges):
        fail("the scrambled batch must have supernodes and spill edges")
    return b


def seeded_x(batch, h, seed, dtype=torch.bfloat16):
    """Activations [N, H] in ``dtype`` from a seeded generator, the dead row
    0."""
    g = torch.Generator(device=batch.device).manual_seed(seed)
    x = torch.randn((batch.n_node_cap, h), generator=g, device=batch.device)
    x[-1] = 0.0
    return x.to(dtype)


def reset_launch_counts():
    for mod in (sl, eb, cs, ep):
        mod.reset_launch_counts()


def launch_counts():
    """Every kernel wrapper's launch count."""
    return {**sl.LAUNCHES, **eb.LAUNCHES, **cs.LAUNCHES, **ep.LAUNCHES}


def expect_launches(label, got, want):
    """Every kernel's count from a path's run, against what it should
    launch; each kernel not named must not launch at all."""
    want = {k: want.get(k, 0) for k in launch_counts()}
    print(json.dumps({"path": label, "launches": got, "expected": want}))
    if got != want:
        fail(f"{label} launched {got}, expected {want}")


def serve_path(label, setup, timer=None, kernel="sage_layer_fwd",
               pred_tol=PRED_TOL, n_steps=10):
    """A main path: eval_step on the setup's batch with the launch counts
    set to 0 just before and read just after (a few requests, the serve
    bench of ``n_steps`` and, given, ``timer(counted_eval_step)``): one
    launch of ``kernel`` per layer and forward (None: no kernel) and no
    other; finite answers, and the whole forward against the plain path on
    the card."""
    batch, eval_step = setup["batch"], setup["eval_step"]
    layers = setup["model"].num_layers
    forwards = [0]

    def counted(b):
        forwards[0] += 1
        return eval_step(b)

    reset_launch_counts()
    answers = [counted(batch) for _ in range(3)]
    serve = run_serve_bench(dict(setup, eval_step=counted), n_warmup=2,
                            n_steps=n_steps)
    extra = timer(counted) if timer else None
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(f"{label}/serve ({forwards[0]} forwards)", launches,
                    {kernel: layers * forwards[0]} if kernel else {})
    g = batch.graph_mask
    for m, (pred, _) in answers:
        if pred.shape != (batch.n_graph_cap,) or not bool(
                torch.isfinite(pred[g].float()).all()):
            fail(f"{label}: non-finite or misshapen prediction")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"{label}: non-finite loss/metrics {m}")
    with plain_kernels():
        mp, (pred_p, _) = eval_step(batch)
    m, (pred, _) = answers[-1]
    print(json.dumps({"path": f"{label}/serve", "pred_abs_mean": float(
        pred[g].float().abs().mean()), "pred_abs_max": float(
        pred[g].float().abs().max())}))
    check_close(f"{label}/forward/pred", pred[g], pred_p[g], pred_tol)
    check_close(f"{label}/forward/loss", m["loss"], mp["loss"], pred_tol)
    check_close(f"{label}/forward/mape", m["mape"], mp["mape"], pred_tol)
    return serve, launches, extra


def train_path(label, train, kernels, n_steps=10):
    """A main path: a few checked train steps and the train bench of
    ``n_steps`` with the launch counts set to 0 just before and read just
    after: per step and layer ``kernels[name]`` launches of each kernel
    named, and no other kernel. Losses and parameters finite, every
    parameter changed."""
    model, batch = train["state"].model, train["batch"]
    step, steps = train["train_step"], [0]

    def counted_step(b, lr, gen):
        steps[0] += 1
        return step(b, lr, gen)

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    reset_launch_counts()
    checked = [counted_step(batch, train["lr"], train["generator"])
               for _ in range(3)]
    bench = run_train_bench(dict(train, train_step=counted_step),
                            n_warmup=2, n_steps=n_steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    each = model.num_layers * steps[0]
    expect_launches(f"{label}/train ({steps[0]} steps)", launches,
                    {k: each * m for k, m in kernels.items()})
    losses = [float(mt["loss"]) for mt in checked]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite training loss {losses}")
    for k, p in model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            fail(f"{label}: non-finite parameter {k} after training")
        if torch.equal(p.detach(), before[k]):
            fail(f"{label}: parameter {k} did not change in training")
    return bench, losses, launches


# ---- the EA family (ea-virtual cell) ---------------------------------------

EA_SHAPES = dict(wer=(1, 1), wee=(1, 1), wsp=(1, 2), we1=(1, 1), wpe=(1, 1),
                 wp1=(1, 1), wg0=(2, 1), wg1=(1, 1), wb0=(1, 1), wb1=(1, 1))


def ea_case(batch, h, enc, seed, dtype=torch.bfloat16):
    """(x, e_win, w, bias) of one fused-block call on ``batch``, from a
    seeded generator: lecun-normal weights ([in, out]) in ``dtype``, an f32 bias
    stack of 0.3 rms (so a dropped cnt * b_p1 term fails the gate), x of
    unit rms with the dead row 0, and the window: the raw features padded
    to 8 in encoder mode, else unit-rms values."""
    dev = batch.device
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {k: (a * h, b * h) for k, (a, b) in EA_SHAPES.items()}
    if enc:
        shapes.update(wen0=(eb.ENC_IN, eb.ENC_HID),
                      wen1=(eb.ENC_HID, eb.ENC_HID), wen2=(eb.ENC_HID, h))
    w = {k: (torch.randn(s, generator=g, device=dev) / math.sqrt(s[0]))
         .to(dtype).contiguous() for k, s in shapes.items()}
    bias = torch.randn((11 if enc else 8, h), generator=g, device=dev) * 0.3
    x = torch.randn((batch.n_node_cap, h), generator=g, device=dev)
    x[-1] = 0.0
    t, wc = batch.win_sidx.shape
    if enc:
        fe = batch.win_edges.shape[2]
        e = torch.nn.functional.pad(batch.win_edges, (0, eb.ENC_IN - fe))
    else:
        e = torch.randn((t, wc, h), generator=g, device=dev)
    return x.to(dtype), e.to(dtype).contiguous(), w, bias


def ea_valid(ctx):
    return ctx.recv >= 0


def ea_fwd_vs_plain(name, batch, ctx, h, enc, skip, rate, seed,
                    dtype=torch.bfloat16, worst=None):
    """#5 (or, in ``dtype`` and at ``h``, the variant `kernel_variant`
    picks) against its plain version on one case: zx, and ze, e1s and m1s
    on valid slots, within eb.variant_fwd_tol (bf16: KERNEL_FWD_TOL); at
    ``rate`` the dropped positions of both masks exactly the hashed ones.
    In float32 the largest error as a share of max|plain| goes into
    ``worst`` (a dict). Returns (max error, the case, the kernel's
    outputs)."""
    x, e, w, bias = ea_case(batch, h, enc, seed, dtype)
    kw = dict(skip=skip, rate=rate, seed=SEED if rate else None, enc=enc,
              save_res=True)
    got = eb.ea_block_fwd(x, e, w, bias, ctx, **kw)
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, **kw)
    torch.cuda.synchronize()
    v = ea_valid(ctx)
    err = 0.0
    for what, a, r in zip(("zx", "ze", "e1s", "m1s"), got, ref):
        if what != "zx":
            a, r = a.reshape(-1, h)[v], r.reshape(-1, h)[v]
        e_ = check_close(f"{name}/{what}", a, r, eb.variant_fwd_tol(r, dtype))
        err = max(err, e_)
        if dtype == torch.float32 and worst is not None:
            worst["f32_fwd_err_over_max"] = max(
                worst.get("f32_fwd_err_over_max", 0.0),
                e_ / max(float(r.float().abs().max()), 1e-30))
    if rate:
        n_e = ctx.n_slots
        drop_e = ~keep_mask(SEED, n_e, h, rate, x.device)[v]
        drop_x = ~keep_mask(SEED, x.shape[0], h, rate, x.device, row0=n_e)
        zx, zxp = got[0], ref[0]
        ze, zep = got[1].reshape(-1, h)[v], ref[1].reshape(-1, h)[v]
        atol = eb.variant_fwd_tol(zxp, dtype)[0]
        same = True
        for a, r, d in ((zx, zxp, drop_x), (ze, zep, drop_e)):
            big = ~d & (r.float().abs() > atol)
            same &= (bool((a[d] == 0).all()) and bool((r[d] == 0).all())
                     and bool((a[big] != 0).all()))
        print(json.dumps({"check": f"{name}/dropped", "ok": same,
                          "share_x": float(drop_x.float().mean()),
                          "share_e": float(drop_e.float().mean())}))
        if not same:
            fail(f"{name}: the kernel drops other positions than the plain "
                 "version")
    return err, (x, e, w, bias, kw), got


def ea_bwd_vs_plain(name, ctx, case, res, seed):
    """#6 against its plain version on one case, from the kernel's own
    residuals and a seeded cotangent: dx, de_win (valid slots), every dW
    and dbias within KERNEL_BWD_TOL (relative norms)."""
    x, e, w, bias, kw = case
    kw = {k: v for k, v in kw.items() if k != "save_res"}
    h = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(seed)
    dzx = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    dze = torch.randn(res[1].shape, generator=g,
                      device=x.device).to(x.dtype)
    args = (dzx, dze, res[2], res[3], x, e, w, bias, ctx)
    got = eb.ea_block_bwd(*args, **kw)
    ref = eb.ea_block_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    return ea_bwd_errors(name, got, ref, ctx, h)


def ea_bwd_errors(name, got, ref, ctx, h):
    """A backward against a reference: prints each output's reading
    (ops/ea_block.py::bwd_errors) with the largest absolute errors, fails
    the run if a gate fails, and returns the largest absolute error."""
    errs = eb.bwd_errors(got, ref, ctx)
    tol = {k: eb.bwd_tol(k) for k in errs}
    ok = all(errs[k] <= tol[k] for k in errs)
    v = ea_valid(ctx)
    pairs = {"dx": (got[0], ref[0]), "dbias": (got[3], ref[3])}
    if ref[1] is not None:
        pairs["de_win"] = (got[1].reshape(-1, h)[v], ref[1].reshape(-1, h)[v])
    pairs.update({f"d{k}": (got[2][k], ref[2][k]) for k in ref[2]})
    max_abs = {k: float((a.float() - r.float()).abs().max())
               for k, (a, r) in pairs.items()}
    print(json.dumps({"check": f"{name}/bwd", "ok": ok, "rel_err": errs,
                      "tol": tol, "max_abs_err": max_abs}))
    if not ok:
        fail(f"{name}/bwd: kernel disagrees with its plain version {errs}")
    return max(max_abs.values())


EA_CASES = [  # (encoder mode, skip, dropout rate)
    (False, True, 0.0), (False, False, RATE), (False, True, RATE),
    (True, False, 0.0), (True, False, RATE)]


def ea_kernel_checks(label, batch, ctx, seed, cases=EA_CASES, h=512,
                     dtype=torch.bfloat16, worst=None):
    """#5 and #6 (in ``dtype`` at ``h``: the variants `kernel_variant`
    picks) against their plain versions on every case (encoder mode at H >
    128 only); returns their largest errors."""
    fwd, bwd = [], []
    for i, (enc, skip, rate) in enumerate(cases):
        if enc and h <= eb.ENC_HID:
            continue
        name = (f"{label}/{'encoder' if enc else 'plain'}/skip{int(skip)}"
                f"/rate{rate}")
        err, case, got = ea_fwd_vs_plain(name, batch, ctx, h, enc, skip,
                                         rate, seed + i, dtype, worst)
        fwd.append(err)
        bwd.append(ea_bwd_vs_plain(name, ctx, case, got, seed + 100 + i))
    return max(fwd), max(bwd)


def ea_gates_catch_faults(label, batch, ctx, dtype=torch.bfloat16, h=512):
    """The gates (at ``dtype``'s tolerance) fail these faults, each made by
    the plain version and held against the kernel: a forward that drops
    the far senders, a mean without cnt * b_p1, a forward without the skip
    (zx or ze fails); a backward without the slab-overlap (halo) part of
    dx, without its far part, without one node's sender run, without one
    far rank of one tile or without the first (clamped) tile's halo (dx's
    norm or row gate fails; ops/ea_block.py::sender_faults), and a dW_sp
    without the far slots (the dW gate fails)."""
    x, e, w, bias = ea_case(batch, h, False, 71, dtype)
    kw = dict(skip=True, rate=RATE, seed=SEED)
    zx, ze, e1s, m1s = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True,
                                       **kw)
    v = ea_valid(ctx)
    no_far = eb.sender_faults(batch, ctx)["no-far-fold"]
    no_cnt_b = bias.clone()
    no_cnt_b[3] = 0.0
    for fault, args, fkw in (
            ("no-far-senders", (x, e, w, bias, no_far), kw),
            ("no-cnt-b_p1", (x, e, w, no_cnt_b, ctx), kw),
            ("no-skip", (x, e, w, bias, ctx), dict(kw, skip=False))):
        fzx, fze = eb.ea_block_fwd_plain(*args, **fkw)
        ok_x = within(fzx, zx, eb.variant_fwd_tol(zx, dtype))
        ok_e = within(fze.reshape(-1, h)[v], ze.reshape(-1, h)[v],
                      eb.variant_fwd_tol(ze, dtype))
        caught = not (ok_x[0] and ok_e[0])
        print(json.dumps({"gate": f"{label}/fwd/{fault}", "caught": caught,
                          "max_abs_err": {"zx": ok_x[1], "ze": ok_e[1]}}))
        if not caught:
            fail(f"{fault}: the EA forward gate lets a wrong forward pass")
    g = torch.Generator(device=x.device).manual_seed(72)
    dzx = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    dze = torch.randn(ze.shape, generator=g, device=x.device).to(x.dtype)
    args = (dzx, dze, e1s, m1s, x, e, w, bias)
    got = eb.ea_block_bwd(*args, ctx, **kw)
    for fault, bad in eb.sender_faults(batch, ctx).items():
        errs = eb.bwd_errors(got, eb.ea_block_bwd_plain(*args, bad, **kw),
                             ctx)
        caught = (errs["dx"] > eb.bwd_tol("dx")
                  or errs["dx_row"] > eb.bwd_tol("dx_row"))
        print(json.dumps({"gate": f"{label}/bwd/{fault}", "caught": caught,
                          "rel_err_dx": errs["dx"],
                          "row_err_dx": errs["dx_row"],
                          "rel_err_dwsp": errs["dwsp"]}))
        if not caught:
            fail(f"{fault}: the EA backward gate lets a wrong backward pass")
        # dW_sp without the far slots fails the weight gradients' gate
        if fault == "no-far-fold" and errs["dwsp"] <= eb.bwd_tol("dwsp"):
            fail("no-far-fold: the dW gate lets a wrong dW_sp pass")


def ea_deterministic(label, batch, ctx,
                     cases=((torch.bfloat16, 512, True, False),)):
    """No float atomics: two calls of each EA kernel give the same bits,
    for each (dtype, H, encoder mode, skip) of ``cases`` at dropout 0.1."""
    for dtype, h, enc, skip in cases:
        outs = []
        for _ in range(2):
            x, e, w, bias = ea_case(batch, h, enc, 81, dtype)
            kw = dict(skip=skip, rate=RATE, seed=SEED, enc=enc)
            fwd = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True, **kw)
            g = torch.Generator(device=x.device).manual_seed(82)
            dzx = torch.randn(x.shape, generator=g,
                              device=x.device).to(x.dtype)
            dze = torch.randn(fwd[1].shape, generator=g,
                              device=x.device).to(x.dtype)
            dx, de, dw, dbias = eb.ea_block_bwd(dzx, dze, fwd[2], fwd[3], x,
                                                e, w, bias, ctx, **kw)
            outs.append(list(fwd) + [dx, dbias] + ([] if de is None else
                                                   [de])
                        + [dw[k] for k in sorted(dw)])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        print(json.dumps({"check": f"{label}/{dtname(dtype)}/h{h}/"
                          "ea-kernels/deterministic", "ok": same}))
        if not same:
            fail("two calls of an EA kernel gave different bits")


def ea_ragged_batch(dev, n_graphs=16, min_win_cap=0, tile=128, align=256):
    """A small ragged EA batch: ``n_graphs`` virtual-edge panels of 8-11
    nodes a side (tests/test_fused_ea_block.py:17-51), width 64, packed by
    batch_iterator at ``tile`` with N a multiple of ``align`` and W at
    least ``min_win_cap``: >= 4 tiles, far senders, the first and last
    tiles' slabs clamped, W not a multiple of 64. 16 panels give 12 tiles
    of W = 528 (E = 99 blocks of 64 slots); 12 panels with W = 552 give 10
    tiles and E % 64 = 16, so the kernels' last 64-slot block is partial;
    5 panels at tile 64, align 64 give N = 448 (N / 64 odd: the engine's
    last cluster of two 64-row blocks has an empty block) and E % 64 =
    48."""
    from buckgnn_tpu_torch.graph.batch import batch_iterator

    ds = generate_dataset(n_graphs, seed=2, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    width = 64
    n = sum(g.n_node for g in ds) + 1
    ncap = ((max(n, tile + width) + align - 1) // align) * align
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    (b,) = batch_iterator(ds, n_graphs, ncap, ecap, band_width=width,
                          band_tile=tile, min_win_cap=min_win_cap,
                          device=dev)
    far = int((b.win_far_tsend != ncap - 1).sum())
    if ncap // tile < 4 or not far or b.win_sidx.shape[1] % 64 == 0:
        fail("the ragged EA batch must have >= 4 tiles, far senders and W "
             "not a multiple of 64")
    return b


def library_ea_fwd(x, e, w, bias, ctx, *, skip):
    """The fused block forward as one PyTorch composition in bf16 (row
    gathers, matmuls, index_add_ of m1 by receiver), a yardstick only: the
    port never calls it."""
    n, h = x.shape
    b = bias.to(x.dtype)
    v = ctx.recv >= 0
    s = ctx.send.long().clamp_min(0)
    r = ctx.recv.long().clamp_min(0)
    p = x @ torch.cat([w["wsp"], w["wer"]], 1)
    ps, pr = p[s, :2 * h], p[r, 2 * h:]
    ein = e.reshape(-1, h)
    e1 = torch.relu(ein @ w["wee"] + pr + ps[:, :h] + b[0])
    e2 = e1 @ w["we1"] + b[1]
    m1 = torch.relu(e2 @ w["wpe"] + ps[:, h:] + b[2])
    sm = torch.zeros_like(x).index_add_(0, r[v], m1[v])
    cnt = ctx.cnt[:, None]
    agg = ((sm @ w["wp1"]).float() + cnt * bias[3]) / cnt.clamp_min(1.0)
    g1 = torch.relu(torch.cat([x, agg.to(x.dtype)], 1) @ w["wg0"] + b[4])
    x1 = g1 @ w["wg1"] + b[5]
    x2 = x1 + torch.relu(x1 @ w["wb0"] + b[6]) @ w["wb1"] + b[7]
    return (x2 + x, e2 + ein) if skip else (x2, e2)


def library_ea_bwd(dzx, dze, e1s, m1s, x, e, w, bias, ctx, *, skip):
    """The fused block backward as a PyTorch composition in bf16 (the
    recomputed node side, row gathers, matmuls, index_add_ of the receiver
    and sender folds), a yardstick only: the port never calls it."""
    n, h = x.shape
    b = bias.to(x.dtype)
    v = ctx.recv >= 0
    vs = ctx.send >= 0
    r, s = ctx.recv.long(), ctx.send.long()
    e1, m1 = e1s.reshape(-1, h), m1s.reshape(-1, h)
    ein = e.reshape(-1, h)
    cnt = ctx.cnt[:, None]
    deg = cnt.clamp_min(1.0).to(x.dtype)
    sm = torch.zeros_like(x).index_add_(0, r[v], m1[v])
    agg = (sm @ w["wp1"] + cnt.to(x.dtype) * b[3]) / deg
    g1 = torch.relu(torch.cat([x, agg], 1) @ w["wg0"] + b[4])
    x1 = g1 @ w["wg1"] + b[5]
    b1 = torch.relu(x1 @ w["wb0"] + b[6])
    dzb = torch.where(b1 > 0, dzx @ w["wb1"].t(), 0.0)
    dx1 = dzx + dzb @ w["wb0"].t()
    dzg = torch.where(g1 > 0, dx1 @ w["wg1"].t(), 0.0)
    dxa = dzg @ w["wg0"].t()
    dagg = dxa[:, h:] / deg
    dsm = dagg @ w["wp1"].t()
    e2 = e1 @ w["we1"] + b[1]
    dzm = torch.where((m1 > 0) & v[:, None], dsm[r.clamp_min(0)], 0.0)
    de2 = dze.reshape(-1, h) + dzm @ w["wpe"].t()
    de1 = torch.where(e1 > 0, de2 @ w["we1"].t(), 0.0)
    deo = de1 @ w["wee"].t()
    if skip:
        deo = deo + dze.reshape(-1, h)
    r_de1 = torch.zeros_like(x).index_add_(0, r[v], de1[v])
    both = torch.cat([de1, dzm], 1)
    s_node = torch.zeros((n, 2 * h), dtype=x.dtype,
                         device=x.device).index_add_(0, s[vs], both[vs])
    dx = dxa[:, :h] + r_de1 @ w["wer"].t() + s_node @ w["wsp"].t()
    if skip:
        dx = dx + dzx
    dw = dict(wb1=b1.t() @ dzx, wb0=x1.t() @ dzb, wg1=g1.t() @ dx1,
              wg0=torch.cat([x, agg], 1).t() @ dzg, wp1=sm.t() @ dagg,
              wpe=e2.t() @ dzm, we1=e1.t() @ de2, wee=ein.t() @ de1,
              wer=x.t() @ r_de1, wsp=x.t() @ s_node)
    db = torch.stack([de1.sum(0), de2.sum(0), dzm.sum(0),
                      (cnt.to(x.dtype) * dagg).sum(0), dzg.sum(0),
                      dx1.sum(0), dzb.sum(0), dzx.sum(0)])
    return dx, deo, dw, db


def ea_bounds(x, e, w, ctx, *, enc, train):
    """(fwd bound ms, what bounds it, bwd bound ms, what bounds it, fwd
    operations, bwd operations) of one block call at these inputs: the
    products of the kernels' passes over valid slots
    (ops/ea_block.py::pass_flops; not the TPU's one-hot selection
    products) at the peak of x's dtype (bf16 tensor cores, or for the
    float32 variants 3 tf32 products each at the TF32 peak, `tf32_passes`),
    against each input read once and
    each output written once (valid slots only) at the HBM rate. ``train``
    adds the residuals e1 and m1 to the forward's writes."""
    n, h = x.shape
    ev = int((ctx.recv >= 0).sum())
    flops = eb.pass_flops(n, ev, h, enc=enc)
    f_fwd = sum(flops[k] for k in eb.FWD_PASSES)
    f_bwd = sum(flops[k] for k in eb.BWD_PASSES)
    e_w = e.element_size() * e.shape[-1]
    wbytes = sum(t.numel() * t.element_size() for t in w.values())
    ctx_bytes = nbytes_of(ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.cnt)
    nh2, eh2 = n * h * x.element_size(), ev * h * x.element_size()
    fwd_bytes = (nh2 + ev * e_w + wbytes + ctx_bytes + nh2 + eh2
                 + (2 * eh2 if train else 0))
    bwd_bytes = (nh2 + eh2 + 2 * eh2 + nh2 + ev * e_w + wbytes + ctx_bytes
                 + nbytes_of(ctx.sorder, ctx.soff) + nh2
                 + (0 if enc else eh2) + 2 * wbytes + 11 * h * 4)
    f32 = x.dtype == torch.float32
    tf = tf32_passes(x.dtype)
    fb = (bound(0, 0, fwd_bytes, tf32_flops=tf * f_fwd) if f32
          else bound(f_fwd, 0, fwd_bytes))
    bb = (bound(0, 0, bwd_bytes, tf32_flops=tf * f_bwd) if f32
          else bound(f_bwd, 0, bwd_bytes))
    return fb[0], fb[1], bb[0], bb[1], f_fwd, f_bwd


# the kernel names of each pass in a profile (the weight pass with its
# reductions)
EA_PASS_KERNELS = {
    "fwd_proj": ("fwd_proj_kernel",), "fwd_edge": ("fwd_edge_kernel",),
    "fwd_node": ("fwd_node_kernel",), "bwd_node1": ("bwd_node1_kernel",),
    "bwd_edge": ("bwd_edge_kernel",), "bwd_node2": ("bwd_node2_kernel",),
    "bwd_weights": ("atb_kernel", "atb_reduce_kernel", "bias_reduce_kernel")}


def pass_lines(kind, rows, kernels, flops, card, calls=None, tiles=None,
               **tags):
    """One line per pass from a train step's profile rows (name, device ms
    per step, calls per step): device ms per step and per call (``calls``
    a step, else the pass's launches), the launches per step of the
    pass's first kernel, its operations per step (``flops`` by pass; none
    for a reduction) and its achieved TFLOP/s; with ``tiles`` ({kernel
    name: operations by pass}) also each product tile's own device ms in
    the pass and its TFLOP/s on its products there."""
    for name, pats in kernels.items():
        hits = [r for r in rows if any(p in r[0] for p in pats)]
        ms = sum(r[1] for r in hits)
        launches = sum(r[2] for r in hits if pats[0] in r[0])
        per = calls or launches
        f = flops.get(name, 0)
        line = {kind: name, **tags, "card": card, "device_ms_per_step": ms,
                "ms_per_call": ms / per if per else None,
                "launches_per_step": launches, "flops_per_step": f,
                "tflop_per_s": f / ms / 1e9 if ms and f else None}
        for tile, tflops in (tiles or {}).items():
            tms = sum(r[1] for r in hits if tile in r[0])
            tf = tflops.get(name, 0)
            line.update({f"{tile}_ms_per_step": tms,
                         f"{tile}_tflop_per_s":
                         tf / tms / 1e9 if tms and tf else None})
        print(json.dumps(line))


def ea_tile_flops(n, ev, h, enc):
    """The variants' product operations by pass and tile: the weight tile
    (csrc/wtile.cuh: every product whose B is a weight, as stored or
    transposed) and simple.cuh's gemm_kernel (the weight pass); the
    encoder's K = 8 first layer runs on neither."""
    c, hh = eb.ENC_HID, h * h
    ew = (c * c + c * h) if enc else 0  # the encoder's two tile layers
    total = eb.pass_flops(n, ev, h, enc=enc)
    first = 2 * ev * eb.ENC_IN * c if enc else 0  # the K = 8 layer
    wtile = {"fwd_proj": 2 * n * 3 * hh, "fwd_edge": 2 * ev * (3 * hh + ew),
             "fwd_node": 2 * n * 6 * hh, "bwd_node1": total["bwd_node1"],
             "bwd_edge": total["bwd_edge"] - first,
             "bwd_node2": total["bwd_node2"]}
    gemm = {"bwd_weights": total["bwd_weights"] - first}
    return {"wtile_kernel": wtile, "gemm_kernel": gemm}


def ea_pass_lines(rows, batch, card, layers=6, kernels=EA_PASS_KERNELS,
                  tiles=False, **tags):
    """`pass_lines` of #5 and #6 (or, with ``kernels``, their variants)
    from an ea-virtual train step: ``layers`` block calls a step, layer 0
    in encoder mode, the others not; with ``tiles`` each product tile's
    own ms and TFLOP/s (`ea_tile_flops`)."""
    ctx = eb.make_ea_context(batch)
    n, ev = batch.n_node_cap, int((ctx.recv >= 0).sum())
    h = 512
    plain, enc = (eb.pass_flops(n, ev, h, enc=m) for m in (False, True))
    by_tile = None
    if tiles:
        tp, te = (ea_tile_flops(n, ev, h, m) for m in (False, True))
        by_tile = {t: {k: (layers - 1) * tp[t].get(k, 0) + te[t].get(k, 0)
                       for k in kernels} for t in tp}
    pass_lines("ea_pass", rows, kernels,
               {k: (layers - 1) * plain[k] + enc[k] for k in kernels},
               card, calls=layers, tiles=by_tile, **tags)


# the kernel names of each pass of the fused SAGE kernels in a profile: #1
# and the star tables' reduction (forward emit and backward own table);
# the backward's tile pass (#2's, or #3 on a spill batch), its band pass
# (#2's, or #4 on a spill batch), the split-K weight pass and its
# reductions
SAGE_PASS_KERNELS = {
    "fwd": ("sage_fwd_kernel",), "table_reduce": ("table_reduce_kernel",),
    "bwd_tile": ("bwd_tile_kernel",), "bwd_band": ("band_kernel",),
    "bwd_weights": ("atb_kernel",),
    "bwd_reduce": ("atb_reduce_kernel", "bias_reduce_kernel")}


def sage_pass_lines(label, rows, batch, card, layers=6, h=512):
    """`pass_lines` of the fused SAGE kernels from a train step, operations
    by `sl.pass_flops` of each layer: on a star-threaded batch layers 0 to
    L-2 emit the next layer's table and take its star on dz; on a spill
    batch the tile pass is #3's and the band pass #4's."""
    n, tile, width = batch.n_node_cap, batch.band_tile, batch.band_width
    sup = batch.has_supernode_edges
    gw = sl.star_codes(batch)[2] if sup else 0
    _, tg = star_table_geometry(batch.n_graph_cap)
    thread, tables = star_threading(batch)
    split = batch.has_spill_edges
    per = [sl.pass_flops(n, h, tile, width, gw, has_super=sup,
                         emit=tables and i < layers - 1,
                         apply_prev=thread and i < layers - 1, tg=tg)
           for i in range(layers)]
    keys = {"fwd": "fwd", "bwd_tile": "tile" if split else "bwd_tile",
            "bwd_band": "bwd_band",
            "bwd_weights": "tile_weights" if split else "bwd_weights"}
    pass_lines("sage_pass", rows, SAGE_PASS_KERNELS,
               {k: sum(f[v] for f in per) for k, v in keys.items()}, card,
               cell=label)


# ---- general graphs: the CSR segment sum and the epilogue ---------------

def csr_check(name, x, idx, off, mean):
    """#7 against its plain version on one CSR (the forward's, or the
    transposed one of the backward), within `csr_segment.gate`; returns
    (max abs error, the kernel's output)."""
    got = cs.csr_segment_sum(x, idx, off, mean)
    ref = cs.csr_segment_sum_plain(x, idx, off, mean)
    torch.cuda.synchronize()
    ok, err, share = cs.gate(got, ref, x.dtype)
    print(json.dumps({"check": name, "max_abs_err": err, "flip_share": share,
                      "tol": cs.KERNEL_TOL,
                      "max_flip_share": cs.KERNEL_FLIP_SHARE, "ok": ok}))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err}, share of outputs that differ {share})")
    return err, got


def csr_kernel_checks(label, ctx, x, seed):
    """#7's forward (add and mean) on x and its backward (the transposed
    CSR) on a seeded cotangent of x's scale; returns the largest error."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    dout = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    errs = [csr_check(f"{label}/fwd/{'mean' if m else 'add'}", x,
                      ctx.senders, ctx.row_off, m)[0] for m in (False, True)]
    errs.append(csr_check(f"{label}/bwd", dout, ctx.t_idx, ctx.t_off,
                          False)[0])
    return max(errs)


def csr_gates_catch_faults(label, ctx, x):
    """The gate fails a CSR sum without the last edge of each run and a
    mean that divides before it rounds, each made by the plain version and
    held against the kernel."""
    for mean in (False, True):
        got = cs.csr_segment_sum(x, ctx.senders, ctx.row_off, mean)
        for fault, bad in cs.faults(x, ctx.senders, ctx.row_off,
                                    mean).items():
            ok, err, share = cs.gate(bad, got, x.dtype)
            name = f"{label}/{'mean' if mean else 'add'}/{fault}"
            print(json.dumps({"gate": name, "caught": not ok,
                              "max_abs_err": err, "flip_share": share}))
            if ok:
                fail(f"{name}: the CSR gate lets a wrong sum pass")


def csr_deterministic(label, ctx, x):
    """No float atomics: two calls of #7, forward and backward, give the
    same bits."""
    outs = [[cs.csr_segment_sum(x, ctx.senders, ctx.row_off),
             cs.csr_segment_sum(x, ctx.t_idx, ctx.t_off)] for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(json.dumps({"check": f"{label}/csr/deterministic", "ok": same}))
    if not same:
        fail("two calls of the CSR kernel gave different bits")


def hub_graph(dev, n=512, hub=800, seed=5):
    """The CSR of random edges on n nodes plus an ``hub``-degree hub at
    node 3 (tests/test_segment.py:124-126)."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n - 1, size=2000), np.full(hub, 3)])
    s = rng.integers(0, n - 1, size=len(r))
    order = np.argsort(r, kind="stable")
    to = lambda a: torch.from_numpy(a[order].astype(np.int32)).to(dev)
    return cs.make_csr_context(to(s), to(r), n)


def ragged_trainer_batch(dev):
    """A batch as the trainer packs it: 48 virtual-edge panels (10-20
    nodes a side) at suggest_capacities' caps (5% slack), unbanded: the
    dead row owns every pad edge, thousands of them."""
    ds = normalize_dataset(generate_dataset(
        48, seed=7, min_side=10, max_side=20, use_super_node=False,
        use_virtual_edges=True))[0]
    ncap, ecap = suggest_capacities(ds, 48)
    b = next(batch_iterator(ds, 48, ncap, ecap, device=dev))
    dead_in = int((b.receivers == b.n_node_cap - 1).sum())
    if dead_in < 1000:
        fail(f"the trainer-packed batch's dead row has {dead_in} edges")
    return b, dead_in


def epilogue_checks(label, c, p, g):
    """#8 and #9 against their plain versions, bit for bit, with and
    without the skip, at dropout RATE; the dropped share; and the faults
    of `epilogue.faults`, which must differ."""
    for skip in (True, False):
        pp = p if skip else None
        y = ep.epilogue_fwd(c, pp, SEED, RATE)
        dc, dp = ep.epilogue_bwd(g, c, SEED, RATE, skip)
        yp = ep.epilogue_fwd_plain(c, pp, SEED, RATE)
        dcp, dpp = ep.epilogue_bwd_plain(g, c, SEED, RATE, skip)
        torch.cuda.synchronize()
        same = {"y": torch.equal(y, yp), "dc": torch.equal(dc, dcp),
                "dp": dp is None and dpp is None or torch.equal(dp, dpp)}
        keep = keep_mask(SEED, *c.shape, RATE, c.device)
        print(json.dumps({"check": f"{label}/epilogue/skip{int(skip)}",
                          "bit_equal": same, "dropped_share": float(
                              (~keep).float().mean()),
                          "ok": all(same.values())}))
        if not all(same.values()):
            fail(f"{label}: the epilogue kernels differ from their plain "
                 f"versions {same}")
        for fault, (fy, (fdc, fdp)) in ep.faults(g, c, pp, SEED,
                                                 RATE).items():
            caught = {"y": fy is not None and not torch.equal(fy, y),
                      "dc": not torch.equal(fdc, dc)}
            print(json.dumps({"gate": f"{label}/epilogue/skip{int(skip)}/"
                                      f"{fault}", "caught": caught}))
            if not any(caught.values()):
                fail(f"{fault}: the epilogue gate lets a wrong epilogue pass")


def library_epilogue_fwd(c, p, keep, scale):
    """#8's function as a PyTorch composition (the keep mask precomputed),
    a yardstick only: the port never calls it."""
    return torch.where(keep, ((torch.relu(c) + p).float() * scale).to(c.dtype),
                       0.0)


def library_epilogue_bwd(g, c, keep, scale):
    """#9's function as a PyTorch composition (the keep mask precomputed),
    a yardstick only."""
    dp = torch.where(keep, (g.float() * scale).to(g.dtype), 0.0)
    return torch.where(c > 0, dp, 0.0), dp


def general_graphs(dev, card):
    """Phase 8: the csr-virtual cell and its xla twin (see the module
    docstring). Prints their checks, serving and training numbers;
    returns the three new kernels' entries of the kernel table and the
    launch counts of the four paths."""
    t0 = time.perf_counter()
    csetup = build_serve_setup(device=dev, config="csr-virtual")
    cbatch, cmodel = csetup["batch"], csetup["model"]
    cn = cbatch.n_node_cap
    cctx = cs.make_csr_context(cbatch.senders, cbatch.receivers, cn)
    indeg = cctx.row_off[1:] - cctx.row_off[:-1]
    print(json.dumps({
        "csr_setup_s": time.perf_counter() - t0, "n_node_cap": cn,
        "n_real_nodes": int(cbatch.node_mask.sum()),
        "n_edges": csetup["n_edges"], "n_edge_cap": cbatch.n_edge_cap,
        "n_graphs": csetup["n_graphs"], "banded": cbatch.band_senders
        is not None, "dead_row_edges": int(indeg[-1]),
        "max_real_in_degree": int(indeg[:-1].max())}))
    if cbatch.band_senders is not None or cn % 256 == 0:
        fail("the csr-virtual batch must be unbanded with an exact node cap")
    with torch.no_grad():
        xc0 = cmodel.node_encoder(cbatch.nodes)
    csr_errs = [csr_kernel_checks("csr-virtual/h512", cctx, xc0, 101),
                csr_kernel_checks("csr-virtual/h128", cctx,
                                  seeded_x(cbatch, 128, 102), 103)]
    csr_gates_catch_faults("csr-virtual", cctx, xc0)
    csr_deterministic("csr-virtual", cctx, xc0)
    hub = hub_graph(dev)
    for h in (128, 512):
        g = torch.Generator(device=dev).manual_seed(104 + h)
        xh = torch.randn((512, h), generator=g, device=dev).to(torch.bfloat16)
        csr_errs.append(csr_kernel_checks(f"hub800/h{h}", hub, xh, 105 + h))
    rtb, dead_in = ragged_trainer_batch(dev)
    rctx = cs.make_csr_context(rtb.senders, rtb.receivers, rtb.n_node_cap)
    print(json.dumps({"trainer_packed_batch": [rtb.n_node_cap,
                                               rtb.n_edge_cap],
                      "dead_row_edges": dead_in}))
    for h in (128, 512):
        csr_errs.append(csr_kernel_checks(
            f"trainer-packed/h{h}", rctx, seeded_x(rtb, h, 106 + h),
            107 + h))
    gc = torch.Generator(device=dev).manual_seed(111)
    c_e, p_e, g_e = (torch.randn((cn, 512), generator=gc, device=dev)
                     .to(torch.bfloat16) for _ in range(3))
    epilogue_checks("csr-virtual", c_e, p_e, g_e)
    epilogue_checks("odd-shape", *(t[:1000, :136].contiguous()
                                   for t in (c_e, p_e, g_e)))

    cserve, cserve_launches, _ = serve_path("csr-virtual", csetup,
                                            kernel="csr_segment")
    cserve_prof = step_profile(
        "csr-virtual serve step", lambda: csetup["eval_step"](cbatch),
        cserve["infer_step_ms"], card)
    print(json.dumps(cserve_prof))
    ctrain = build_train_setup(device=dev, config="csr-virtual")
    torch.cuda.reset_peak_memory_stats()
    cbench, closses, ctrain_launches = train_path(
        "csr-virtual", ctrain,
        {"csr_segment": 2, "epilogue_fwd": 1, "epilogue_bwd": 1})
    cgrad_err = train_vs_plain(ctrain, "csr-virtual", gen_seeds=(11, 12))
    ctrain_prof = step_profile(
        "csr-virtual train step",
        lambda: ctrain["train_step"](ctrain["batch"], ctrain["lr"],
                                     ctrain["generator"]),
        cbench["train_step_ms"], card)
    print(json.dumps(ctrain_prof))
    csr_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    xsetup = build_serve_setup(device=dev, config="csr-virtual-xla")
    xserve, xserve_launches, _ = serve_path("csr-virtual-xla", xsetup,
                                            kernel=None)
    xserve_prof = step_profile(
        "csr-virtual-xla serve step",
        lambda: xsetup["eval_step"](xsetup["batch"]),
        xserve["infer_step_ms"], card)
    print(json.dumps(xserve_prof))
    xtrain = build_train_setup(device=dev, config="csr-virtual-xla")
    torch.cuda.reset_peak_memory_stats()
    xbench, xlosses, xtrain_launches = train_path(
        "csr-virtual-xla", xtrain, {"epilogue_fwd": 1, "epilogue_bwd": 1})
    xgrad_err = train_vs_plain(xtrain, "csr-virtual-xla", gen_seeds=(11,))
    xtrain_prof = step_profile(
        "csr-virtual-xla train step",
        lambda: xtrain["train_step"](xtrain["batch"], xtrain["lr"],
                                     xtrain["generator"]),
        xbench["train_step_ms"], card)
    print(json.dumps(xtrain_prof))
    xla_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the new kernels at the csr-virtual shape: #7 on the encoder output
    # (forward) and a cotangent of its scale (backward, transposed CSR)
    e_n, h = cctx.senders.numel(), xc0.shape[1]
    c_ms = event_ms(lambda: cs.csr_segment_sum(xc0, cctx.senders,
                                               cctx.row_off))
    c_plain_ms = event_ms(lambda: cs.csr_segment_sum_plain(
        xc0, cctx.senders, cctx.row_off), reps=5)
    msgs32, recv = xc0[cctx.senders.long()].float(), cctx.receivers.long()
    c_lib_ms = event_ms(lambda: torch.zeros(
        (cn, h), device=dev).index_add_(0, recv, msgs32))
    del msgs32
    c_mean_ms = event_ms(lambda: cs.csr_segment_sum(xc0, cctx.senders,
                                                    cctx.row_off, True))
    c_bwd_ms = event_ms(lambda: cs.csr_segment_sum(g_e, cctx.t_idx,
                                                   cctx.t_off))
    # the long runs' tail: #7 on the cell's batch beside its longest runs,
    # and on the 800-degree hub graph (one long row, forward and backward)
    xh = torch.randn((hub.num_segments, h), generator=gc, device=dev).to(
        torch.bfloat16)
    t_runs = cctx.t_off[1:] - cctx.t_off[:-1]
    print(json.dumps({
        "csr_tail": "csr_segment on csr-virtual and on the hub graph",
        "card": card, "csr_virtual_fwd_ms": c_ms,
        "csr_virtual_bwd_ms": c_bwd_ms, "longest_run": int(indeg.max()),
        "dead_row_run": int(indeg[-1]),
        "longest_real_run": int(indeg[:-1].max()),
        "longest_transposed_run": int(t_runs.max()),
        "hub_rows": hub.num_segments, "hub_run": int(
            (hub.row_off[1:] - hub.row_off[:-1]).max()),
        "hub_fwd_ms": event_ms(lambda: cs.csr_segment_sum(
            xh, hub.senders, hub.row_off)),
        "hub_bwd_ms": event_ms(lambda: cs.csr_segment_sum(
            xh, hub.t_idx, hub.t_off))}))
    idx_bytes = nbytes_of(cctx.senders, cctx.row_off)
    c_bound_ms, c_bound_by = bound(0, e_n * h, 2 * nbytes_of(xc0)
                                   + idx_bytes)
    c_gathered_ms = (e_n * h * xc0.element_size() + nbytes_of(xc0)
                     + idx_bytes) / PEAK_BYTES * 1e3
    ctx_ms = event_ms(lambda: cs.make_csr_context(cbatch.senders,
                                                  cbatch.receivers, cn))
    keep_e = keep_mask(SEED, *c_e.shape, RATE, dev)
    scale_e = torch.tensor(dropout_scale(RATE), device=dev)
    e_ms = event_ms(lambda: ep.epilogue_fwd(c_e, p_e, SEED, RATE))
    e_noskip_ms = event_ms(lambda: ep.epilogue_fwd(c_e, None, SEED, RATE))
    e_plain_ms = event_ms(lambda: ep.epilogue_fwd_plain(c_e, p_e, SEED,
                                                        RATE), reps=5)
    e_lib_ms = event_ms(lambda: library_epilogue_fwd(c_e, p_e, keep_e,
                                                     scale_e))
    e_bound_ms, e_bound_by = bound(0, 0, 3 * nbytes_of(c_e))
    eb_ms = event_ms(lambda: ep.epilogue_bwd(g_e, c_e, SEED, RATE, True))
    eb_noskip_ms = event_ms(lambda: ep.epilogue_bwd(g_e, c_e, SEED, RATE,
                                                    False))
    eb_plain_ms = event_ms(lambda: ep.epilogue_bwd_plain(g_e, c_e, SEED,
                                                         RATE, True), reps=5)
    eb_lib_ms = event_ms(lambda: library_epilogue_bwd(g_e, c_e, keep_e,
                                                      scale_e))
    eb_bound_ms, eb_bound_by = bound(0, 0, 4 * nbytes_of(c_e))
    for cell, sv, sp, tr, tp, peak, gerr, losses_, launches_ in (
            ("csr-virtual", cserve, cserve_prof, cbench, ctrain_prof,
             csr_peak_gb, cgrad_err, closses, ctrain_launches),
            ("csr-virtual-xla", xserve, xserve_prof, xbench, xtrain_prof,
             xla_peak_gb, xgrad_err, xlosses, xtrain_launches)):
        print(json.dumps({
            "cell": f"{cell}: GraphSage_addAggr_Shared 6L h512 bf16, 128 "
                    "virtual-edge panels unbanded, dropout 0.1 in training, "
                    "Adam lr 1e-3", "card": card,
            "infer_step_ms": sv["infer_step_ms"],
            "infer_samples_per_s": sv["infer_samples_per_s"],
            "infer_edges_per_s": sv["infer_edges_per_s"],
            "infer_busy_share": sp["busy_share"],
            "train_step_ms": tr["train_step_ms"],
            "train_edges_per_s": tr["train_edges_per_s"],
            "train_busy_share": tp["busy_share"], "n_edges": tr["n_edges"],
            "n_graphs": tr["n_graphs"], "checked_losses": losses_,
            "loss": tr["metrics"]["loss"], "mape": tr["metrics"]["mape"],
            "grad_rel_err": gerr, "launches": launches_,
            "peak_mem_gb": peak}))
    print(json.dumps({
        "kernels": "csr_segment and epilogue variants", "card": card,
        "csr_mean_ms": c_mean_ms, "csr_bwd_ms": c_bwd_ms,
        "csr_gathered_bound_ms": c_gathered_ms, "csr_context_ms": ctx_ms,
        "epilogue_fwd_noskip_ms": e_noskip_ms,
        "epilogue_bwd_noskip_ms": eb_noskip_ms}))
    by_path = {"csr_serve": cserve_launches, "csr_train": ctrain_launches,
               "csr_xla_serve": xserve_launches,
               "csr_xla_train": xtrain_launches}
    return [{
        "name": "csr_segment", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/csr_segment.cu",
        "replaces": TPU_CSR_KERNEL,
        "launches": ctrain_launches["csr_segment"],
        "max_abs_err": max(csr_errs), "ms": c_ms, "plain_ms": c_plain_ms,
        "bound_ms": c_bound_ms, "bound_by": c_bound_by,
        "library_ms": c_lib_ms,
    }, {
        "name": "epilogue_fwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/epilogue.cu",
        "replaces": TPU_EPI_FWD_KERNEL,
        "launches": ctrain_launches["epilogue_fwd"],
        "max_abs_err": 0.0, "ms": e_ms, "plain_ms": e_plain_ms,
        "bound_ms": e_bound_ms, "bound_by": e_bound_by,
        "library_ms": e_lib_ms,
    }, {
        "name": "epilogue_bwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/epilogue.cu",
        "replaces": TPU_EPI_BWD_KERNEL,
        "launches": ctrain_launches["epilogue_bwd"],
        "max_abs_err": 0.0, "ms": eb_ms, "plain_ms": eb_plain_ms,
        "bound_ms": eb_bound_ms, "bound_by": eb_bound_by,
        "library_ms": eb_lib_ms,
    }], by_path


# ---- 9. the unfused banded path and the rest of the family ----------------

def step_mem_gb(train):
    """One train step's own device memory (GB): its peak less what was
    allocated before it (the step's inputs, the model, the other cells)."""
    def step():
        return train["train_step"](train["batch"], train["lr"],
                                   train["generator"])

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e9


def hub_spill2_batch(dev):
    """One graph whose node 0 receives 320 out-of-band edges, more than its
    tile's spill window holds, so the overflow goes to spill2 (the batch of
    tests/test_torch_port_spill.py::test_spill_scope_guards)."""
    from buckgnn_tpu_torch.graph.batch import GraphData, pack_graphs

    rng = np.random.default_rng(0)
    far = rng.integers(450, 700, size=320)
    s_und = np.concatenate([far, np.arange(1, 640, 2)])
    r_und = np.concatenate([np.zeros(len(far), np.int64),
                            np.arange(2, 641, 2)])
    senders = np.concatenate([s_und, r_und]).astype(np.int32)
    receivers = np.concatenate([r_und, s_und]).astype(np.int32)
    g = GraphData(x=rng.normal(size=(700, 15)).astype(np.float32),
                  senders=senders, receivers=receivers,
                  edge_attr=rng.normal(size=(len(senders), 5)).astype(
                      np.float32), y=np.ones((1,), np.float32))
    b = pack_graphs([g], 1024, ((len(senders) + 127) // 128) * 128, 2,
                    band_width=128, band_tile=256, device=dev)
    if not (b.has_spill2_edges and b.has_spill_edges):
        fail("the hub batch must have spill and spill2 edges")
    return b


def spill2_checks(dev):
    """The unfused banded aggregation on the spill2 batch at H = 512:
    forward and backward (kernel #4 once each) against the plain path on
    the same inputs, and a gate that fails a plain sum without spill2."""
    from buckgnn_tpu_torch.ops.banded import banded_sage_aggregate

    b = hub_spill2_batch(dev)
    ctx = make_agg_context(b, use_pallas=True)
    x = seeded_x(b, 512, 71)
    g = seeded_x(b, 512, 72)

    def run(batch_ctx):
        xr = x.clone().requires_grad_()
        agg = banded_sage_aggregate(xr, batch_ctx)
        agg.backward(g)
        return agg.detach(), xr.grad

    reset_launch_counts()
    agg, dx = run(ctx)
    torch.cuda.synchronize()
    expect_launches("spill2/aggregate fwd+bwd", launch_counts(),
                    {"banded_matmul": 2})
    with plain_kernels():
        agg_p, dx_p = run(ctx)
        wrong, _ = run(make_agg_context(b.replace(has_spill2_edges=False),
                                        use_pallas=True))
    errs = [check_close("spill2/agg", agg, agg_p,
                        sl.gate_tol(agg_p, bm.KERNEL_BANDED_TOL)),
            check_close("spill2/dx", dx, dx_p,
                        sl.gate_tol(dx_p, bm.KERNEL_BANDED_TOL))]
    check_caught("spill2/no-spill2", wrong, agg,
                 sl.gate_tol(agg, bm.KERNEL_BANDED_TOL))
    print(json.dumps({"spill2_batch": [b.n_node_cap, b.band_tile,
                                       b.band_width],
                      "spill2_edges": int((b.spill2_receivers
                                           != b.n_node_cap - 1).sum())}))
    return max(errs)


def cell_data(setup):
    """The (normalized dataset, normalizer) of a set-up, for a cell with the
    same panels."""
    return setup["dataset"], setup["normalizer"]


def device_band_checks(dev, card, vsetup):
    """The virtual cell packed with materialize_band=False: the device
    band equals the packed one bit for bit, and its serve (the fused
    layer, on the device band) matches the packed batch's."""
    from buckgnn_tpu_torch.ops.banded import build_band_matrix

    bsetup = build_serve_setup(device=dev, config="virtual-bandless",
                               data=cell_data(vsetup))
    bb = bsetup["batch"]
    if bb.band is not None:
        fail("the bandless batch must carry no band")
    band = build_band_matrix(bb)
    packed = make_agg_context(vsetup["batch"]).band
    same = band.dtype == torch.int8 and torch.equal(band, packed)
    print(json.dumps({"check": "virtual-bandless/band", "ok": same,
                      "dtype": str(band.dtype)}))
    if not same:
        fail("the device-built band differs from the packed band")
    bserve, blaunches, _ = serve_path("virtual-bandless", bsetup,
                                      n_steps=5)
    _, (pred, _) = bsetup["eval_step"](bb)
    _, (pred_v, _) = vsetup["eval_step"](vsetup["batch"])
    gm = bb.graph_mask
    check_close("virtual-bandless/pred-vs-packed", pred[gm], pred_v[gm],
                PRED_TOL)
    print(json.dumps({"path": "virtual-bandless", "card": card,
                      "pred_bit_equal_to_packed": bool(torch.equal(
                          pred, pred_v)),
                      "band_build_ms": event_ms(
                          lambda: build_band_matrix(bb), reps=5),
                      "infer_step_ms": bserve["infer_step_ms"]}))
    return blaunches


def unfused_cell(label, dev, card, serve_kernel, train_kernels, data,
                 pred_tol=PRED_TOL, readout=False, n_steps=5, rows_out=None):
    """Serve and train one cell of ``CELLS`` on the unfused paths: launch
    counts, the forward and one train step against the plain path, the
    profiles, and the step's own memory. One set-up serves (its eval_step,
    before training) and trains, on the panels of ``data`` (`cell_data`).
    ``rows_out`` receives the train step's profile rows (`step_profile`).
    Returns (summary, launches by path, train setup)."""
    t0 = time.perf_counter()
    train = build_train_setup(device=dev, config=label, data=data)
    setup_s = time.perf_counter() - t0
    serve, serve_l, _ = serve_path(label, dict(train,
                                               model=train["state"].model),
                                   kernel=serve_kernel, pred_tol=pred_tol,
                                   n_steps=n_steps)
    serve_prof = step_profile(f"{label} serve step",
                              lambda: train["eval_step"](train["batch"]),
                              serve["infer_step_ms"], card)
    print(json.dumps(serve_prof))
    bench, losses, train_l = train_path(label, train, train_kernels,
                                        n_steps=n_steps)
    grad_err = train_vs_plain(train, label, gen_seeds=(11,),
                              pred_tol=pred_tol, readout=readout)
    train_prof = step_profile(
        f"{label} train step",
        lambda: train["train_step"](train["batch"], train["lr"],
                                    train["generator"]),
        bench["train_step_ms"], card, rows_out=rows_out)
    print(json.dumps(train_prof))
    cfg = train["cfg"]
    dt = "bf16" if cfg.compute_dtype == "bfloat16" else cfg.compute_dtype
    summary = {
        "cell": f"{label}: {cfg.model_name} 6L h{cfg.hidden_channels} {dt}, "
                f"{cfg.segment_impl}, remat={cfg.remat}, dropout 0.1 in "
                "training, Adam lr 1e-3", "card": card,
        "infer_step_ms": serve["infer_step_ms"],
        "infer_samples_per_s": serve["infer_samples_per_s"],
        "infer_edges_per_s": serve["infer_edges_per_s"],
        "infer_busy_share": serve_prof["busy_share"],
        "train_step_ms": bench["train_step_ms"],
        "train_edges_per_s": bench["train_edges_per_s"],
        "train_busy_share": train_prof["busy_share"],
        "n_edges": bench["n_edges"], "n_graphs": bench["n_graphs"],
        "checked_losses": losses, "loss": bench["metrics"]["loss"],
        "mape": bench["metrics"]["mape"], "grad_rel_err": grad_err,
        "launches": train_l, "step_mem_gb": step_mem_gb(train),
        "setup_s": setup_s}
    return summary, {f"{label}_serve": serve_l, f"{label}_train": train_l}, \
        train


def family_cases(dev):
    """(tag, cfg fields, batch, normalizer) of the family phase: every
    model_name under every pooling on the buckling head (a small banded
    supernode batch, impl banded_pallas: kernel #4, #8/#9, and the fused
    kernels where a model takes them), and every model_name under each
    node-level head (small unbanded batches, impl pallas: kernel #7,
    #8/#9)."""
    from buckgnn_tpu_torch.models.buckgnn import MODELS, POOLINGS
    from buckgnn_tpu_torch.train.trainer import slice_static_targets

    small, nz = normalize_dataset(generate_dataset(
        7, seed=5, min_side=10, max_side=16, use_super_node=True,
        use_virtual_edges=False))
    banded = pack_exact(small, 7, 64, 256, dev)
    cases = [(f"{name}/{pool}", dict(model_name=name, pooling_layer=pool,
                                     segment_impl="banded_pallas"),
              banded, nz)
             for name in MODELS for pool in POOLINGS]
    for ptype in ("static_disp", "static_stress", "mode_shape"):
        ds, nzp = normalize_dataset(generate_dataset(
            5, seed=6, min_side=10, max_side=16, use_super_node=False,
            use_virtual_edges=True, prediction_type=ptype),
            prediction_type=ptype)
        ds = slice_static_targets(ds, ptype)
        b = pack_exact(ds, 5, None, 256, dev)
        cases += [(f"{name}/{ptype}", dict(
            model_name=name, prediction_type=ptype, segment_impl="pallas",
            loss_function="mse"), b, nzp) for name in MODELS]
    return cases


def family_phase(dev, card):
    """Every model_name x pooling (buckling) and x node-level head, H 128,
    3 layers, bf16, dropout 0.1: pred (eval_step) and one train step's
    loss, kernel path against the same model under plain_kernels(), and
    the SAG models' kept sets; launch totals over the phase."""
    from types import SimpleNamespace

    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model, make_eval_step

    t0 = time.perf_counter()
    cases = family_cases(dev)
    reset_launch_counts()
    worst = {}
    for tag, fields, b, nz in cases:
        cfg = TrainConfig(hidden_channels=128, num_layers=3,
                          compute_dtype="bfloat16", seed=0, **fields)
        model = build_model(cfg, b.nodes.shape[1], b.edges.shape[1],
                            device=dev)
        graph_level = cfg.prediction_type == "buckling"
        # pooled SAGE predictions average the bf16 flips away (PRED_TOL);
        # an EA stack's noise and a node-level head's per-node outputs are
        # single bf16 values of order one (EA_PRED_TOL, two ulps). Both
        # absolute tolerances are of a unit-scale prediction: where the
        # prediction's rms is larger (the hybrid pooling sums the
        # unnormalized EA features over each graph's nodes and mixes them
        # by an MLP: rms 1.8-7.6), its noise is of that scale, and the
        # absolute tolerance scales with it
        tol = (PRED_TOL if graph_level and "EA" not in cfg.model_name
               else EA_PRED_TOL)
        evaluate = make_eval_step(model, get_loss_function(
            cfg.loss_function), cfg, nz)
        m, (pred, aux) = evaluate(b)
        with plain_kernels():
            mp, (pred_p, aux_p) = evaluate(b)
        sel = b.graph_mask if graph_level else aux_p["real_node_mask"]
        if not torch.equal(aux["node_keep"], aux_p["node_keep"]):
            fail(f"family/{tag}: the kernel path keeps other nodes")
        setup = dict(state=SimpleNamespace(model=model), batch=b, cfg=cfg,
                     normalizer=nz)
        loss, _ = step_grads(setup, 11)
        with plain_kernels():
            loss_p, _ = step_grads(setup, 11)
        rms = float(pred_p[sel].float().pow(2).mean().sqrt())
        ptol = (tol[0] * max(1.0, rms), tol[1])
        (ok_p, e_p), (ok_l, e_l) = (within(pred[sel], pred_p[sel], ptol),
                                    within(loss, loss_p, tol))
        worst[tag] = {"pred_err": e_p, "loss_err": e_l, "pred_tol": ptol,
                      "loss_tol": tol, "pred_rms": rms,
                      "loss": float(loss_p)}
        if not (ok_p and ok_l):
            fail(f"family/{tag}: pred or loss off the plain path "
                 f"{worst[tag]}")
    torch.cuda.synchronize()
    launches = launch_counts()
    top = sorted(worst, key=lambda k: -max(worst[k]["pred_err"],
                                           worst[k]["loss_err"]))[:6]
    print(json.dumps({"check": "family", "ok": True, "cases": len(cases),
                      "card": card, "s": time.perf_counter() - t0,
                      "launches": launches,
                      "worst": {k: worst[k] for k in top}}))
    for k in ("banded_matmul", "csr_segment", "epilogue_fwd",
              "epilogue_bwd"):
        if launches[k] == 0:
            fail(f"family: {k} never launched")
    return launches


def unfused_paths(dev, card, setup, vsetup, vtrain, etrain):
    """Phase 9 (see the module docstring). Prints the new cells' checks,
    serving and training numbers; returns the launches by path. The cells
    reuse the panels of the flagship (``setup``), virtual and ea-virtual
    set-ups."""
    remat_kernels = {"banded_matmul": 3, "epilogue_fwd": 1,
                     "epilogue_bwd": 1}
    rsum, paths, rtrain = unfused_cell("virtual-remat", dev, card,
                                       "banded_matmul", remat_kernels,
                                       cell_data(vsetup))
    rsum["virtual_step_mem_gb"] = step_mem_gb(vtrain)
    print(json.dumps(rsum))
    del rtrain
    fsum, p, _ = unfused_cell("flagship-remat", dev, card, "banded_matmul",
                              remat_kernels, cell_data(setup), n_steps=3)
    print(json.dumps(fsum))
    paths.update(p)
    spill2_err = spill2_checks(dev)
    paths["virtual-bandless_serve"] = device_band_checks(dev, card, vsetup)
    msum, p, _ = unfused_cell(
        "virtual-meanaggr", dev, card, "banded_matmul",
        {"banded_matmul": 2, "epilogue_fwd": 1, "epilogue_bwd": 1},
        cell_data(vsetup))
    print(json.dumps(msum))
    paths.update(p)
    esum, p, _ = unfused_cell("ea-windowed", dev, card, None, {},
                              cell_data(etrain), pred_tol=EA_PRED_TOL,
                              readout=True, n_steps=3)
    esum["ea_virtual_step_mem_gb"] = step_mem_gb(etrain)
    print(json.dumps(esum))
    print(json.dumps({"path": "ea-windowed", "kernels_launched": sum(
        p["ea-windowed_train"].values()) + sum(
        p["ea-windowed_serve"].values())}))
    paths.update(p)
    paths["family"] = family_phase(dev, card)
    return paths, spill2_err


# ---- the training run and the checkpoint it serves from ---------------------

# The resume check: at dropout 0 a run of 2 epochs resumed to 3 (B) against
# 3 uninterrupted epochs (C), both on the card. #1 and #2 sum in a fixed
# order, but PyTorch's atomics on the card need not, so B and C may part
# in the last bits: each parameter's difference is held in norm to 2% of
# C's own third-epoch update (GRAD_TOL's reasoning: a bf16 rounding flip
# moves a few entries, an Adam step that lost its moments or weights that
# were not loaded move every entry by O(1) of the update), and the third
# epoch's losses and MAPEs within PRED_TOL, the forward's. On an H100 the
# two runs came out bit-equal; the check prints whether they do.
RESUME_TOL = GRAD_TOL
RUN_EPOCHS = 3
RUN_TRAIN, RUN_VAL = 256, 64  # the flagship's panels: 2 batches and 1


class RecordingWriter(MetricsWriter):
    """The trainer's MetricsWriter, which also keeps each scalar train_gnn
    writes (Perf/train_step_ms among them): the run phase reads them, and
    the host phase harvests what it wrote."""

    made = []

    def __init__(self, log_dir):
        super().__init__(log_dir)
        self.scalars = {}
        RecordingWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        super().add_scalar(tag, value, step)
        self.scalars.setdefault(tag, []).append(float(value))


@contextlib.contextmanager
def recorded_packs(module):
    """Keep every batch list `module`'s batch_iterator packs."""
    from unittest import mock

    packs = []

    def packing(*a, **k):
        packs.append(list(batch_iterator(*a, **k)))
        return iter(packs[-1])

    with mock.patch.object(module, "batch_iterator", packing):
        yield packs


def recorded_run(*args, **kw):
    """train_gnn with its scalars and packs recorded: (result, scalars, the
    batches of each pack: the train set's, then the val set's)."""
    from unittest import mock

    from buckgnn_tpu_torch.train import trainer

    with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
            recorded_packs(trainer) as packs:
        res = trainer.train_gnn(*args, **kw)
    return res, RecordingWriter.made[-1].scalars, packs


def loop_cost(cfg, batch, nz, features, dev, steps, reps=5):
    """The run's first train batch (the trainer's capacities) trained by a
    fresh model outside the loop: the bench's steady step on it, and the
    step of ``steps`` steps that start on an idle card, as each epoch's do
    (ms each, ``reps`` times)."""
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import (
        build_model, make_optimizer, make_train_step,
    )

    model = build_model(cfg, *features, device=dev)
    step, _ = make_train_step(model, make_optimizer(cfg, model),
                              get_loss_function(cfg.loss_function), cfg, nz)
    gen = torch.Generator().manual_seed(0)
    steady = run_train_bench(dict(
        batch=batch, train_step=step, lr=cfg.lr, generator=gen,
        n_edges=int(batch.edge_mask.sum()),
        n_graphs=int(batch.graph_mask.sum())))["train_step_ms"]
    cold = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, cfg.lr, gen)
        torch.cuda.synchronize()
        cold.append((time.perf_counter() - t0) / steps * 1e3)
    return steady, cold


def check_run(label, res, epochs):
    for h in res.history:
        if not all(math.isfinite(float(v)) for v in h.values()):
            fail(f"{label}: non-finite epoch {h}")
    if len(res.history) != epochs:
        fail(f"{label}: {len(res.history)} epochs, expected {epochs}")


def training_run(dev, card, bench_step_ms, bench_n_node_cap, out):
    """Phase 10: train_gnn on the flagship's config and panels, its resume
    at dropout 0, run_inference on the weights/best it wrote, and the epoch
    loop's own cost per step over the bench's; every run writes under the
    directory ``out``, which the host phase harvests. Returns the launches
    of the run's two paths, its epochs' Perf/train_step_ms, its log
    directory and its config."""
    import dataclasses
    import io
    import os

    from buckgnn_tpu_torch import bench as port_bench
    from buckgnn_tpu_torch.eval.inference import run_inference

    t0 = time.perf_counter()
    panels = generate_dataset(RUN_TRAIN + RUN_VAL, seed=0, min_side=24,
                              max_side=32, use_super_node=True,
                              use_virtual_edges=False)
    train, nz = normalize_dataset(panels[:RUN_TRAIN])
    val, _ = normalize_dataset(panels[RUN_TRAIN:], nz)
    data_s = time.perf_counter() - t0
    cfg = dataclasses.replace(port_bench.cell_config("flagship"),
                              num_epochs=RUN_EPOCHS)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    reset_launch_counts()
    res, scalars, (packed, val_packed) = recorded_run(
        cfg, train, val, nz, out, trial_id="run", verbose=False,
        device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    train_launches = launch_counts()
    steps, val_batches = len(packed), len(val_packed)
    n_cap = packed[0].n_node_cap
    del val_packed
    # batches of 128 panels: 2 train steps and 1 val batch an epoch
    if (steps, val_batches) != (-(-RUN_TRAIN // cfg.batch_size),
                                -(-RUN_VAL // cfg.batch_size)):
        fail(f"run/train packed {steps} train and {val_batches} val "
             "batches")
    expect_launches(
        f"run/train ({RUN_EPOCHS} epochs of {steps} train steps and "
        f"{val_batches} val batch)", train_launches,
        {"sage_layer_fwd": layers * RUN_EPOCHS * (steps + val_batches),
         "sage_layer_bwd": layers * RUN_EPOCHS * steps})
    check_run("run/train", res, RUN_EPOCHS)
    wdir = os.path.join(res.log_dir, "weights")
    for d in ("last", "best"):
        if not os.path.exists(os.path.join(wdir, d, "state.pt")):
            fail(f"run/train wrote no weights/{d}/state.pt")

    # ---- resume at dropout 0 ----
    t0 = time.perf_counter()
    cfg0 = dataclasses.replace(cfg, dropout_rate=0.0)
    first = recorded_run(dataclasses.replace(cfg0, num_epochs=2),
                         train, val, nz, os.path.join(out, "a"),
                         trial_id="a", verbose=False, device=dev)[0]
    resumed = recorded_run(cfg0, train, val, nz, os.path.join(out, "b"),
                           trial_id="b", resume_from=os.path.join(
                               first.log_dir, "weights", "last"),
                           verbose=False, device=dev)[0]
    whole = recorded_run(cfg0, train, val, nz, os.path.join(out, "c"),
                         trial_id="c", verbose=False, device=dev)[0]
    resume_s = time.perf_counter() - t0
    check_run("run/resume", resumed, 1)
    check_run("run/whole", whole, RUN_EPOCHS)
    if resumed.history[0]["epoch"] != RUN_EPOCHS - 1:
        fail(f"run/resume started at epoch {resumed.history[0]}")
    b, c = resumed.history[0], whole.history[-1]
    keys = ("train_loss", "val_loss", "train_mape", "val_mape")
    for k in keys:
        check_close(f"run/resume/{k}", torch.tensor(b[k]),
                    torch.tensor(c[k]), PRED_TOL)
    pa = first.state.model.state_dict()
    pb = resumed.state.model.state_dict()
    rel = {}
    bit_equal = all(b[k] == c[k] for k in keys)
    for k, p in whole.state.model.state_dict().items():
        upd = float((p - pa[k]).float().norm())
        diff = float((pb[k] - p).float().norm())
        rel[k] = diff / upd if upd else (0.0 if diff == 0 else math.inf)
        bit_equal &= torch.equal(pb[k], p)
    worst = max(rel, key=rel.get)
    print(json.dumps({
        "check": "run/resume: 2 epochs + resume to 3 vs 3, dropout 0",
        "card": card, "third_epoch": {"resumed": b, "whole": c},
        "worst_param": worst, "param_rel_diff": rel[worst],
        "tol": RESUME_TOL, "bit_equal": bit_equal,
        "ok": rel[worst] <= RESUME_TOL}))
    if rel[worst] > RESUME_TOL:
        fail(f"run/resume: {worst} differs by {rel[worst]} of its "
             "third-epoch update from the uninterrupted run")

    # ---- serve weights/best ----
    t0 = time.perf_counter()
    reset_launch_counts()
    served = run_inference(os.path.join(wdir, "best"), val,
                           os.path.join(out, "serve"),
                           batch_size=cfg.batch_size, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = launch_counts()
    expect_launches(f"run/serve ({val_batches} batch)", serve_launches,
                    {"sage_layer_fwd": layers * val_batches})
    check_close("run/serve/mape vs the best epoch's val MAPE",
                torch.tensor(served["MAPE"]),
                torch.tensor(res.best_val_mape), PRED_TOL)

    # the loop's own cost: Perf/train_step_ms spans an epoch's steps and
    # its one fetch, not the packing; beside it, the run's first batch
    # trained outside the loop (steady, and in epochs of cold steps)
    step_ms = scalars["Perf/train_step_ms"]
    features = (train[0].x.shape[1], train[0].edge_attr.shape[1])
    padded_ms, cold_ms = loop_cost(cfg, packed[0], nz, features, dev, steps)
    del packed
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_bench.main()
    bench_line = buf.getvalue().strip().splitlines()[-1]
    print(bench_line)
    print(json.dumps({
        "run": "flagship train_gnn: 6L h512 bf16 banded_pallas, 256 train "
               "and 64 val supernode panels, batch 128, dropout 0.1, lr "
               "1e-3, 3 epochs", "card": card,
        "history": res.history, "best_val_mape": res.best_val_mape,
        "serve": served, "n_node_cap": n_cap,
        "bench_n_node_cap": bench_n_node_cap, "data_s": data_s,
        "run_s": run_s, "resume_s": resume_s, "serve_s": serve_s}))
    print(json.dumps({
        "metric": "run/loop_overhead", "card": card,
        "epoch_train_step_ms": step_ms, "bench_train_step_ms": bench_step_ms,
        "overhead": [ms / bench_step_ms - 1.0 for ms in step_ms],
        "padded_step_ms": padded_ms, "cold_epoch_step_ms": cold_ms,
        "padding": padded_ms / bench_step_ms - 1.0,
        "cold_start": float(np.median(cold_ms)) / padded_ms - 1.0,
        "loop_own": [ms / float(np.median(cold_ms)) - 1.0 for ms in step_ms],
        "n_node_cap": n_cap, "bench_n_node_cap": bench_n_node_cap,
        "bench_main_value": json.loads(bench_line)["value"]}))
    return ({"run_train": train_launches, "run_serve": serve_launches},
            step_ms, res.log_dir, cfg)


# ---- 11. the command line on folder datasets ------------------------------

# The README's quick start through `cli.main`, in this process so that the
# launches are counted: the flagship's flags on datagen folders, then the
# JAX package's default flags on a folder of their own (the dataset cache
# is keyed on the prediction type alone, so it would hand back the
# supernode graphs).
CLI_FLAGSHIP = ["--use-super-node", "--model-name", "GraphSage_addAggr_Shared",
                "--hidden-channels", "512", "--num-layers", "6",
                "--compute-dtype", "bfloat16", "--segment-impl",
                "banded_pallas", "--batch-size", "128", "--lr", "1e-3",
                "--num-epochs", "3"]
CLI_LAYERS, CLI_EPOCHS, CLI_DEFAULT_EPOCHS = 6, 3, 2
CLI_DATAGEN = {  # folder -> datagen flags: 256, 64 and 96 cases
    "D/Train": ["--n-models", "64", "--loadcases-per-model", "4",
                "--stiffeners", "--seed", "0"],
    "D/Validation": ["--n-models", "16", "--seed", "1000"],
    "E": ["--n-models", "24", "--seed", "2000"],
}


def cli_call(argv):
    """cli.main(argv) with its standard output kept: (seconds, the lines it
    printed, the JSON object of its last line)."""
    import io

    from buckgnn_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        fail(f"cli {argv[0]} returned {rc}: {lines[-3:]}")
    return time.perf_counter() - t0, lines, json.loads(lines[-1])


def sage_train_launches(train_packs, val_packs, epochs, layers, suffix=""):
    """What a fused SAGE run's batches imply: per layer, #1 for each train
    step and val batch; #2 for each train step on a batch without spill
    edges, #3 and #4 (the split backward) for each one with them. With
    ``suffix`` "_simple", the kernels' float32 / any-width variants."""
    spill = sum(b.has_spill_edges for b in train_packs)
    steps, val = len(train_packs), len(val_packs)
    want = {"sage_layer_fwd": layers * epochs * (steps + val),
            "sage_layer_bwd": layers * epochs * (steps - spill)}
    if spill:
        want["sage_layer_bwd_tile"] = want["banded_matmul"] = \
            layers * epochs * spill
    return {k + suffix: v for k, v in want.items() if v}, spill


def cli_batch_checks(packs):
    """The CLI train run's kernels against their plain versions on its
    first and last (short) batch, with seeded activations at H 512: #1's
    spill variant (serving and training), #3's tile pass and #4 with the
    spill window, the star table and acc. Returns {kernel: [max abs
    errors]}."""
    errs = {"sage_layer_fwd": [], "sage_layer_bwd_tile": [],
            "banded_matmul": []}
    for i in sorted({0, len(packs) - 1}):
        b = packs[i]
        if not (b.has_spill_edges and b.has_supernode_edges):
            fail(f"cli train batch {i} must have spill edges and stars")
        x = seeded_x(b, 512, 120 + i)
        w = check_weights(512, x, b.node_mask, seed=8 + i)
        name = f"cli/train/batch{i}/n{int(b.node_mask.sum())}"
        m = b.node_mask
        errs["sage_layer_fwd"] += [
            fwd_vs_plain(name, *spill_inputs(b, x, w, True), m),
            train_fwd_checks(name, *spill_inputs(b, x, w, True), m)]
        errs["sage_layer_bwd_tile"].append(
            tile_vs_plain(name, b, x, w, True, RATE))
        errs["banded_matmul"].append(banded_vs_plain(
            f"{name}/spill1/table1/acc1",
            *banded_inputs(b, x, 130 + i, True, True, True)))
    return errs


def tune_launches(results, packs_of):
    """What a tune run's trials imply: `sage_train_launches` of each
    trial's own packs over the epochs it ran (ASHA may stop one early),
    summed."""
    want = {}
    for i, r in enumerate(results):
        packs = packs_of[f"trial_{i:05d}"]
        if len(packs) != 2:
            fail(f"cli tune trial {i} packed {len(packs)} batch lists")
        w, _ = sage_train_launches(*packs, r["final"]["epoch"] + 1,
                                   r["config"]["num_layers"])
        for k, v in w.items():
            want[k] = want.get(k, 0) + v
    return want


def cli_tune(flags):
    """`cli tune --synthetic 64` over two learning rates, both trials at
    once, with ``flags``: (seconds, its last line, the trials' results,
    each trial's packs by trial id). Each trial's thread keeps its trial
    id, so that the packs it makes are its own."""
    import threading
    from unittest import mock

    from buckgnn_tpu_torch.train import trainer, tune

    seen, packs_of, current = [], {}, threading.local()
    real, real_train = tune.hyperparameter_optimization, tune.train_gnn
    real_iter = trainer.batch_iterator

    def recording(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[1])
        return out

    def tracked(*a, trial_id, **kw):
        current.trial = trial_id
        return real_train(*a, trial_id=trial_id, **kw)

    def packing(*a, **k):
        packs = packs_of.setdefault(getattr(current, "trial", None), [])
        packs.append(list(real_iter(*a, **k)))
        return iter(packs[-1])

    with mock.patch.object(tune, "hyperparameter_optimization", recording), \
            mock.patch.object(tune, "train_gnn", tracked), \
            mock.patch.object(trainer, "batch_iterator", packing):
        secs, _, tuned = cli_call([
            "tune", "--synthetic", "64", "--max-concurrent", "2", "--grid",
            '{"lr": [1e-3, 1e-2]}', *flags])
    (results,) = seen
    return secs, tuned, results, packs_of


def cli_phase(dev, card, run_step_ms):
    """Phase 11: datagen, split, train, infer and timer at the flagship's
    flags, train at the JAX package's defaults, tune with two concurrent
    trials, and ``python -m buckgnn_tpu_torch --help``. Returns the paths'
    launches, and the kernels' errors against their plain versions on the
    train run's batches."""
    import os
    from unittest import mock

    from buckgnn_tpu_torch.eval import inference
    from buckgnn_tpu_torch.train import trainer

    phase_t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    paths, lines = {}, []

    def report(step, seconds, **kw):
        line = {"cli": step, "card": card, "s": seconds, **kw}
        lines.append(line)
        print(json.dumps(line))

    with tempfile.TemporaryDirectory() as tmp:
        def at(rel):
            return os.path.join(tmp, rel)

        # ---- datagen: one process each, all at once (no kernel) ----
        t0 = time.perf_counter()
        procs = {rel: subprocess.Popen(
            [sys.executable, "-m", "buckgnn_tpu_torch", "datagen",
             "--out-dir", at(rel), *flags], cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rel, flags in CLI_DATAGEN.items()}
        for rel, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"cli datagen {rel}: {out[-2000:]}")
        counts = {rel: sum(f.endswith(".bdf") for f in os.listdir(at(rel)))
                  for rel in CLI_DATAGEN}
        report("datagen", time.perf_counter() - t0, cases=counts)
        if counts != {"D/Train": 256, "D/Validation": 64, "E": 96}:
            fail(f"cli datagen wrote {counts}")

        # ---- split (its data flags make the folder's supernode cache) ----
        secs, _, split = cli_call(["split", "--data-dir", at("D/Train"),
                                   "--out-dir", at("S"), "--use-super-node"])
        with open(at("S/split_manifest.json")) as f:
            sizes = json.load(f)["sizes"]
        report("split", secs, sizes=sizes)
        if sum(sizes) != 256 or split["sizes"] != sizes:
            fail(f"cli split sizes {sizes}")

        # ---- train at the flagship's width ----
        reset_launch_counts()
        with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
                recorded_packs(trainer) as packs:
            secs, _, run = cli_call(["train", "--data-dir", at("D"),
                                     "--output-dir", at("R"), *CLI_FLAGSHIP])
        got = launch_counts()
        scalars = RecordingWriter.made[-1].scalars
        tr, va = packs
        want, spill = sage_train_launches(tr, va, CLI_EPOCHS, CLI_LAYERS)
        expect_launches(f"cli/train ({CLI_EPOCHS} epochs of {len(tr)} train "
                        f"steps, {spill} with spill edges, and {len(va)} val "
                        "batch)", got, want)
        paths["cli/train"] = got
        best = os.path.join(run["log_dir"], "weights", "best")
        if not (math.isfinite(run["best_val_mape"])
                and os.path.exists(os.path.join(best, "state.pt"))):
            fail(f"cli train: {run}")
        report("train", secs, step_ms=scalars["Perf/train_step_ms"],
               run_phase_step_ms=run_step_ms,
               best_val_mape=run["best_val_mape"],
               n_node_cap=tr[0].n_node_cap, train_batches=len(tr),
               spill_batches=spill, val_batches=len(va),
               real_nodes=[int(b.node_mask.sum()) for b in tr],
               launches=got)
        kernel_errs = cli_batch_checks(tr)
        del packs, tr, va

        # ---- infer on weights/best, the same graphs as the val set ----
        reset_launch_counts()
        with recorded_packs(inference) as packs:
            secs, _, served = cli_call([
                "infer", "--model-path", best, "--data-dir",
                at("D/Validation"), "--output-dir", at("I"),
                "--use-super-node"])
        got = launch_counts()
        expect_launches(f"cli/serve ({len(packs[0])} batch)", got,
                        {"sage_layer_fwd": CLI_LAYERS * len(packs[0])})
        paths["cli/serve"] = got
        check_close("cli/serve/mape vs the run's best val MAPE",
                    torch.tensor(served["MAPE"]),
                    torch.tensor(run["best_val_mape"]), PRED_TOL)
        report("infer", secs, mape=served, launches=got)
        del packs

        # ---- timer: 3 warm-up and 20 timed forwards of one batch ----
        reset_launch_counts()
        secs, _, timed = cli_call([
            "timer", "--model-path", best, "--data-dir", at("D/Validation"),
            "--output-path", at("timer.txt"), "--use-super-node"])
        got = launch_counts()
        expect_launches("cli/timer (23 forwards)", got,
                        {"sage_layer_fwd": CLI_LAYERS * 23})
        paths["cli/timer"] = got
        if timed["nastran"] is not None or not timed["samples_per_s"] > 0:
            fail(f"cli timer: {timed}")
        report("timer", secs, mape=timed["metrics"]["mape"],
               samples_per_s=timed["samples_per_s"],
               latency_per_sample_ms=timed["latency_per_sample_ms"],
               nastran=timed["nastran"], n_node_cap=timed["n_node_cap"],
               launches=got)

        # ---- train at the JAX package's default flags ----
        dtypes = set()
        fwd = ep.epilogue_fwd

        def typed(c, *a, **k):
            dtypes.add(str(c.dtype))
            return fwd(c, *a, **k)

        reset_launch_counts()
        with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
                mock.patch.object(ep, "epilogue_fwd", typed), \
                recorded_packs(trainer) as packs:
            secs, _, drun = cli_call([
                "train", "--data-dir", at("E"), "--output-dir", at("R2"),
                "--num-epochs", str(CLI_DEFAULT_EPOCHS)])
        got = launch_counts()
        scalars = RecordingWriter.made[-1].scalars
        steps = len(packs[0])
        each = CLI_LAYERS * CLI_DEFAULT_EPOCHS * steps
        expect_launches(f"cli/default ({CLI_DEFAULT_EPOCHS} epochs of "
                        f"{steps} train steps)", got,
                        {"epilogue_fwd": each, "epilogue_bwd": each})
        paths["cli/default"] = got
        if dtypes != {"torch.float32"} or not math.isfinite(
                drun["best_val_mape"]):
            fail(f"cli default train: {drun}, epilogue dtypes {dtypes}")
        report("default", secs, step_ms=scalars["Perf/train_step_ms"],
               best_val_mape=drun["best_val_mape"],
               n_node_cap=packs[0][0].n_node_cap, train_batches=steps,
               val_batches=len(packs[1]), epilogue_dtypes=sorted(dtypes),
               launches=got)
        del packs

        # ---- phase 13's command line: the default flags (float32, H 128)
        # on banded_pallas, then infer: kernels #1-#4's simple variants ----
        paths.update(cli_f32_banded(at, report))
        # ---- phase 14's: EA_GNN_Shared at the default flags on
        # banded_pallas, then infer: kernels #5 and #6's simple variants ----
        paths.update(cli_f32_ea(at, report))

        # ---- tune: two grid points at once on the card ----
        reset_launch_counts()
        secs, tuned, results, packs_of = cli_tune([
            "--output-dir", at("T"), "--compute-dtype", "bfloat16",
            "--segment-impl", "banded_pallas", "--hidden-channels", "128",
            "--use-super-node", "--num-epochs", "2"])
        got = launch_counts()
        paths["cli/tune"] = got
        a, b = (r["schedule"] for r in results)
        overlap = min(a["end"], b["end"]) - max(a["start"], b["start"])
        if (tuned["n_trials"] != 2 or overlap <= 0
                or not all(math.isfinite(r["best_val_mape"])
                           for r in results)):
            fail(f"cli tune: {tuned}, schedules {a} {b}")
        epochs = [r["final"]["epoch"] + 1 for r in results]
        expect_launches(f"cli/tune (2 trials of {epochs} epochs)", got,
                        tune_launches(results, packs_of))
        report("tune", secs, overlap_s=overlap,
               schedules=[r["schedule"] for r in results], epochs=epochs,
               best_val_mape=[r["best_val_mape"] for r in results],
               launches=got)
        del packs_of

    # ---- python -m buckgnn_tpu_torch --help ----
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "buckgnn_tpu_torch",
                          "--help"], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0 or "datagen,train,tune" not in res.stdout:
        fail(f"python -m buckgnn_tpu_torch --help: {res.stderr[-2000:]}")
    report("help", time.perf_counter() - t0)
    print(json.dumps({"phase": "cli", "card": card,
                      "s": time.perf_counter() - phase_t0}))
    return paths, kernel_errs


def cli_f32_banded(at, report):
    """``train --data-dir D --segment-impl banded_pallas`` at the default
    flags otherwise (float32, H 128, virtual edges) for CLI_DEFAULT_EPOCHS
    epochs, then ``infer`` on its weights/best over D/Validation: the
    launches its batches imply of the simple variants (and no engine
    kernel), finite scalars, and the served MAPE the run's best val
    MAPE."""
    import os
    from unittest import mock

    from buckgnn_tpu_torch.eval import inference
    from buckgnn_tpu_torch.train import trainer

    paths = {}
    reset_launch_counts()
    with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
            recorded_packs(trainer) as packs:
        secs, _, run = cli_call([
            "train", "--data-dir", at("D"), "--output-dir", at("R3"),
            "--segment-impl", "banded_pallas", "--num-epochs",
            str(CLI_DEFAULT_EPOCHS)])
    got = launch_counts()
    scalars = RecordingWriter.made[-1].scalars
    tr, va = packs
    if any(b.has_spill2_edges for b in tr + va):
        fail("cli f32 banded: a batch with spill2 edges (unfused layers)")
    want, spill = sage_train_launches(tr, va, CLI_DEFAULT_EPOCHS, CLI_LAYERS,
                                      suffix="_simple")
    expect_launches(f"cli/f32-banded ({CLI_DEFAULT_EPOCHS} epochs of "
                    f"{len(tr)} train steps, {spill} with spill edges, and "
                    f"{len(va)} val batch)", got, want)
    paths["cli/f32-banded"] = got
    bad = {k: v for k, v in scalars.items()
           if not all(math.isfinite(x) for x in v)}
    best = os.path.join(run["log_dir"], "weights", "best")
    if bad or not (math.isfinite(run["best_val_mape"])
                   and os.path.exists(os.path.join(best, "state.pt"))):
        fail(f"cli f32 banded train: {run}, non-finite scalars {bad}")
    report("f32-banded", secs, step_ms=scalars["Perf/train_step_ms"],
           best_val_mape=run["best_val_mape"],
           losses={k: v for k, v in scalars.items() if "oss" in k},
           n_node_cap=tr[0].n_node_cap, train_batches=len(tr),
           spill_batches=spill, val_batches=len(va), launches=got)
    del packs, tr, va
    reset_launch_counts()
    with recorded_packs(inference) as packs:
        secs, _, served = cli_call([
            "infer", "--model-path", best, "--data-dir", at("D/Validation"),
            "--output-dir", at("I3")])
    got = launch_counts()
    expect_launches(f"cli/f32-banded serve ({len(packs[0])} batch)", got,
                    {"sage_layer_fwd_simple": CLI_LAYERS * len(packs[0])})
    paths["cli/f32-banded-serve"] = got
    check_close("cli/f32-banded/serve/mape vs the run's best val MAPE",
                torch.tensor(served["MAPE"]),
                torch.tensor(run["best_val_mape"]), PRED_TOL)
    report("f32-banded-infer", secs, mape=served, launches=got)
    return paths


def cli_f32_ea(at, report):
    """``train --data-dir D --model-name EA_GNN_Shared --segment-impl
    banded_pallas`` at the default flags otherwise (float32, H 128, so the
    blocks' plain mode, the edge encoder outside) for CLI_DEFAULT_EPOCHS
    epochs, then ``infer`` on its weights/best over D/Validation: per
    layer #5's variant for each train step and val batch and #6's for
    each train step (every batch takes the fused block), no engine or
    SAGE kernel, finite scalars, and the served MAPE the run's best val
    MAPE."""
    import os
    from unittest import mock

    from buckgnn_tpu_torch.eval import inference
    from buckgnn_tpu_torch.train import trainer

    paths = {}
    reset_launch_counts()
    with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
            recorded_packs(trainer) as packs:
        secs, _, run = cli_call([
            "train", "--data-dir", at("D"), "--output-dir", at("R4"),
            "--model-name", "EA_GNN_Shared", "--segment-impl",
            "banded_pallas", "--num-epochs", str(CLI_DEFAULT_EPOCHS)])
    got = launch_counts()
    scalars = RecordingWriter.made[-1].scalars
    tr, va = packs
    h = 128
    if not all(eb.supports_fused_ea(b, h) for b in tr + va):
        fail("cli f32 EA: a batch the fused block does not take")
    each = CLI_LAYERS * CLI_DEFAULT_EPOCHS
    expect_launches(f"cli/f32-ea ({CLI_DEFAULT_EPOCHS} epochs of {len(tr)} "
                    f"train steps and {len(va)} val batch)", got,
                    {"ea_block_fwd_simple": each * (len(tr) + len(va)),
                     "ea_block_bwd_simple": each * len(tr)})
    paths["cli/f32-ea"] = got
    bad = {k: v for k, v in scalars.items()
           if not all(math.isfinite(x) for x in v)}
    best = os.path.join(run["log_dir"], "weights", "best")
    if bad or not (math.isfinite(run["best_val_mape"])
                   and os.path.exists(os.path.join(best, "state.pt"))):
        fail(f"cli f32 EA train: {run}, non-finite scalars {bad}")
    report("f32-ea", secs, step_ms=scalars["Perf/train_step_ms"],
           best_val_mape=run["best_val_mape"],
           losses={k: v for k, v in scalars.items() if "oss" in k},
           n_node_cap=tr[0].n_node_cap, windows=list(tr[0].win_sidx.shape),
           train_batches=len(tr), val_batches=len(va), launches=got)
    del packs, tr, va
    reset_launch_counts()
    with recorded_packs(inference) as packs:
        secs, _, served = cli_call([
            "infer", "--model-path", best, "--data-dir", at("D/Validation"),
            "--output-dir", at("I4")])
    got = launch_counts()
    expect_launches(f"cli/f32-ea serve ({len(packs[0])} batch)", got,
                    {"ea_block_fwd_simple": CLI_LAYERS * len(packs[0])})
    paths["cli/f32-ea-serve"] = got
    check_close("cli/f32-ea/serve/mape vs the run's best val MAPE",
                torch.tensor(served["MAPE"]),
                torch.tensor(run["best_val_mape"]), PRED_TOL)
    report("f32-ea-infer", secs, mape=served, launches=got)
    return paths


# ---- phase 13: float32 and every H % 128 == 0 ------------------------------

# (dtype, H) of the variant checks: float32 at the engine's widths and
# beyond, bf16 at the widths the engine does not take
WIDTH_CASES = [(torch.float32, h) for h in (128, 384, 512, 640, 1024)] + [
    (torch.bfloat16, h) for h in (384, 640, 1024)]
SIMPLE = ("sage_layer_fwd_simple", "sage_layer_bwd_simple",
          "sage_layer_bwd_tile_simple", "banded_matmul_simple")
SIMPLE_SOURCE = "buckgnn_tpu_torch/csrc/sage_simple.cu"


def dtname(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


def once(name, fn):
    """fn()'s result, and that it launched kernel ``name`` once and no
    other kernel."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    if got != dict(before, **{name: before[name] + 1}):
        fail(f"{name}: launches {before} -> {got}")
    return out


def vcheck(name, got, ref, dtype, bf16_tol, frac=False, worst=None):
    """got within the variant gate (bm.variant_tol) of ``dtype``; float32
    errors also as a share of max|ref| into ``worst`` (a dict)."""
    atol, rtol = bm.variant_tol(ref, dtype, bf16_tol, frac)
    err = check_close(name, got, ref, (atol, rtol))
    if dtype == torch.float32 and worst is not None:
        share = err / max(float(ref.float().abs().max()), 1e-30)
        worst["f32_err_over_max"] = max(worst.get("f32_err_over_max", 0.0),
                                        share)
    return err


def vcaught(name, got, wrong, dtype, bf16_tol, frac=False):
    """A deliberately wrong plain output must fail the variant gate."""
    check_caught(name, got, wrong, bm.variant_tol(wrong, dtype, bf16_tol,
                                                  frac))


# ---- float32 kept: the 3xTF32 tile against float64, and one TF32 pass ----

def f64_check(name, got, ref64, worst, key):
    """A float32 output within SIMPLE_F32_TOL of max|ref64| of a float64
    evaluation; its error as a share of max|ref64| into ``worst[key]``.
    Returns the share."""
    m = max(float(ref64.abs().max()), 1e-30)
    err = check_close(f"{name}/f64", got, ref64, (bm.SIMPLE_F32_TOL * m, 0.0))
    worst[key] = max(worst.get(key, 0.0), err / m)
    return err / m


def tf32_pass_check(name, a, b):
    """On the card's operands of one product a @ b: the 3xTF32 split
    (bm.mm_3xtf32) holds the float32 gate against the float64 product and
    one TF32 pass (its hi.hi alone) breaks it, so the gate tells float32
    from TF32. Returns the two errors as shares of max|a @ b|."""
    ref = a.double() @ b.double()
    m = float(ref.abs().max())
    three, one = (float((bm.mm_3xtf32(a, b, lo=lo).double() - ref).abs()
                        .max()) / m for lo in (True, False))
    ok = three <= bm.SIMPLE_F32_TOL < one
    print(json.dumps({"check": f"{name}/one-tf32-pass", "ok": ok,
                      "shape": [*a.shape, b.shape[1]],
                      "three_pass_err_over_max": three,
                      "one_pass_err_over_max": one,
                      "tol": bm.SIMPLE_F32_TOL}))
    if not ok:
        fail(f"{name}: the float32 gate does not tell 3xTF32 from one "
             "TF32 pass")
    return three, one


def tile_plain_f64(args, kw):
    """#3's plain function (sl.sage_layer_bwd_tile_plain, float32 inputs)
    evaluated in float64, with its one cast, dout to x's dtype: (dout_c in
    x's dtype, dagg, dxp, dW_l, dW_r, db_l) in float64."""
    dz, y, inv, agg, x, w_l, w_r = args
    dz_eff = dz.double()
    rate = kw["rate"]
    if rate > 0.0:
        keep = keep_mask(kw["seed"], *dz.shape, rate, dz.device)
        scale = float(np.float32(dropout_scale(rate)))
        dz_eff = torch.where(keep, dz_eff * scale, 0.0)
    y64 = y.double()
    dy = torch.where(y64 > 0.0, dz_eff, 0.0)
    s = (dy * y64).sum(dim=-1, keepdim=True)
    dout = (dy - y64 * s) * inv.double().reshape(-1, 1)
    dout_c = dout.to(x.dtype)
    d = dout_c.double()
    dxp = d @ w_r.double().t()
    if kw["skip"]:
        dxp = dxp + dz_eff
    return (dout_c, d @ w_l.double().t(), dxp, agg.double().t() @ d,
            x.double().t() @ d, dout.sum(dim=0))


def tile_f64_checks(name, got, args, kw, rows, worst, one_pass):
    """#3s's float32 outputs (dagg, dxp on ``rows``, dW_l, dW_r, db_l)
    within SIMPLE_F32_TOL of max|ref| of `tile_plain_f64`, the plain
    version's float32 outputs beside them (``worst``: the largest shares
    of both); with ``one_pass``, `tf32_pass_check` on dagg's product and
    on a 2,048-row chunk of dW_l's."""
    ref = tile_plain_f64(args, kw)
    plain = sl.sage_layer_bwd_tile_plain(*args, **kw)
    for what, g, p, r in zip(TILE_NAMES, got, plain, ref[1:]):
        if what in ("dagg", "dxp"):
            g, p, r = g[rows], p[rows], r[rows]
        f64_check(f"{name}/{what}", g, r, worst, "f32_err_over_max_f64")
        pm = float(r.abs().max())
        worst["plain_err_over_max_f64"] = max(
            worst.get("plain_err_over_max_f64", 0.0),
            float((p.double() - r).abs().max()) / pm)
    if one_pass:
        dout_c, w_l, agg = ref[0], args[5], args[3]
        tf32_pass_check(f"{name}/dagg", dout_c, w_l.t())
        tf32_pass_check(f"{name}/dw_l-chunk", agg[:2048].t().contiguous(),
                        dout_c[:2048])


@contextlib.contextmanager
def ea_plain_f64():
    """ops/ea_block.py's plain versions evaluated in float64 for the while:
    their products, gathers and segment sums (float32 by design) in
    float64; with float64 inputs every cast to x's dtype keeps float64."""
    saved = eb._mm, eb._gathered, eb._segment

    def gathered(p, ids):
        pz = torch.cat([p, p.new_zeros((1, p.shape[1]))])
        return pz[torch.where(ids < 0, p.shape[0], ids.long())].double()

    def segment(v, ids, n):
        keep = ids >= 0
        out = torch.zeros((n, v.shape[1]), dtype=torch.float64,
                          device=v.device)
        out.index_add_(0, ids[keep].long(), v[keep].double())
        return out

    eb._mm = lambda a, b: a.double() @ b.double()
    eb._gathered, eb._segment = gathered, segment
    try:
        yield
    finally:
        eb._mm, eb._gathered, eb._segment = saved


def ea_f64_checks(label, batch, ctx, worst):
    """#6s in float32 at H 512 (plain mode, skip, dropout 0.1) against the
    float64 evaluation of its plain version (`ea_plain_f64`), at #6's gates
    (a relu mask recomputed from float32 sums can flip against float64 as
    against the float32 plain version: ops/ea_block.py), the plain float32
    version's readings beside it; then `tf32_pass_check` on its first node
    product, dropout(dz_x) @ W_b1^T, and on a 2,048-row chunk of the
    weight pass's shape, x^T @ dropout(dz_x)."""
    h = 512
    x, e, w, bias = ea_case(batch, h, False, 160, torch.float32)
    kw = dict(skip=True, rate=RATE, seed=SEED, enc=False)
    _, _, e1s, m1s = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True, **kw)
    g = torch.Generator(device=x.device).manual_seed(161)
    dzx = torch.randn(x.shape, generator=g, device=x.device)
    dze = torch.randn(e.shape, generator=g, device=x.device)
    args = (dzx, dze, e1s, m1s, x, e, w, bias, ctx)
    got = eb.ea_block_bwd(*args, **kw)
    plain = eb.ea_block_bwd_plain(*args, **kw)
    with ea_plain_f64():
        ref = eb.ea_block_bwd_plain(
            *(t.double() for t in args[:6]),
            {k: v.double() for k, v in w.items()}, bias.double(), ctx, **kw)
    name = f"{label}/f32/h{h}/plain/skip1/rate{RATE}"
    ea_bwd_errors(f"{name}/f64", got, ref, ctx, h)
    errs = eb.bwd_errors(got, ref, ctx)
    perrs = eb.bwd_errors(plain, ref, ctx)
    print(json.dumps({"check": f"{name}/f64/readings", "kernel": errs,
                      "plain": perrs}))
    worst["kernel_dx_rel_err_f64"] = errs["dx"]
    worst["plain_dx_rel_err_f64"] = perrs["dx"]
    dx2 = apply_dropout(dzx, SEED, RATE, row0=ctx.n_slots)
    tf32_pass_check(f"{name}/dx2@wb1t", dx2, w["wb1"].t())
    tf32_pass_check(f"{name}/dw-chunk", x[:2048].t().contiguous(),
                    dx2[:2048])


def variant_checks(label, batch, vbatch, sbatch, dtype, h, worst):
    """The four variants against their plain versions at (dtype, h) on the
    flagship batch (#1 serving with local windows and emit, training with
    the whole table; #2 with the next layer's star at dropout 0.1 and
    without at 0), the virtual batch (#1's spill term, serving and
    training; #3 at dropout 0.1 and 0; #4 as the split backward calls it,
    the x-dtype and the f32 output) and the supernode + spill batch (#4
    with the table). Returns {kernel: max abs err}."""
    errs = {k: 0.0 for k in SIMPLE}

    def note(k, e):
        errs[k] = max(errs[k], e)

    tag = f"{label}/{dtname(dtype)}/h{h}"
    m = batch.node_mask
    x = seeded_x(batch, h, 200 + h, dtype)
    w = check_weights(h, x, m, seed=h, dtype=dtype)
    for windows, emit, train in ((True, True, False), (False, False, True)):
        args, kw, b = layer_inputs(batch, x, w, windows, emit, True)
        name = f"{tag}/{'local+emit' if emit else 'full-table'}"
        if train:
            kw = dict(kw, save_res=True, rate=RATE, seed=SEED)
        z = once("sage_layer_fwd_simple", lambda: sl.sage_layer_fwd(*args,
                                                                    **kw))
        ref = sl.sage_layer_plain(*args, **kw)
        note("sage_layer_fwd_simple", vcheck(f"{name}/z", z[0][m], ref[0][m],
                                             dtype, sl.KERNEL_Z_TOL,
                                             worst=worst))
        if emit:
            tabp = sl.emit_table_plain(z[0], kw["acc_code"], kw["gwin"],
                                       kw["gw"], kw["t0"], kw["tile"])
            note("sage_layer_fwd_simple", vcheck(
                f"{name}/table", z[1], tabp, dtype, sl.KERNEL_TABLE_TOL,
                worst=worst))
        if train:
            for what, i in (("y", 2), ("agg", 4)):
                note("sage_layer_fwd_simple", vcheck(
                    f"{name}/train/{what}", z[i][m], ref[i][m], dtype,
                    sl.KERNEL_Z_TOL, worst=worst))
            check_close(f"{name}/train/inv", z[3][m], ref[3][m],
                        sl.KERNEL_INV_TOL)
            dropped = ~keep_mask(SEED, batch.n_node_cap, h, RATE, x.device)
            if not (bool((z[0][dropped] == 0).all())
                    and bool((ref[0][dropped] == 0).all())):
                fail(f"{name}: the variant drops other positions")
    for windows, prev, skip, rate in ((True, True, True, RATE),
                                      (False, True, False, 0.0)):
        args, kw, b = bwd_inputs(batch, x, w, windows, prev, skip, rate,
                                 seed=h + 1)
        got = once("sage_layer_bwd_simple",
                   lambda: sl.sage_layer_bwd(*args, **kw))
        ref = sl.sage_layer_bwd_plain(*args, **kw)
        for what, g, r in zip(BWD_NAMES, got, ref):
            if what == "dx":
                g, r = g[m], r[m]
            note("sage_layer_bwd_simple", vcheck(
                f"{tag}/bwd/local{int(windows)}/rate{rate}/{what}", g, r,
                dtype, sl.KERNEL_BWD_TOL[what], frac=True, worst=worst))
    vm = vbatch.node_mask
    xv = seeded_x(vbatch, h, 300 + h, dtype)
    wv = check_weights(h, xv, vm, seed=h + 2, dtype=dtype)
    sargs, skw = spill_inputs(vbatch, xv, wv, True)
    for train in (False, True):
        kw = dict(skw, save_res=True, rate=RATE, seed=SEED) if train else skw
        z = once("sage_layer_fwd_simple", lambda: sl.sage_layer_fwd(*sargs,
                                                                    **kw))
        ref = sl.sage_layer_plain(*sargs, **kw)
        for what, i in (("z", 0),) + ((("y", 2), ("agg", 4)) if train
                                      else ()):
            note("sage_layer_fwd_simple", vcheck(
                f"{tag}/spill/train{int(train)}/{what}", z[i][vm], ref[i][vm],
                dtype, sl.KERNEL_Z_TOL, worst=worst))
    for skip, rate in ((True, RATE), (False, 0.0)):
        targs, tkw = tile_inputs(vbatch, xv, wv, skip, rate, seed=h + 3)
        got = once("sage_layer_bwd_tile_simple",
                   lambda: sl.sage_layer_bwd_tile(*targs, **tkw))
        ref = sl.sage_layer_bwd_tile_plain(*targs, **tkw)
        for what, g, r in zip(TILE_NAMES, got, ref):
            if r is None:
                continue
            if what in ("dagg", "dxp"):
                g, r = g[vm], r[vm]
            note("sage_layer_bwd_tile_simple", vcheck(
                f"{tag}/tile/rate{rate}/{what}", g, r, dtype,
                sl.KERNEL_BWD_TOL[what], frac=True, worst=worst))
        if dtype == torch.float32:
            tile_f64_checks(f"{tag}/tile/rate{rate}", got, targs, tkw, vm,
                            worst, one_pass=h == 512 and skip)
    for name, b, xb, spill, table, out in (
            ("virtual/spill1/acc1", vbatch, xv, True, False, dtype),
            ("virtual/spill1/acc1/f32-out", vbatch, xv, True, False,
             torch.float32),
            ("super+spill/table1", sbatch,
             seeded_x(sbatch, h, 400 + h, dtype), True, True, dtype)):
        args, kw = banded_inputs(b, xb, h + 4, spill, table, True)
        kw["out_dtype"] = out
        got = once("banded_matmul_simple",
                   lambda: bm.banded_matmul(*args, **kw))
        ref = bm.banded_matmul_plain(*args, **kw)
        note("banded_matmul_simple", vcheck(
            f"{tag}/banded/{name}", got, ref, dtype, bm.KERNEL_BANDED_TOL,
            frac=True, worst=worst))
    return errs


def simple_fwd_deterministic(batch, h=512):
    """No float atomics: two calls of #1's float32 variant (the weight
    tile, the one-pass code sums) give the same bits, serving with emit
    and training at dropout 0.1."""
    x = seeded_x(batch, h, 77, torch.float32)
    w = check_weights(h, x, batch.node_mask, seed=78, dtype=torch.float32)
    args, kw, _ = layer_inputs(batch, x, w, True, True, True)
    targs, tkw, _ = layer_inputs(batch, x, w, False, False, True)
    tkw = dict(tkw, save_res=True, rate=RATE, seed=SEED)
    outs = [[sl.sage_layer_fwd(*args, **kw), sl.sage_layer_fwd(*targs, **tkw)]
            for _ in range(2)]
    torch.cuda.synchronize()
    flat = [[t for o in run for t in o if t is not None] for run in outs]
    same = all(torch.equal(a, b) for a, b in zip(*flat))
    print(json.dumps({"check": f"widths/f32/h{h}/sage_layer_fwd_simple/"
                      "deterministic", "ok": same}))
    if not same:
        fail("two calls of #1's float32 variant gave different bits")


def variant_gates(batch, vbatch, dtype, h):
    """The variant gates fail plain versions with a fault, each held
    against the variant's own output: a norm over 7/8 of the sum of
    squares, a dropped b_l, a forward without its spill term (z and agg),
    a norm backward without its s term, a backward that ignores the next
    layer's star, a band product without its spill messages."""
    tag = f"widths/{dtname(dtype)}/h{h}"
    m = batch.node_mask
    x = seeded_x(batch, h, 500 + h, dtype)
    w = check_weights(h, x, m, seed=h + 5, dtype=dtype)
    args, kw, _ = layer_inputs(batch, x, w, True, False, False)
    z, _ = sl.sage_layer_fwd(*args, **kw)
    zp, _ = sl.sage_layer_plain(*args, **kw)
    scaled = (zp.float() * math.sqrt(8 / 7)).to(zp.dtype)
    vcaught(f"{tag}/norm-7/8", z[m], scaled[m], dtype, sl.KERNEL_Z_TOL)
    nb = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
    vcaught(f"{tag}/no-bias", z[m], sl.sage_layer_plain(*nb, **kw)[0][m],
            dtype, sl.KERNEL_Z_TOL)
    vm = vbatch.node_mask
    xv = seeded_x(vbatch, h, 600 + h, dtype)
    wv = check_weights(h, xv, vm, seed=h + 6, dtype=dtype)
    sargs, skw = spill_inputs(vbatch, xv, wv, True)
    tkw = dict(skw, save_res=True, rate=RATE, seed=SEED)
    got = sl.sage_layer_fwd(*sargs, **tkw)
    wrong = sl.sage_layer_plain(*sargs, **no_spill(tkw))
    vcaught(f"{tag}/fwd/no-spill", got[0][vm], wrong[0][vm], dtype,
            sl.KERNEL_Z_TOL)
    vcaught(f"{tag}/train/agg/no-spill", got[4][vm], wrong[4][vm], dtype,
            sl.KERNEL_Z_TOL)
    bargs, bkw, _ = bwd_inputs(batch, x, w, True, True, True, RATE,
                               seed=h + 7)
    got = sl.sage_layer_bwd(*bargs, **bkw)
    real = sl._norm_backward
    sl._norm_backward = lambda dz, y, inv: torch.where(y > 0.0, dz, 0.0) * inv
    try:
        no_s = sl.sage_layer_bwd_plain(*bargs, **bkw)
    finally:
        sl._norm_backward = real
    vcaught(f"{tag}/bwd/no-s-term", got[1], no_s[1], dtype,
            sl.KERNEL_BWD_TOL["dw_l"], frac=True)
    no_prev = sl.sage_layer_bwd_plain(*bargs, **dict(bkw, table_prev=None))
    vcaught(f"{tag}/bwd/no-apply-prev", got[0][m], no_prev[0][m], dtype,
            sl.KERNEL_BWD_TOL["dx"], frac=True)
    bargs, bkw = banded_inputs(vbatch, xv, h + 8, True, False, True)
    bkw["out_dtype"] = dtype
    got = bm.banded_matmul(*bargs, **bkw)
    vcaught(f"{tag}/banded/no-spill", got,
            bm.banded_matmul_plain(*bargs, **no_spill(bkw)), dtype,
            bm.KERNEL_BANDED_TOL, frac=True)


def tf32_passes(dtype):
    """tf32 products per product of the simple variants' tile
    (csrc/simple.cuh): 3xTF32 for float32 sources (lo.hi, hi.lo, hi.hi),
    one pass for bf16 ones (a bf16 value is a tf32 value)."""
    return 3 if dtype == torch.float32 else 1


def simple_bound(prod_flops, f32_flops, *ts, dtype=torch.float32,
                 extra_bytes=0):
    """(bound ms, what bounds it) of a simple variant: its products on the
    tensor cores, `tf32_passes` tf32 products each at the TF32 peak, and
    its other f32 operations at the FFMA peak, against its operands read
    once and outputs written once (``ts`` and ``extra_bytes``) at the HBM
    rate."""
    return bound(0, f32_flops, nbytes_of(*ts) + extra_bytes,
                 tf32_flops=tf32_passes(dtype) * prod_flops)


def variant_timings(fsetup, vfsetup, card):
    """Each variant at its float32 main path's shape, with the f32 cells'
    own weights: ms, its plain version's, the PyTorch float32 composition's
    (TF32 off) and the bound (`simple_bound`: the products 4 N H^2 a pass
    as 3 tf32 products each at 495 TFLOP/s; the band's nonzero counts
    times H, the spill, table and acc adds at 67 TFLOP/s; against the
    bytes). Returns {kernel: numbers}."""
    out = {}
    batch, model = fsetup["batch"], fsetup["state"].model
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        weights = model.shared_graphsage_block.fused_weights(x0.dtype)
    n, h = x0.shape
    args, kw, _ = layer_inputs(batch, x0, weights, True, True, True)
    band = args[4]
    nnz = int((band != 0).sum())
    band_ops = 2 * nnz * h
    ms = event_ms(lambda: sl.sage_layer_fwd(*args, **kw))
    bms, bby = simple_bound(
        4 * n * h * h, band_ops + 2 * n * h, *args, kw["table"],
        kw["code"], kw["gwin"], kw["acc_code"],
        extra_bytes=x0.numel() * 4 + kw["table"].numel() * 4)
    out["sage_layer_fwd_simple"] = dict(
        shape="flagship-f32, emit and skip on", ms=ms,
        plain_ms=event_ms(lambda: sl.sage_layer_plain(*args, **kw), reps=5),
        library_ms=event_ms(lambda: library_layer(*args, **kw)),
        bound_ms=bms, bound_by=bby,
        tflops=(4 * n * h * h + band_ops) / ms / 1e9)
    bargs, bkw, _ = bwd_inputs(batch, x0, weights, True, True, True, RATE,
                               seed=5)
    ms = event_ms(lambda: sl.sage_layer_bwd(*bargs, **bkw))
    keep = keep_mask(SEED, n, h, RATE, x0.device)
    bms, bby = simple_bound(
        8 * n * h * h, band_ops + 2 * n * h, *bargs, bkw["table_prev"],
        bkw["code"], bkw["gwin"], bkw["acc_code"],
        extra_bytes=x0.numel() * 4 + (2 * h * h + h) * 4
        + 2 * bkw["t0"] * h * 4)
    out["sage_layer_bwd_simple"] = dict(
        shape="flagship-f32, next layer's star, skip, dropout 0.1", ms=ms,
        plain_ms=event_ms(lambda: sl.sage_layer_bwd_plain(*bargs, **bkw),
                          reps=5),
        library_ms=event_ms(lambda: library_bwd(*bargs, keep=keep, **bkw)),
        bound_ms=bms, bound_by=bby,
        tflops=(8 * n * h * h + band_ops) / ms / 1e9)
    vbatch, vmodel = vfsetup["batch"], vfsetup["state"].model
    with torch.no_grad():
        xv = vmodel.node_encoder(vbatch.nodes)
        vweights = vmodel.shared_graphsage_block.fused_weights(xv.dtype)
    n = xv.shape[0]
    targs, tkw = tile_inputs(vbatch, xv, vweights, True, RATE, seed=41)
    ms = event_ms(lambda: sl.sage_layer_bwd_tile(*targs, **tkw))
    vkeep = keep_mask(SEED, n, h, RATE, xv.device)
    bms, bby = simple_bound(8 * n * h * h, 0, *targs,
                            extra_bytes=2 * xv.numel() * 4
                            + (2 * h * h + h) * 4)
    out["sage_layer_bwd_tile_simple"] = dict(
        shape="virtual-f32, skip, dropout 0.1", ms=ms,
        plain_ms=event_ms(lambda: sl.sage_layer_bwd_tile_plain(
            *targs, **tkw), reps=5),
        library_ms=event_ms(lambda: library_bwd_tile(*targs, keep=vkeep,
                                                     **tkw)),
        bound_ms=bms, bound_by=bby, tflops=8 * n * h * h / ms / 1e9)
    dagg, dxp = sl.sage_layer_bwd_tile(*targs, **tkw)[:2]
    vband = make_agg_context(vbatch).band
    b_args = (vband, dagg)
    b_kw = dict(tile=vbatch.band_tile, width=vbatch.band_width,
                out_dtype=xv.dtype, acc=dxp,
                spill_offsets=vbatch.spill_offsets,
                spill_lo=vbatch.spill_lo, spill_hi=vbatch.spill_hi,
                spill_messages=dagg[vbatch.spill_senders.long()])
    ms = event_ms(lambda: bm.banded_matmul(*b_args, **b_kw))
    msgs = b_kw["spill_messages"]
    bms, bby = simple_bound(
        0, 2 * int((vband != 0).sum()) * h + msgs.numel() + n * h, vband,
        dagg, dxp, msgs, b_kw["spill_offsets"], b_kw["spill_lo"],
        b_kw["spill_hi"], extra_bytes=xv.numel() * 4)
    recv = vbatch.spill_receivers.long()
    out["banded_matmul_simple"] = dict(
        shape="virtual-f32, as the split backward calls it (spill, acc)",
        ms=ms,
        plain_ms=event_ms(lambda: bm.banded_matmul_plain(*b_args, **b_kw),
                          reps=5),
        library_ms=event_ms(lambda: library_banded(*b_args, recv=recv,
                                                   **b_kw)),
        bound_ms=bms, bound_by=bby)
    for k, v in out.items():
        print(json.dumps({"kernel": k, "card": card, **v}))
    return out


# the float32 SAGE step's product passes and the pieces beside them, by
# the substrings of their kernels' names (csrc/wtile.cuh, sage_simple.cu)
SAGE_TILE_PASSES = {"fwd_tile": ("wtile_kernel", "Store"),
                    "dagg_dxp": ("wtile_kernel", "DaggDxp"),
                    "weight_pass": ("wtile_kernel", "DwParts")}
SAGE_TILE_PIECES = {"wsplit_weights": ("wsplit_kernel", "void"),
                    "asplit_dout": ("asplit_kernel",),
                    "weight_pass_sums": ("sum_parts_kernel", "DwParts"),
                    "code_sums_once": ("code_sums_once_kernel",)}


def widths_phase(dev, card, setup, vsetup):
    """Phase 13: kernels #1-#4's float32 and any-width variants
    (csrc/sage_simple.cu) against their plain versions at every (dtype, H)
    of WIDTH_CASES on the flagship and virtual batches, their gates
    catching faults, the flagship-f32 and virtual-f32 cells served and
    trained through them (no engine kernel), and their times. Returns
    (kernel entries for the kernels line, launches by path)."""
    phase_t0 = time.perf_counter()
    batch, vbatch = setup["batch"], vsetup["batch"]
    sbatch = scrambled_spill_batch(dev)
    errs, worst = {k: 0.0 for k in SIMPLE}, {}
    for dtype, h in WIDTH_CASES:
        t0 = time.perf_counter()
        for k, e in variant_checks("widths", batch, vbatch, sbatch, dtype, h,
                                   worst).items():
            errs[k] = max(errs[k], e)
        print(json.dumps({"widths": f"{dtname(dtype)}/h{h}", "card": card,
                          "s": time.perf_counter() - t0}))
    for dtype, h in ((torch.float32, 384), (torch.bfloat16, 640)):
        variant_gates(batch, vbatch, dtype, h)
    simple_fwd_deterministic(batch)
    print(json.dumps({"widths": "float32 error over max|plain|",
                      "card": card, **worst}))

    cells, paths, trains = [], {}, {}
    for label, base, kernels in (
            ("flagship-f32", setup, {"sage_layer_fwd_simple": 1,
                                     "sage_layer_bwd_simple": 1}),
            ("virtual-f32", vsetup, {"sage_layer_fwd_simple": 1,
                                     "sage_layer_bwd_tile_simple": 1,
                                     "banded_matmul_simple": 1})):
        rows = []
        summary, launches, train = unfused_cell(
            label, dev, card, "sage_layer_fwd_simple", kernels,
            cell_data(base), rows_out=rows)
        print(json.dumps(summary))
        # each product pass's share of the step, by the kernel that runs
        # it: 6 layers of 4 N H^2 float32 products a pass, the forward's
        # [agg | x] @ [W_l; W_r], the backward's dagg | dxp and its weight
        # pass, each on wtile_kernel (its epilogue names the pass); the
        # pre-splits (the weights', dout's), the weight pass's partial
        # sums and the code sums beside them
        n, h = train["batch"].n_node_cap, 512
        line = {"sage_tile": label, "card": card,
                "device_ms_per_step": sum(r[1] for r in rows)}
        for name, pats in SAGE_TILE_PASSES.items():
            tms = sum(r[1] for r in rows if all(p in r[0] for p in pats))
            f = 6 * 4 * n * h * h
            line.update({f"{name}_ms_per_step": tms,
                         f"{name}_flops_per_step": f,
                         f"{name}_tflop_per_s": f / tms / 1e9 if tms
                         else None})
        for name, pats in SAGE_TILE_PIECES.items():
            line[f"{name}_ms_per_step"] = sum(
                r[1] for r in rows if all(p in r[0] for p in pats))
        print(json.dumps(line))
        if any("gemm_kernel" in r[0] for r in rows):
            fail(f"{label}: a SAGE product ran on gemm_kernel")
        cells.append(summary)
        paths.update(launches)
        trains[label] = train
    times = variant_timings(trains["flagship-f32"], trains["virtual-f32"],
                            card)
    launches = {"sage_layer_fwd_simple": paths["virtual-f32_train"],
                "sage_layer_bwd_simple": paths["flagship-f32_train"],
                "sage_layer_bwd_tile_simple": paths["virtual-f32_train"],
                "banded_matmul_simple": paths["virtual-f32_train"]}
    replaces = {"sage_layer_fwd_simple": TPU_KERNEL,
                "sage_layer_bwd_simple": TPU_BWD_KERNEL,
                "sage_layer_bwd_tile_simple": TPU_TILE_KERNEL,
                "banded_matmul_simple": TPU_BANDED_KERNEL}
    kernels = [dict({
        "name": k, "route": "cuda", "source": SIMPLE_SOURCE,
        "replaces": replaces[k], "launches": launches[k][k],
        "max_abs_err": errs[k]}, **{f: times[k][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=times[k]["shape"], f32_err_over_max=worst.get(
            "f32_err_over_max")) for k in SIMPLE]
    print(json.dumps({"phase": "widths", "card": card,
                      "s": time.perf_counter() - phase_t0}))
    return kernels, paths


# ---- phase 14: float32 and every H % 128 == 0 for the EA kernels ---------

EA_SIMPLE = ("ea_block_fwd_simple", "ea_block_bwd_simple")
EA_SIMPLE_SOURCE = "buckgnn_tpu_torch/csrc/ea_simple.cu"
# each pass of the variants by the pass its kernels' names carry
EA_SIMPLE_PASS_KERNELS = {p: (f"ea_simple::{p}",)
                          for p in eb.FWD_PASSES + eb.BWD_PASSES}


def ea_variant_shards(ebatch, dtype, h):
    """#5's and #6's variants on shard 0 of the ea-virtual batch split in
    two tile ranges (phase 12's `shard_case`), in 'hybrid' and 'autodiff'
    mode at dropout 0.1: both within their gates against the plain
    versions, the appended far rows' gradient included. Returns the
    largest forward and backward errors."""
    from buckgnn_tpu_torch.parallel.ea_shard import shard_ea_batch

    x_full, e, w, bias = ea_case(ebatch, h, False, 95, dtype)
    g = torch.Generator(device=x_full.device).manual_seed(96)
    dzx = torch.randn(x_full.shape, generator=g,
                      device=x_full.device).to(dtype)
    dze = torch.randn(e.shape, generator=g, device=e.device).to(dtype)
    shards = shard_ea_batch(ebatch, 2).to(ebatch.device)
    kw = dict(skip=True, rate=RATE, seed=SEED, enc=False)
    ferr = berr = 0.0
    for mode in ("hybrid", "autodiff"):
        name = f"ea-widths/{dtname(dtype)}/h{h}/D2/{mode}/shard0"
        ctx, _, x, el, dz, dzel = shard_case(shards, 0, mode, x_full, e, dzx,
                                             dze)
        nl = ctx.n_local
        v = ea_valid(ctx)
        got = once("ea_block_fwd_simple", lambda: eb.ea_block_fwd(
            x, el, w, bias, ctx, save_res=True, **kw))
        ref = eb.ea_block_fwd_plain(x, el, w, bias, ctx, save_res=True, **kw)
        for what, a, r in zip(("zx", "ze", "e1s", "m1s"), got, ref):
            a, r = ((a[:nl], r[:nl]) if what == "zx" else
                    (a.reshape(-1, h)[v], r.reshape(-1, h)[v]))
            ferr = max(ferr, check_close(f"{name}/{what}", a, r,
                                         eb.variant_fwd_tol(r, dtype)))
        args = (dz, dzel, got[2], got[3], x, el, w, bias, ctx)
        gb = once("ea_block_bwd_simple", lambda: eb.ea_block_bwd(*args, **kw))
        rb = eb.ea_block_bwd_plain(*args, **kw)
        berr = max(berr, ea_bwd_errors(name, gb, rb, ctx, h))
        ok, n_err, r_err = remote_rows_check(name, gb, rb, ctx)
        print(json.dumps({"check": f"{name}/remote_rows", "ok": ok,
                          "rel_err": n_err, "row_rel_err": r_err}))
        if not ok:
            fail(f"{name}: the remote rows' gradient disagrees with the "
                 "plain version")
    return ferr, berr


def ea_variant_timings(etrain, card):
    """#5's and #6's float32 variants at the ea-virtual-f32 cell's shape,
    with its model's own weights (layer 1: skip on; the forward also in
    training form and in layer 0's encoder mode): ms, the plain version's,
    the PyTorch float32 composition's (TF32 off) and the bound (3 tf32
    products for each float32 one at 495 TFLOP/s against the bytes,
    `ea_bounds`). Returns {kernel: numbers}."""
    batch, model = etrain["batch"], etrain["state"].model
    ctx = eb.make_ea_context(batch)
    fe = batch.win_edges.shape[2]
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        w, bias = eb.block_weights(model.shared_gn_block, x0.dtype)
        we, biase = eb.block_weights(model.shared_gn_block, x0.dtype,
                                     model.edge_encoder)
    raw = torch.nn.functional.pad(batch.win_edges, (0, eb.ENC_IN - fe)).to(
        x0.dtype).contiguous()
    g = torch.Generator(device=x0.device).manual_seed(97)
    h = x0.shape[1]
    e = torch.randn((*batch.win_sidx.shape, h), generator=g,
                    device=x0.device)
    args = (x0, e, w, bias, ctx)
    fms = event_ms(lambda: eb.ea_block_fwd(*args, skip=True))
    fb_ms, fb_by, bb_ms, bb_by, f_ops, b_ops = ea_bounds(
        x0, e, w, ctx, enc=False, train=False)
    tkw = dict(skip=True, save_res=True, rate=RATE, seed=SEED)
    out = {"ea_block_fwd_simple": dict(
        shape="ea-virtual-f32, layer 1 (skip on)", ms=fms,
        training_ms=event_ms(lambda: eb.ea_block_fwd(*args, **tkw)),
        encoder_training_ms=event_ms(lambda: eb.ea_block_fwd(
            x0, raw, we, biase, ctx, skip=False, save_res=True, rate=RATE,
            seed=SEED, enc=True)),
        plain_ms=event_ms(lambda: eb.ea_block_fwd_plain(*args, skip=True),
                          reps=3),
        library_ms=event_ms(lambda: library_ea_fwd(*args, skip=True)),
        bound_ms=fb_ms, bound_by=fb_by, flops=f_ops,
        tflops=f_ops / fms / 1e9)}
    _, _, e1s, m1s = eb.ea_block_fwd(*args, **tkw)
    dzx = torch.randn(x0.shape, generator=g, device=x0.device)
    dze = torch.randn(e.shape, generator=g, device=x0.device)
    bargs = (dzx, dze, e1s, m1s) + args
    bkw = dict(skip=True, rate=RATE, seed=SEED)
    bms = event_ms(lambda: eb.ea_block_bwd(*bargs, **bkw))
    out["ea_block_bwd_simple"] = dict(
        shape="ea-virtual-f32, layer 1 (skip on), dropout 0.1", ms=bms,
        plain_ms=event_ms(lambda: eb.ea_block_bwd_plain(*bargs, **bkw),
                          reps=3),
        library_ms=event_ms(lambda: library_ea_bwd(*bargs, skip=True)),
        bound_ms=bb_ms, bound_by=bb_by, flops=b_ops,
        tflops=b_ops / bms / 1e9)
    for k, v in out.items():
        print(json.dumps({"kernel": k, "card": card, **v}))
    return out


def ea_widths_phase(dev, card, esetup, etrain):
    """Phase 14: kernels #5 and #6's float32 and any-width variants
    (csrc/ea_simple.cu) against their plain versions at every (dtype, H)
    of WIDTH_CASES on the small ragged EA batches, and in float32 at H 512
    on the ea-virtual batch, in every mode; on a shard of a two-way tile
    split; their gates catching faults; the same bits twice; the
    ea-virtual-f32 cell served and trained through them (no engine
    kernel); their times. Returns (kernel entries for the kernels line,
    launches by path)."""
    phase_t0 = time.perf_counter()
    ebatch = esetup["batch"]
    ectx = eb.make_ea_context(ebatch)
    ragged = []
    for rb in (ea_ragged_batch(dev), ea_ragged_batch(dev, 12, 552),
               ea_ragged_batch(dev, 5, tile=64, align=64)):
        t, wc = rb.win_sidx.shape
        ragged.append((f"ragged-ea/t{t}/w{wc}/n{rb.n_node_cap}", rb,
                       eb.make_ea_context(rb)))
    if not ({(r[1].win_sidx.numel()) % 64 for r in ragged} - {0}
            and any((r[1].n_node_cap // 64) % 2 for r in ragged)):
        fail("the ragged EA batches must end in a partial 64-slot block "
             "and in an odd 64-row block")
    errs = {k: 0.0 for k in EA_SIMPLE}
    worst = {}

    def checks(label, batch, ctx, seed, dtype, h):
        """ea_kernel_checks in ``dtype`` at ``h``, each case launching #5s
        and #6s once and no other kernel."""
        before = launch_counts()
        f, b = ea_kernel_checks(label, batch, ctx, seed, h=h, dtype=dtype,
                                worst=worst)
        torch.cuda.synchronize()
        n = sum(1 for enc, _, _ in EA_CASES if not (enc and h <= eb.ENC_HID))
        expect_launches(f"{label} (checks)", {
            k: v - before[k] for k, v in launch_counts().items()},
            {k: n for k in EA_SIMPLE})
        errs["ea_block_fwd_simple"] = max(errs["ea_block_fwd_simple"], f)
        errs["ea_block_bwd_simple"] = max(errs["ea_block_bwd_simple"], b)

    for dtype, h in WIDTH_CASES:
        t0 = time.perf_counter()
        for label, rb, rctx in ragged:
            checks(f"ea-widths/{label}/{dtname(dtype)}/h{h}", rb, rctx, h,
                   dtype, h)
        print(json.dumps({"ea_widths": f"{dtname(dtype)}/h{h}", "card": card,
                          "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    checks("ea-widths/ea-virtual/f32/h512", ebatch, ectx, 150, torch.float32,
           512)
    ea_f64_checks("ea-widths/ea-virtual", ebatch, ectx, worst)
    for dtype, h in ((torch.float32, 512), (torch.bfloat16, 384)):
        f, b = ea_variant_shards(ebatch, dtype, h)
        errs["ea_block_fwd_simple"] = max(errs["ea_block_fwd_simple"], f)
        errs["ea_block_bwd_simple"] = max(errs["ea_block_bwd_simple"], b)
    for label, rb, rctx in ragged[:2]:
        ea_gates_catch_faults(f"ea-widths/{label}/f32/h384", rb, rctx,
                              torch.float32, 384)
    ea_gates_catch_faults("ea-widths/ea-virtual/f32/h512", ebatch, ectx,
                          torch.float32, 512)
    ea_gates_catch_faults(f"ea-widths/{ragged[1][0]}/bf16/h640", ragged[1][1],
                          ragged[1][2], torch.bfloat16, 640)
    ea_deterministic(f"ea-widths/{ragged[2][0]}", ragged[2][1], ragged[2][2],
                     cases=((torch.float32, 384, True, False),
                            (torch.bfloat16, 640, False, True)))
    ea_deterministic("ea-widths/ea-virtual", ebatch, ectx,
                     cases=((torch.float32, 512, False, True),
                            (torch.float32, 512, True, False)))
    print(json.dumps({"ea_widths": "cell shape, shards, gates", "card": card,
                      "s": time.perf_counter() - t0, **worst}))

    rows = []
    summary, paths, train = unfused_cell(
        "ea-virtual-f32", dev, card, "ea_block_fwd_simple",
        {"ea_block_fwd_simple": 1, "ea_block_bwd_simple": 1},
        cell_data(etrain), rows_out=rows)
    print(json.dumps(summary))
    ea_pass_lines(rows, train["batch"], card, kernels=EA_SIMPLE_PASS_KERNELS,
                  tiles=True, cell="ea-virtual-f32")
    if any("simple::gemm_kernel" in r[0] and "ea_simple::" in r[0]
           and "bwd_weights" not in r[0] for r in rows):
        fail("ea-virtual-f32: an EA product other than the weight pass ran "
             "on gemm_kernel")
    times = ea_variant_timings(train, card)
    launches = paths["ea-virtual-f32_train"]
    replaces = {"ea_block_fwd_simple": TPU_EA_FWD_KERNEL,
                "ea_block_bwd_simple": TPU_EA_BWD_KERNEL}
    kernels = [dict({
        "name": k, "route": "cuda", "source": EA_SIMPLE_SOURCE,
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": errs[k]}, **{f: times[k][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=times[k]["shape"], **worst) for k in EA_SIMPLE]
    print(json.dumps({"phase": "ea_widths", "card": card,
                      "s": time.perf_counter() - phase_t0}))
    return kernels, paths


# ---- phase 12: multi-GPU ---------------------------------------------------

MULTI_EPOCHS = 2  # train_gnn epochs of each banded_partitioned run
MULTI_TIMEOUT_S = 600  # the spawned world's limit
# the DP step against the plain train step, and the partitioned and
# tile-sharded models against the unpartitioned ones, from the same
# weights: bf16 products summed in another order (the dry run's bf16
# parity gates, parallel/dryrun.py)
MULTI_PARITY = (1e-2, 1e-4, 1e-2, 1e-2)


def shard_case(shards, d, mode, x_full, e, dzx, dze):
    """Shard d's inputs to #5 and #6 in ``mode``: its context, its rows,
    those rows extended by the far rows of x_full whose gradient is
    returned, its window and its slices of the cotangents (zero on the
    appended rows)."""
    from buckgnn_tpu_torch.parallel.ea_shard import _ShardView

    fl = shards.cf_local if mode == "hybrid" else 0
    ctx = eb.make_ea_context(_ShardView(shards, d), mode, fl)
    nl, t_l = ctx.n_local, shards.sidx.shape[1]
    rows, tiles = slice(d * nl, (d + 1) * nl), slice(d * t_l, (d + 1) * t_l)
    x = eb.extended_rows(x_full[rows].contiguous(), ctx, x_full)
    dz = torch.zeros_like(x)
    dz[:nl] = dzx[rows]
    return ctx, rows, x, e[tiles].contiguous(), dz, dze[tiles].contiguous()


def remote_rows_check(name, got, ref, ctx):
    """The appended (remote) rows of dx against a reference, by norm and per
    row, at the dx gates; returns (ok, norm error, row error)."""
    nl, n_ext = ctx.n_local, ctx.n_local + ctx.ext_ids.numel()
    a, r = got[0][nl:n_ext], ref[0][nl:n_ext]
    if float(r.float().abs().max()) == 0:
        fail(f"{name}: no remote row carries a gradient")
    errs = (eb.rel_err(a, r), eb.row_rel_err(a, r))
    return (errs[0] <= eb.bwd_tol("dx") and errs[1] <= eb.bwd_tol("dx_row"),
            *errs)


def shard_checks(label, ebatch):
    """Phase 12, step 1, in this process: the ea-virtual batch split into
    D = 2 and 4 tile ranges (parallel/ea_shard.py); on every shard #5 and
    #6 in 'hybrid' mode (and 'autodiff' at D = 2) against their plain
    versions at the EA gates, the appended far rows' gradient included;
    the shards adding up, with no collective, to the unsharded block
    ('fold'): zx and ze concatenated, dx (each shard's rows plus its remote
    rows scattered) and every dW summed; and the gates failing a backward
    that folds the remote rows into the shard's own rows and a forward that
    reads the far rows from the shard's own x. Returns the largest forward
    and backward errors."""
    import dataclasses

    from buckgnn_tpu_torch.parallel.ea_shard import shard_ea_batch

    h = 512
    x_full, e, w, bias = ea_case(ebatch, h, False, 91)
    g = torch.Generator(device=x_full.device).manual_seed(93)
    dzx = torch.randn(x_full.shape, generator=g,
                      device=x_full.device).to(x_full.dtype)
    dze = torch.randn(e.shape, generator=g, device=e.device).to(e.dtype)
    kw = dict(skip=True, rate=0.0, seed=None, enc=False)
    ctx1 = eb.make_ea_context(ebatch)
    one = eb.ea_block_fwd(x_full, e, w, bias, ctx1, save_res=True, **kw)
    one_b = eb.ea_block_bwd(dzx, dze, one[2], one[3], x_full, e, w, bias,
                            ctx1, **kw)
    v1 = ea_valid(ctx1)
    fwd_err = bwd_err = 0.0
    for d_sh in (2, 4):
        t0 = time.perf_counter()
        shards = shard_ea_batch(ebatch, d_sh).to(ebatch.device)
        host_s = time.perf_counter() - t0
        for mode in ("hybrid", "autodiff") if d_sh == 2 else ("hybrid",):
            tag = f"{label}/D{d_sh}/{mode}"
            zxs, zes = [], []
            dx = torch.zeros(x_full.shape, dtype=torch.float32,
                             device=x_full.device)
            dw = {k: 0.0 for k in eb.WKEYS}
            dbias = 0.0
            remote = 0
            for d in range(d_sh):
                ctx, rows, x, el, dz, dzel = shard_case(shards, d, mode,
                                                        x_full, e, dzx, dze)
                nl = ctx.n_local
                remote += ctx.ext_ids.numel()
                v = ea_valid(ctx)
                first = (d_sh, mode, d) == (2, "hybrid", 0)
                # rate 0 last: the sums below take its outputs
                for rate in (RATE, 0.0) if first else (0.0,):
                    name = f"{tag}/shard{d}/rate{rate}"
                    kwr = dict(kw, rate=rate, seed=SEED if rate else None)
                    got = eb.ea_block_fwd(x, el, w, bias, ctx, save_res=True,
                                          **kwr)
                    ref = eb.ea_block_fwd_plain(x, el, w, bias, ctx,
                                                save_res=True, **kwr)
                    for what, a, r in zip(("zx", "ze", "e1s", "m1s"), got,
                                          ref):
                        a, r = ((a[:nl], r[:nl]) if what == "zx" else
                                (a.reshape(-1, h)[v], r.reshape(-1, h)[v]))
                        fwd_err = max(fwd_err, check_close(
                            f"{name}/{what}", a, r,
                            sl.gate_tol(r, eb.KERNEL_FWD_TOL)))
                    args = (dz, dzel, got[2], got[3], x, el, w, bias, ctx)
                    gb = eb.ea_block_bwd(*args, **kwr)
                    rb = eb.ea_block_bwd_plain(*args, **kwr)
                    bwd_err = max(bwd_err, ea_bwd_errors(name, gb, rb, ctx,
                                                         h))
                    ok, n_err, r_err = remote_rows_check(name, gb, rb, ctx)
                    print(json.dumps({"check": f"{name}/remote_rows",
                                      "ok": ok, "rel_err": n_err,
                                      "row_rel_err": r_err}))
                    if not ok:
                        fail(f"{name}: the remote rows' gradient disagrees "
                             "with the plain version")
                    if first and rate == 0.0:
                        folded = eb.ea_block_bwd_plain(*args[:-1], dataclasses
                                                       .replace(ctx, send=(
                            torch.where(ctx.send >= nl, ctx.ext_ids[
                                (ctx.send.long() - nl).clamp_min(0)] % nl,
                                ctx.send).to(torch.int32))), **kwr)
                        caught = not remote_rows_check(name, folded, gb,
                                                       ctx)[0]
                        print(json.dumps({"gate": f"{name}/remote-folded-"
                                          "locally", "caught": caught}))
                        if not caught:
                            fail(f"{name}: the gate lets a backward that "
                                 "folds the remote rows locally pass")
                        own = torch.cat([x[:nl], x[:nl][ctx.ext_ids % nl],
                                         x[ctx.ext_ids.numel() + nl:]])
                        check_caught(f"{name}/far-rows-from-own-x",
                                     eb.ea_block_fwd_plain(
                                         own, el, w, bias, ctx, **kwr)[0][:nl],
                                     got[0][:nl],
                                     sl.gate_tol(got[0][:nl],
                                                 eb.KERNEL_FWD_TOL))
                zxs.append(got[0][:nl])
                zes.append(got[1])
                dx[rows] += gb[0][:nl].float()
                dx.index_add_(0, ctx.ext_ids,
                              gb[0][nl:nl + ctx.ext_ids.numel()].float())
                dw = {k: dw[k] + gb[2][k] for k in dw}
                dbias = dbias + gb[3]
            fwd_err = max(fwd_err, check_close(
                f"{tag}/sum/zx", torch.cat(zxs), one[0],
                sl.gate_tol(one[0], eb.KERNEL_FWD_TOL)))
            ze, ze1 = torch.cat(zes).reshape(-1, h)[v1], \
                one[1].reshape(-1, h)[v1]
            fwd_err = max(fwd_err, check_close(
                f"{tag}/sum/ze", ze, ze1, sl.gate_tol(ze1, eb.KERNEL_FWD_TOL)))
            errs = {"dx": eb.rel_err(dx, one_b[0]),
                    "dx_row": eb.row_rel_err(dx, one_b[0]),
                    "dbias": eb.rel_err(dbias, one_b[3]),
                    **{f"d{k}": eb.rel_err(dw[k], one_b[2][k]) for k in dw}}
            ok = all(v <= eb.bwd_tol(k) for k, v in errs.items())
            print(json.dumps({"check": f"{tag}/sum", "ok": ok,
                              "rel_err": errs, "remote_rows": remote,
                              "cf_local": shards.cf_local,
                              "far_cap": int(shards.far.shape[-1]),
                              "shard_host_s": host_s}))
            if not ok:
                fail(f"{tag}: the shards do not add up to the unsharded "
                     f"block {errs}")
    return fwd_err, bwd_err


def multi_panels():
    """The run phase's flagship panels, and the ea-virtual cell's with 16
    more for validation: ((train, val, normalizer) of each)."""
    panels = generate_dataset(RUN_TRAIN + RUN_VAL, seed=0, min_side=24,
                              max_side=32, use_super_node=True,
                              use_virtual_edges=False)
    train, nz = normalize_dataset(panels[:RUN_TRAIN])
    val, _ = normalize_dataset(panels[RUN_TRAIN:], nz)
    ea = generate_dataset(64, seed=0, min_side=24, max_side=32,
                          use_super_node=False, use_virtual_edges=True)
    ea_val = generate_dataset(16, seed=1, min_side=24, max_side=32,
                              use_super_node=False, use_virtual_edges=True)
    etrain, enz = normalize_dataset(ea)
    eval_, _ = normalize_dataset(ea_val, enz)
    return (train, val, nz), (etrain, eval_, enz)


def partitioned_run(label, cfg, data, out_dir, layers_launches, dev, card):
    """train_gnn(segment_impl="banded_partitioned") for MULTI_EPOCHS on the
    current mesh, its packs' shards recorded; the launches of the kernels
    named in ``layers_launches`` (per layer: (per train step, per val
    batch)) exactly, and no other. Returns (launches, train step ms)."""
    from unittest import mock

    from buckgnn_tpu_torch.parallel import ea_shard as es_mod
    from buckgnn_tpu_torch.train import trainer

    packs, tp_calls = [], [0]
    real_attach, real_tp = trainer.attach_shards, es_mod.ea_tp_stack

    def attach(*a, **k):
        packs.append(real_attach(*a, **k))
        return packs[-1]

    def tp(*a, **k):
        tp_calls[0] += 1
        return real_tp(*a, **k)

    train, val, nz = data
    reset_launch_counts()
    with mock.patch.object(trainer, "MetricsWriter", RecordingWriter), \
            mock.patch.object(trainer, "attach_shards", attach), \
            mock.patch.object(es_mod, "ea_tp_stack", tp):
        res = trainer.train_gnn(cfg, train, val, nz, out_dir,
                                trial_id=label.replace("/", "_"),
                                verbose=False, device=dev)
    torch.cuda.synchronize()
    got = launch_counts()
    check_run(label, res, MULTI_EPOCHS)
    steps, val_batches = len(packs[0]), len(packs[1])
    field = "ea_part" if cfg.model_name.startswith("EA_") else "part"
    if not all(getattr(b, field) is not None for p in packs for b in p):
        fail(f"{label}: a batch without its {field}")
    if field == "ea_part" and tp_calls[0] != MULTI_EPOCHS * (steps +
                                                             val_batches):
        fail(f"{label}: {tp_calls[0]} forwards through ea_tp_stack")
    layers = cfg.num_layers
    expect_launches(
        f"{label} ({MULTI_EPOCHS} epochs of {steps} train steps and "
        f"{val_batches} val batches)", got,
        {k: layers * MULTI_EPOCHS * (s * steps + v * val_batches)
         for k, (s, v) in layers_launches.items()})
    step_ms = RecordingWriter.made[-1].scalars["Perf/train_step_ms"][-1]
    return got, step_ms


def model_copy(cfg, model, impl, dev):
    """A model of ``cfg`` with ``impl``, holding ``model``'s weights."""
    import dataclasses

    from buckgnn_tpu_torch.train.trainer import build_model

    m = build_model(dataclasses.replace(cfg, segment_impl=impl),
                    model.num_node_features, model.num_edge_features,
                    device=dev)
    m.load_state_dict(model.state_dict())
    return m


def unpartitioned_parity(label, setup, impl, batch, pred_tol, readout, dev,
                         dropout=True, grad_dtype=None):
    """The forward and one train step's gradients of ``impl`` on ``batch``
    (carrying its shards) against the setup's unpartitioned model on its
    own batch, from the same weights and dropout seeds (``dropout`` False:
    at rate 0, where the two paths draw their seeds differently). With
    ``grad_dtype`` the gradients are compared on copies of both models
    computing in that dtype."""
    import dataclasses
    from types import SimpleNamespace

    model = setup["state"].model
    dtype = grad_dtype or setup["cfg"].compute_dtype
    if not dropout:
        model.dropout_rate = 0.0
    other = model_copy(setup["cfg"], model, impl, dev)
    other.dropout_rate = model.dropout_rate
    with torch.no_grad():
        want, _ = model(setup["batch"], deterministic=True)
        got, _ = other(batch, deterministic=True)
    g = setup["batch"].graph_mask
    check_close(f"{label}/forward/pred", got[g], want[g], pred_tol)
    if grad_dtype is not None:
        cfg = dataclasses.replace(setup["cfg"], compute_dtype=grad_dtype)
        model = model_copy(cfg, model, model.impl, dev)
        other = model_copy(cfg, other, impl, dev)
        model.dropout_rate = other.dropout_rate
        setup = dict(setup, state=SimpleNamespace(model=model))
    loss, grads = step_grads(setup, 11, readout)
    loss_p, grads_p = step_grads(dict(setup, batch=batch,
                                      state=SimpleNamespace(model=other)),
                                 11, readout)
    check_close(f"{label}/train/loss", loss_p, loss, pred_tol)
    rel = {k: float((grads_p[k].float() - grads[k].float()).norm()
                    / grads[k].float().norm().clamp_min(1e-30))
           for k in grads}
    ok = grads.keys() == grads_p.keys() and max(rel.values()) <= GRAD_TOL
    print(json.dumps({"check": f"{label}/train/grads", "ok": ok,
                      "readout": readout, "dtype": dtype, "tol": GRAD_TOL,
                      "rel_err": rel}))
    if not ok:
        fail(f"{label}: gradients disagree with the unpartitioned path {rel}")


def dp_vs_plain(label, setup, mesh, dev):
    """One DP step against one plain train step, each on a fresh copy of
    the setup's weights at dropout 0: the loss and the update."""
    from buckgnn_tpu_torch.parallel.dp import make_parallel_train_step
    from buckgnn_tpu_torch.parallel.dryrun import (
        _assert_update_parity, _params, _update_fingerprint,
    )
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import (
        make_optimizer, make_train_step,
    )

    cfg, batch = setup["cfg"], setup["batch"]
    crit = get_loss_function(cfg.loss_function)
    out = []
    for dp in (True, False):
        m = model_copy(cfg, setup["state"].model, cfg.segment_impl, dev)
        m.dropout_rate = 0.0
        opt = make_optimizer(cfg, m)
        step = (make_parallel_train_step(m, opt, crit, cfg,
                                         setup["normalizer"], mesh) if dp
                else make_train_step(m, opt, crit, cfg,
                                     setup["normalizer"])[0])
        before = _params(m)
        metrics = step(batch, setup["lr"], None)
        out.append((float(metrics["loss"]),
                    _update_fingerprint(before, _params(m))))
    (loss, fp), (loss_p, fp_p) = out
    ok = abs(loss - loss_p) <= MULTI_PARITY[1] + MULTI_PARITY[0] * abs(loss_p)
    l2, l2_p, cos = _assert_update_parity(label, fp, fp_p, MULTI_PARITY)
    print(json.dumps({"check": f"{label}/dp_vs_plain", "ok": ok, "loss": loss,
                      "plain_loss": loss_p, "update_l2": l2,
                      "plain_update_l2": l2_p, "cos": cos}))
    if not ok:
        fail(f"{label}: the DP step's loss {loss} is not the plain step's "
             f"{loss_p}")


def multi_rank(rank, world, out_dir):
    """Phase 12, step 2, on each rank of the spawned world (one process per
    card, NCCL): the dry run; train_gnn(segment_impl="banded_partitioned")
    at the flagship's config on the run phase's panels and at EA_GNN_Shared
    on the ea-virtual panels; the DP step on the flagship batch (#1 and #2
    on each rank); the partitioned and tile-sharded models and the DP step
    against the unpartitioned paths. Rank 0 returns its readings."""
    import dataclasses
    import os

    from buckgnn_tpu_torch import bench as port_bench
    from buckgnn_tpu_torch.parallel import dryrun
    from buckgnn_tpu_torch.parallel.dp import make_parallel_train_step
    from buckgnn_tpu_torch.parallel.ea_shard import shard_ea_batch
    from buckgnn_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from buckgnn_tpu_torch.parallel.partitioned import partition_batch
    from buckgnn_tpu_torch.train.losses import get_loss_function

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cuda_build.build_all()  # built by the parent: only loaded here
    card = card_line()
    out = dict(world=world, card=card, launches={}, ms={}, s={})

    t0 = time.perf_counter()
    reset_launch_counts()
    dr = dryrun.dryrun_multichip()
    torch.cuda.synchronize()
    out["s"]["dryrun"] = time.perf_counter() - t0
    n_data = dr["mesh"][0]
    ea_l = 2  # the dry run's EA layers: its sharded step, then the oracle
    expect_launches("multi/dryrun", launch_counts(), {
        "epilogue_fwd": 6, "epilogue_bwd": 6,
        "ea_block_fwd": ea_l * (1 + n_data),
        "ea_block_bwd": ea_l * (1 + n_data)})
    out["dryrun"] = dr
    out["launches"]["multi/dryrun"] = launch_counts()

    sage_data, ea_data = multi_panels()
    mesh = make_mesh(1, world)
    runs = (("multi/train_flagship", "flagship", sage_data,
             {"epilogue_fwd": (1, 0), "epilogue_bwd": (1, 0)}),
            ("multi/train_ea", "ea-virtual", ea_data,
             {"ea_block_fwd": (1, 1), "ea_block_bwd": (1, 0)}))
    for label, cell, data, kernels in runs:
        cfg = dataclasses.replace(port_bench.cell_config(cell),
                                  num_epochs=MULTI_EPOCHS,
                                  segment_impl="banded_partitioned")
        t0 = time.perf_counter()
        with set_mesh(mesh):
            got, step_ms = partitioned_run(
                label, cfg, data, os.path.join(out_dir, f"rank{rank}",
                                               label.split("/")[1]),
                kernels, dev, card)
        out["launches"][label] = got
        out["ms"][label] = step_ms
        out["s"][label] = time.perf_counter() - t0

    setup = port_bench.build_train_setup(device=dev)
    dmesh = make_mesh(world, 1)
    step = make_parallel_train_step(
        setup["state"].model, setup["state"].optimizer,
        get_loss_function(setup["cfg"].loss_function), setup["cfg"],
        setup["normalizer"], dmesh)
    batch, gen = setup["batch"], torch.Generator().manual_seed(0)
    reset_launch_counts()
    losses = [float(step(batch, setup["lr"], gen)["loss"])
              for _ in range(3)]
    n_steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m = step(batch, setup["lr"], gen)
    float(m["loss"])
    torch.cuda.synchronize()
    out["ms"]["multi/dp_flagship"] = (time.perf_counter() - t0) / n_steps * 1e3
    if not all(math.isfinite(v) for v in losses):
        fail(f"multi/dp_flagship: non-finite losses {losses}")
    layers = setup["cfg"].num_layers
    expect_launches(f"multi/dp_flagship ({3 + n_steps} steps)",
                    launch_counts(),
                    {"sage_layer_fwd": layers * (3 + n_steps),
                     "sage_layer_bwd": layers * (3 + n_steps)})
    out["launches"]["multi/dp_flagship"] = launch_counts()
    out["dp_losses"] = losses

    # against the unpartitioned paths (the same batch on every rank)
    fresh = port_bench.build_train_setup(device=dev)
    dp_vs_plain("multi/dp_flagship", fresh, dmesh, dev)
    with set_mesh(mesh):
        unpartitioned_parity(
            "multi/partitioned_flagship", dict(
                fresh, state=dataclasses.replace(fresh["state"], model=(
                    model_copy(fresh["cfg"], fresh["state"].model,
                               "banded", dev)))),
            "banded_partitioned",
            fresh["batch"].replace(part=partition_batch(
                fresh["batch"], world).to(dev)), PRED_TOL, False, dev,
            grad_dtype="float32")
        esetup = port_bench.build_train_setup(device=dev,
                                              config="ea-virtual")
        unpartitioned_parity(
            "multi/tp_ea", esetup, "banded_partitioned",
            esetup["batch"].replace(ea_part=shard_ea_batch(
                esetup["batch"], world).to(dev)), EA_PRED_TOL, True, dev,
            dropout=False)
    return out if rank == 0 else None


def multi_phase(dev, card, ebatch):
    """Phase 12: the per-shard kernel checks in this process, the world of
    one process per card, and ``python -m buckgnn_tpu_torch scale``.
    Returns (launches by path, the largest shard errors of #5 and #6)."""
    import os

    from buckgnn_tpu_torch.parallel.scaling import run_world

    phase_t0 = time.perf_counter()
    fwd_err, bwd_err = shard_checks("multi/shards", ebatch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    print(json.dumps({"multi": "world", "world": world, "card": card,
                      "shard_checks_s": time.perf_counter() - phase_t0}))
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        r = run_world(multi_rank, world, args=(out_dir,),
                      timeout=MULTI_TIMEOUT_S)[0]
        world_s = time.perf_counter() - t0
    for label, ms in r["ms"].items():
        print(json.dumps({"multi": label, "world": world, "step_ms": ms,
                          "card": r["card"], "run_s": r["s"].get(label)}))
    print(json.dumps({"multi": "multi/dryrun", "world": world,
                      "card": r["card"], "run_s": r["s"]["dryrun"],
                      **r["dryrun"]}))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "buckgnn_tpu_torch", "scale", "--n-devices",
         str(world)], capture_output=True, text=True, timeout=300, env=env)
    if proc.returncode != 0:
        fail(f"multi/scale exited {proc.returncode}: {proc.stderr[-2000:]}")
    scale = json.loads(proc.stdout.strip().splitlines()[-1])
    if scale["backend"] != "cuda" or scale["n_devices"] != world or \
            set(map(int, scale["per_count"])) != {1, world}:
        fail(f"multi/scale: {scale}")
    print(json.dumps({"multi": "multi/scale", "world": world, "card": card,
                      "run_s": time.perf_counter() - t0, **scale}))
    print(json.dumps({"multi": "phase", "world": world, "world_s": world_s,
                      "phase_s": time.perf_counter() - phase_t0}))
    return r["launches"], (fwd_err, bwd_err)


# ---- phase 15: the host side -------------------------------------------

# segment_softmax_weights on the card against the CPU, in float32: exp
# rounds each term and index_add_'s atomics sum a segment in another order
# than the CPU's loop. Two orders of n float32 additions part by at most
# about 2 (n - 1) 2^-24 of the sum, so each weight, and each non-empty
# segment's total, may part by that share of itself (plus a few ulps of
# exp and the division), n the largest segment. On the flagship batch
# (segments of up to 1,025 nodes and the pad segment) an absolute 1e-6
# failed at 3.46e-6 on an H100. A lost shift, a wrong segment or another
# segment's denominator moves the weights by O(1).
def softmax_tol(n_max):
    return (2 * n_max + 8) * 2.0 ** -24


HOST_SHELL_MESHES = 32  # generate_mesh at 24-32 a side


def cpu_model():
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return None


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def rcm_native_vs_numpy(label, graphs):
    """Native RCM against `_rcm_order_numpy` on the edge sets rcm_reorder
    orders; seconds of each over the panels."""
    from buckgnn_tpu_torch.graph.build import rcm_edges

    edges = [rcm_edges(g) for g in graphs]
    got, native_s = timed(lambda: [native.rcm_order(*e) for e in edges])
    ref, numpy_s = timed(lambda: [native._rcm_order_numpy(*e)
                                  for e in edges])
    bad = [i for i, (a, b) in enumerate(zip(got, ref))
           if not np.array_equal(a, b)]
    if bad:
        fail(f"host/{label}: native RCM differs from NumPy on panels {bad}")
    return edges, got, {"native_s": native_s, "numpy_s": numpy_s}


def band_fractions_agree(label, edges, perms, tile):
    """`band_fraction` native against its NumPy branch on each panel's
    mesh edges under its RCM order, at widths 64, 128 and 256."""
    for i, ((n, s, r), perm) in enumerate(zip(edges, perms)):
        pos = np.empty(n, dtype=np.int64)
        pos[perm] = np.arange(n)
        for width in (64, 128, 256):
            got = native.band_fraction(s, r, pos, n, tile, width)
            ref = native._band_fraction_numpy(s, r, pos, n, tile, width)
            if got != ref:
                fail(f"host/{label}: band_fraction at width {width} on "
                     f"panel {i}: native {got!r}, NumPy {ref!r}")


def harvest_run(run_root, log_dir, cfg, step_ms):
    """utils/harvest.py on the run phase's folder: the run found with its
    train_config.json, its Perf/train_step_ms series the values the run
    phase read, run_index.json and the metric .npz files written."""
    import os

    from buckgnn_tpu_torch.utils import harvest

    runs = {r["run_dir"]: r for r in harvest.find_runs(run_root)}
    run = runs.get(log_dir)
    if run is None:
        fail(f"host/harvest: find_runs missed {log_dir} (found {sorted(runs)})")
    if run["config"] != json.loads(cfg.to_json()):
        fail(f"host/harvest: the run's train_config.json {run['config']}")
    series = harvest.extract_scalars(log_dir)["Perf/train_step_ms"]
    want = np.asarray(step_ms, dtype=np.float64)
    if run["source"] == "tfevents":  # tfevents keep float32 scalars
        want = want.astype(np.float32).astype(np.float64)
    if not (np.array_equal(series[:, 1], want)
            and np.array_equal(series[:, 0], np.arange(len(want)))):
        fail(f"host/harvest: Perf/train_step_ms {series.tolist()}, the run "
             f"phase read {step_ms}")
    out = os.path.join(run_root, "harvested")
    index = harvest.harvest(run_root, out)
    run_id = os.path.basename(log_dir)
    files = sorted(os.listdir(out))
    if (harvest.load_run_index(out) != index or run_id not in index
            or "metric_Perf_train_step_ms.npz" not in files):
        fail(f"host/harvest: index {sorted(index)}, files {files}")
    with np.load(os.path.join(out, "metric_Perf_train_step_ms.npz")) as z:
        if not np.array_equal(z[run_id], series):
            fail("host/harvest: the metric file's series is not the run's")
    return {"runs": len(index), "source": run["source"], "files": files,
            "train_step_ms": series[:, 1].tolist()}


def softmax_on_card(dev, batch):
    """segment_softmax_weights over the flagship batch's graphs (pad nodes
    in the last segment, one segment no node belongs to) on the card
    against the CPU, each weight within `softmax_tol` of itself, and each
    non-empty segment's weights summing to 1 within it."""
    from buckgnn_tpu_torch.ops import segment_softmax_weights

    gen = torch.Generator().manual_seed(15)
    ids = batch.node_graph.cpu()
    num = batch.n_graph_cap + 1
    logits = torch.randn(ids.shape[0], generator=gen) * 4 + 30
    ref = segment_softmax_weights(logits, ids, num)
    got = segment_softmax_weights(logits.to(dev), ids.to(dev), num).cpu()
    counts = torch.bincount(ids.long(), minlength=num)
    tol = softmax_tol(int(counts.max()))
    rel = float(((got - ref).abs() / ref).max())
    sums = torch.zeros(num, dtype=torch.float64).index_add_(
        0, ids.long(), got.double())
    sum_err = float((sums[counts > 0] - 1).abs().max())
    print(json.dumps({"check": "host/segment_softmax_weights: card vs cpu",
                      "max_abs_err": float((got - ref).abs().max()),
                      "max_rel_err": rel, "sum_err": sum_err,
                      "segments": num, "largest": int(counts.max()),
                      "empty": int((counts == 0).sum()), "rtol": tol}))
    if not (rel <= tol and sum_err <= tol and bool(torch.isfinite(got).all())
            and int(counts[-1]) == 0):
        fail(f"host/segment_softmax_weights: card vs cpu {rel} of the "
             f"weight, sums {sum_err} (tol {tol})")
    return float((got - ref).abs().max())


def host_phase(dev, card, setup, vsetup, run_root, run_log, run_cfg,
               run_step_ms):
    """Phase 15: the native library on the packing path and the host
    utilities (see the module docstring). The plots (plot_graph,
    plot_transform_check, MetricPlotter.plot_*) and connectivity_stats /
    virtual_edge_report need matplotlib and networkx, which the card's
    machine does not have: this phase does not call them, and the CPU
    tests hold them to the JAX package."""
    from unittest import mock

    from buckgnn_tpu_torch.graph.build import _shell_edges_numpy
    from buckgnn_tpu_torch.graph.synthetic import generate_mesh
    from buckgnn_tpu_torch.utils import visualization

    if not native.available():
        fail("host: the native library did not load (utils/native.py "
             "falls back to NumPy; this phase does not)")
    flagship, virtual = setup["dataset"], vsetup["dataset"]
    tile = setup["batch"].band_tile
    edges, perms, rcm_s = rcm_native_vs_numpy("flagship", flagship)
    band_fractions_agree("flagship", edges, perms, tile)
    vedges, vperms, vrcm_s = rcm_native_vs_numpy("virtual", virtual)
    band_fractions_agree("virtual", vedges, vperms, tile)

    meshes = [generate_mesh(seed=i, min_side=24, max_side=32)
              for i in range(HOST_SHELL_MESHES)]
    got, shell_native_s = timed(lambda: [
        native.shell_edges_native(m.quads, m.trias) for m in meshes])
    ref, shell_numpy_s = timed(lambda: [_shell_edges_numpy(m)
                                        for m in meshes])
    for i, (a, b) in enumerate(zip(got, ref)):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(f"host/shell_edges: native differs from NumPy on mesh {i}")

    geometry, band_native_s = timed(select_band_geometry, flagship)
    with mock.patch.object(native, "_load", lambda: None):
        geometry_numpy, band_numpy_s = timed(select_band_geometry, flagship)
    if geometry != geometry_numpy:
        fail(f"host/select_band_geometry: native {geometry}, NumPy "
             f"{geometry_numpy}")

    harvested = harvest_run(run_root, run_log, run_cfg, run_step_ms)
    softmax_err = softmax_on_card(dev, setup["batch"])

    names = visualization.get_feature_names(use_super_node=True)
    width = flagship[0].x.shape[1]
    table = visualization.feature_table(flagship[0], flagship[0], names)
    if len(names) != width or not (isinstance(table, str)
                                   and "Max |diff|" in table
                                   and names[0] in table):
        fail(f"host/visualization: {len(names)} feature names for x of "
             f"width {width}, or no table")

    print(json.dumps({
        "host": "the native library on the packing path (128 flagship "
                "panels, 24-32 a side)", "card": card, "cpu": cpu_model(),
        "rcm_flagship_s": rcm_s, "rcm_virtual_s": vrcm_s,
        "select_band_geometry_s": {"native_s": band_native_s,
                                   "numpy_s": band_numpy_s},
        "band_geometry": list(geometry),
        "shell_edges_s": {"native_s": shell_native_s,
                          "numpy_s": shell_numpy_s,
                          "meshes": HOST_SHELL_MESHES},
        "harvest": harvested, "softmax_max_abs_err": softmax_err,
        "feature_names": len(names)}))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    try:
        native_lib = native.build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        fail(f"the native library (csrc/native.cpp, g++) did not build: {e}")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": built, "native_build_s": native_s,
                      "native_lib": native_lib}))
    for name in cuda_build.SOURCES:
        with open(cuda_build.lib_path(name)[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"{name} ptxas: {line.strip()}")

    # ---- flagship setup -------------------------------------------------
    t0 = time.perf_counter()
    setup = build_serve_setup(device=dev)
    batch, model = setup["batch"], setup["model"]
    print(json.dumps({
        "setup_s": time.perf_counter() - t0, "n_node_cap": batch.n_node_cap,
        "n_real_nodes": int(batch.node_mask.sum()),
        "n_edges": setup["n_edges"], "n_graphs": setup["n_graphs"],
        "band_tile": batch.band_tile, "band_width": batch.band_width,
        "local_windows": batch.gwin is not None,
        "spill": batch.has_spill_edges}))
    if batch.gwin is None or batch.has_spill_edges:
        fail("flagship batch must have local star windows and no spill")
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        weights = model.shared_graphsage_block.fused_weights(x0.dtype)

    # ---- 3. kernel vs plain --------------------------------------------
    # the model's bias starts at zero: the checks draw their own weights
    tw = check_weights(x0.shape[1], x0, batch.node_mask, seed=1)
    errs = [
        kernel_vs_plain("flagship/local+emit/skip", batch, x0, tw,
                        True, True, True),
        kernel_vs_plain("flagship/local/noskip", batch, x0, tw,
                        True, False, False),
        kernel_vs_plain("flagship/full-table/skip", batch, x0, tw,
                        False, False, True),
        train_fwd_vs_plain("flagship/local+emit", batch, x0, tw, True, True),
        train_fwd_vs_plain("flagship/full-table", batch, x0, tw, False,
                           False),
    ]
    gate_catches_faults(batch, x0, tw)
    bwd_errs = [
        bwd_vs_plain(f"flagship/local/prev{int(p)}/skip{int(k)}/rate{r}",
                     batch, x0, tw, True, p, k, r)
        for p in (True, False) for k in (True, False) for r in (0.0, RATE)]
    bwd_errs.append(bwd_vs_plain("flagship/full-table/prev1/skip1",
                                 batch, x0, tw, False, True, True, RATE))
    bwd_gate_catches_faults(batch, x0, tw)
    small = normalize_dataset(generate_dataset(
        7, seed=5, min_side=10, max_side=20, use_super_node=True,
        use_virtual_edges=False))[0]
    sb = pack_exact(small, 7, 64, 256, dev)
    with torch.no_grad():
        xs = model.node_encoder(sb.nodes)
    sw = check_weights(xs.shape[1], xs, sb.node_mask, seed=2)
    local = sb.gwin is not None
    rname = f"ragged/n{sb.n_node_cap}"
    errs.append(kernel_vs_plain(f"{rname}/local+emit/skip", sb, xs, sw,
                                local, local, True))
    errs.append(train_fwd_vs_plain(rname, sb, xs, sw, local, local))
    bwd_errs += [bwd_vs_plain(f"{rname}/prev1/skip{int(k)}", sb, xs, sw,
                              local, True, k, RATE) for k in (True, False)]
    bwd_errs.append(bwd_vs_plain(f"{rname}/full-table/prev1/skip1", sb, xs,
                                 sw, False, True, True, RATE))

    # ---- 4a. serving: a main path ----------------------------------------
    sample = setup["dataset"][0]
    tile, width = select_band_geometry([sample])
    serve, serve_launches, timer = serve_path(
        "flagship", setup, timer=lambda counted: time_gnn_forward(
            counted, sample, batch_size=128, n_warmup=2, n_timed=10,
            device=dev, band_kw=dict(band_tile=tile, band_width=width,
                                     rcm=True)))
    print(json.dumps(step_profile(
        "flagship serve step", lambda: setup["eval_step"](batch),
        serve["infer_step_ms"], card)))

    # ---- 4b. training: the flagship train step ---------------------------
    t0 = time.perf_counter()
    train = build_train_setup(device=dev)
    print(json.dumps({"train_setup_s": time.perf_counter() - t0,
                      "dropout_rate": train["state"].model.dropout_rate,
                      "lr": train["lr"],
                      "weight_decay": train["cfg"].weight_decay}))
    bench, losses, train_launches = train_path(
        "flagship", train, {"sage_layer_fwd": 1, "sage_layer_bwd": 1})
    train_vs_plain(train)
    frows = []
    print(json.dumps(step_profile(
        "flagship train step",
        lambda: train["train_step"](train["batch"], train["lr"],
                                    train["generator"]),
        bench["train_step_ms"], card, rows_out=frows)))
    sage_pass_lines("flagship", frows, train["batch"], card)
    flagship_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- 5. the virtual-edge cell: the spill path -------------------------
    t0 = time.perf_counter()
    vsetup = build_serve_setup(device=dev, config="virtual")
    vbatch, vmodel = vsetup["batch"], vsetup["model"]
    print(json.dumps({
        "virtual_setup_s": time.perf_counter() - t0,
        "n_node_cap": vbatch.n_node_cap,
        "n_real_nodes": int(vbatch.node_mask.sum()),
        "n_edges": vsetup["n_edges"], "n_graphs": vsetup["n_graphs"],
        "band_tile": vbatch.band_tile, "band_width": vbatch.band_width,
        "spill_rows": int(vbatch.spill_senders.shape[0]),
        "spill_edges": int((vbatch.spill_receivers
                            != vbatch.n_node_cap - 1).sum()),
        "spill2": vbatch.has_spill2_edges,
        "supernodes": vbatch.has_supernode_edges}))
    if (not vbatch.has_spill_edges or vbatch.has_spill2_edges
            or vbatch.has_supernode_edges):
        fail("the virtual-edge batch must have spill edges, no spill2 "
             "overflow and no supernodes")
    with torch.no_grad():
        xv0 = vmodel.node_encoder(vbatch.nodes)
        vweights = vmodel.shared_graphsage_block.fused_weights(xv0.dtype)
    vw = check_weights(xv0.shape[1], xv0, vbatch.node_mask, seed=3)
    vm = vbatch.node_mask
    # the forward's spill term, serving and training variants
    for skip in (True, False):
        errs.append(fwd_vs_plain(f"virtual/spill/skip{int(skip)}",
                                 *spill_inputs(vbatch, xv0, vw, skip), vm))
    errs.append(train_fwd_checks("virtual/spill",
                                 *spill_inputs(vbatch, xv0, vw, True), vm))
    spill_gates_catch_faults("virtual", vbatch, xv0, vw)
    # the split backward's tile kernel
    tile_errs = [tile_vs_plain(f"virtual/skip{int(k)}/rate{r}", vbatch, xv0,
                               vw, k, r)
                 for k in (True, False) for r in (0.0, RATE)]
    # the banded SpMM: spill window, acc and both, at the virtual shape
    xr = seeded_x(vbatch, xv0.shape[1], seed=31)
    banded_errs = [banded_vs_plain(
        f"virtual/spill{int(sp)}/acc{int(ac)}",
        *banded_inputs(vbatch, xr, 32, sp, False, ac))
        for sp, ac in ((True, False), (False, True), (True, True))]
    banded_gate_catches_faults(
        "virtual", *banded_inputs(vbatch, xr, 33, True, False, True))
    split_kernels_deterministic(vbatch, xv0, vw)
    # small ragged batches: virtual edges at tile 256, and supernodes
    # with spill edges (global star codes in the split backward)
    small = normalize_dataset(generate_dataset(
        7, seed=5, min_side=10, max_side=20, use_super_node=False,
        use_virtual_edges=True))[0]
    rb = pack_exact(small, 7, 64, 256, dev)
    if not rb.has_spill_edges:
        fail("the ragged virtual-edge batch must have spill edges")
    with torch.no_grad():
        xrv = vmodel.node_encoder(rb.nodes)
    rw = check_weights(xrv.shape[1], xrv, rb.node_mask, seed=4)
    rname = f"ragged-virtual/n{rb.n_node_cap}"
    errs.append(fwd_vs_plain(rname, *spill_inputs(rb, xrv, rw, True),
                             rb.node_mask))
    errs.append(train_fwd_checks(rname, *spill_inputs(rb, xrv, rw, True),
                                 rb.node_mask))
    tile_errs.append(tile_vs_plain(rname, rb, xrv, rw, True, RATE))
    banded_errs.append(banded_vs_plain(rname, *banded_inputs(
        rb, seeded_x(rb, xrv.shape[1], 34), 35, True, False, True)))
    sb2 = scrambled_spill_batch(dev)
    xs2 = seeded_x(sb2, xv0.shape[1], seed=36)
    sw2 = check_weights(xs2.shape[1], xs2, sb2.node_mask, seed=5)
    sname = f"super+spill/n{sb2.n_node_cap}"
    errs.append(fwd_vs_plain(sname, *spill_inputs(sb2, xs2, sw2, True),
                             sb2.node_mask))
    errs.append(train_fwd_checks(sname, *spill_inputs(sb2, xs2, sw2, True),
                                 sb2.node_mask))
    tile_errs.append(tile_vs_plain(sname, sb2, xs2, sw2, True, RATE))
    for sp, tb_, ac in ((False, True, False), (True, True, True)):
        banded_errs.append(banded_vs_plain(
            f"{sname}/spill{int(sp)}/table{int(tb_)}/acc{int(ac)}",
            *banded_inputs(sb2, xs2, 37, sp, tb_, ac)))

    vserve, vserve_launches, _ = serve_path("virtual", vsetup)
    print(json.dumps(step_profile(
        "virtual serve step", lambda: vsetup["eval_step"](vbatch),
        vserve["infer_step_ms"], card)))
    t0 = time.perf_counter()
    vtrain = build_train_setup(device=dev, config="virtual")
    print(json.dumps({"virtual_train_setup_s": time.perf_counter() - t0}))
    torch.cuda.reset_peak_memory_stats()
    vbench, vlosses, vtrain_launches = train_path(
        "virtual", vtrain,
        {"sage_layer_fwd": 1, "sage_layer_bwd_tile": 1, "banded_matmul": 1})
    vgrad_err = train_vs_plain(vtrain, "virtual", gen_seeds=(11, 12, 13, 14))
    vrows = []
    print(json.dumps(step_profile(
        "virtual train step",
        lambda: vtrain["train_step"](vtrain["batch"], vtrain["lr"],
                                     vtrain["generator"]),
        vbench["train_step_ms"], card, rows_out=vrows)))
    sage_pass_lines("virtual", vrows, vtrain["batch"], card)
    virtual_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- 6. the EA family: the ea-virtual cell ---------------------------
    t0 = time.perf_counter()
    esetup = build_serve_setup(device=dev, config="ea-virtual")
    ebatch, emodel = esetup["batch"], esetup["model"]
    ectx = eb.make_ea_context(ebatch)
    fe = ebatch.win_edges.shape[2]
    print(json.dumps({
        "ea_setup_s": time.perf_counter() - t0,
        "n_node_cap": ebatch.n_node_cap,
        "n_real_nodes": int(ebatch.node_mask.sum()),
        "n_edges": esetup["n_edges"], "n_graphs": esetup["n_graphs"],
        "band_tile": ebatch.band_tile, "band_width": ebatch.band_width,
        "windows": list(ebatch.win_sidx.shape),
        "far_cap": ebatch.win_far_tsend.shape[1],
        "far_slots": int((ebatch.win_sidx.reshape(-1) >= ebatch.band_tile
                          + ebatch.band_width).sum()
                         - (ectx.recv < 0).sum()),
        "encoder_fused": eb.supports_fused_encoder(ebatch, 512, fe)}))
    if not (eb.supports_fused_ea(ebatch, 512)
            and eb.supports_fused_encoder(ebatch, 512, fe)):
        fail("the ea-virtual batch must take the fused block and encoder")
    ea_fwd_err, ea_bwd_err = ea_kernel_checks("ea-virtual", ebatch, ectx,
                                              seed=51)
    ea_gates_catch_faults("ea-virtual", ebatch, ectx)
    ea_deterministic("ea-virtual", ebatch, ectx)
    for rb, seed in ((ea_ragged_batch(dev), 61),
                     (ea_ragged_batch(dev, 12, 552), 66)):
        rctx = eb.make_ea_context(rb)
        t, wc = rb.win_sidx.shape
        print(json.dumps({"ragged_ea_batch": [t, wc],
                          "slots_in_last_block": (t * wc) % 64 or 64}))
        rf, rbw = ea_kernel_checks(f"ragged-ea/t{t}/w{wc}", rb, rctx, seed)
        ea_fwd_err, ea_bwd_err = max(ea_fwd_err, rf), max(ea_bwd_err, rbw)
    if (t * wc) % 64 not in (16, 32, 48):
        fail("the second ragged EA batch must end in a partial block")
    ea_gates_catch_faults(f"ragged-ea/t{t}/w{wc}", rb, rctx)
    eserve, eserve_launches, _ = serve_path("ea-virtual", esetup,
                                            kernel="ea_block_fwd",
                                            pred_tol=EA_PRED_TOL)
    print(json.dumps(step_profile(
        "ea-virtual serve step", lambda: esetup["eval_step"](ebatch),
        eserve["infer_step_ms"], card)))
    t0 = time.perf_counter()
    etrain = build_train_setup(device=dev, config="ea-virtual")
    print(json.dumps({"ea_train_setup_s": time.perf_counter() - t0}))
    torch.cuda.reset_peak_memory_stats()
    ebench, elosses, etrain_launches = train_path(
        "ea-virtual", etrain, {"ea_block_fwd": 1, "ea_block_bwd": 1})
    egrad_err = train_vs_plain(etrain, "ea-virtual", gen_seeds=(11, 12, 13),
                               pred_tol=EA_PRED_TOL, readout=True)
    ea_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    erows = []
    estep = lambda: etrain["train_step"](etrain["batch"], etrain["lr"],
                                         etrain["generator"])
    print(json.dumps(step_profile("ea-virtual train step", estep,
                                  ebench["train_step_ms"], card,
                                  rows_out=erows)))
    ea_pass_lines(erows, etrain["batch"], card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    estep()
    torch.cuda.synchronize()
    print(json.dumps({"ea_train_step_peak_mem_gb":
                      torch.cuda.max_memory_allocated() / 1e9,
                      "card": card}))

    # ---- 7. kernel timing at the main paths' shapes ----------------------
    args, kw, _ = layer_inputs(batch, x0, weights, True, True, True)
    ms = event_ms(lambda: sl.sage_layer_fwd(*args, **kw))
    plain_ms = event_ms(lambda: sl.sage_layer_plain(*args, **kw), reps=5)
    lib_ms = event_ms(lambda: library_layer(*args, **kw))
    bound_ms, bound_by, flops, nbytes = layer_bound(args, kw)
    # the training variant: residuals and dropout (the bound adds y, agg
    # and inv to the bytes written)
    tkw = dict(kw, save_res=True, rate=RATE, seed=SEED)
    train_ms = event_ms(lambda: sl.sage_layer_fwd(*args, **tkw))
    train_plain_ms = event_ms(lambda: sl.sage_layer_plain(*args, **tkw),
                              reps=5)
    n, h = x0.shape
    fkeep = keep_mask(SEED, n, h, RATE, dev)
    train_lib_ms = event_ms(lambda: library_layer(*args, keep=fkeep, **kw))
    res_bytes = 2 * n * h * x0.element_size() + n * 4
    train_bound_ms = max(flops / PEAK_BF16,
                         (nbytes + res_bytes) / PEAK_BYTES) * 1e3
    bargs, bkw, _ = bwd_inputs(batch, x0, weights, True, True, True, RATE,
                               seed=5)
    bwd_ms = event_ms(lambda: sl.sage_layer_bwd(*bargs, **bkw))
    bwd_plain_ms = event_ms(lambda: sl.sage_layer_bwd_plain(*bargs, **bkw),
                            reps=5)
    keep = keep_mask(SEED, n, h, RATE, dev)
    bwd_lib_ms = event_ms(lambda: library_bwd(*bargs, keep=keep, **bkw))
    bwd_bound_ms, bwd_bound_by, bwd_flops, bwd_bytes = bwd_bound(bargs, bkw)

    # the virtual-edge cell's kernels, with the model's own weights
    recv = vbatch.spill_receivers.long()
    sargs, skw = spill_inputs(vbatch, xv0, vweights, True)
    sp_ms = event_ms(lambda: sl.sage_layer_fwd(*sargs, **skw))
    sp_plain_ms = event_ms(lambda: sl.sage_layer_plain(*sargs, **skw),
                           reps=5)
    sp_lib_ms = event_ms(lambda: library_spill_layer(*sargs, recv=recv,
                                                     **skw))
    sp_bound_ms, sp_bound_by = spill_layer_bound(sargs, skw)
    stkw = dict(skw, save_res=True, rate=RATE, seed=SEED)
    sp_train_ms = event_ms(lambda: sl.sage_layer_fwd(*sargs, **stkw))
    targs, tkw2 = tile_inputs(vbatch, xv0, vweights, True, RATE, seed=41)
    t_ms = event_ms(lambda: sl.sage_layer_bwd_tile(*targs, **tkw2))
    t_plain_ms = event_ms(lambda: sl.sage_layer_bwd_tile_plain(
        *targs, **tkw2), reps=5)
    vkeep = keep_mask(SEED, *xv0.shape, RATE, dev)
    t_lib_ms = event_ms(lambda: library_bwd_tile(*targs, keep=vkeep, **tkw2))
    t_bound_ms, t_bound_by = tile_bound(targs, tkw2)
    # the banded call as the split backward makes it: dagg and dxp of the
    # tile kernel, the spill window of dagg
    dagg, dxp = sl.sage_layer_bwd_tile(*targs, **tkw2)[:2]
    b_args = (make_agg_context(vbatch).band, dagg)
    b_kw = dict(tile=vbatch.band_tile, width=vbatch.band_width,
                out_dtype=torch.bfloat16, acc=dxp,
                spill_offsets=vbatch.spill_offsets,
                spill_lo=vbatch.spill_lo, spill_hi=vbatch.spill_hi,
                spill_messages=dagg[vbatch.spill_senders.long()])
    b_ms = event_ms(lambda: bm.banded_matmul(*b_args, **b_kw))
    b_plain_ms = event_ms(lambda: bm.banded_matmul_plain(*b_args, **b_kw),
                          reps=5)
    b_lib_ms = event_ms(lambda: library_banded(*b_args, recv=recv, **b_kw))
    b_bound_ms, b_bound_by = banded_bound(b_args, b_kw)

    # the EA kernels at the ea-virtual shape, with the model's own weights
    # (layer 1: skip on; layer 0: the encoder mode)
    with torch.no_grad():
        xe0 = emodel.node_encoder(ebatch.nodes)
        ew, ebias = eb.block_weights(emodel.shared_gn_block, xe0.dtype)
        ewe, ebiase = eb.block_weights(emodel.shared_gn_block, xe0.dtype,
                                       emodel.edge_encoder)
    eraw = torch.nn.functional.pad(ebatch.win_edges, (0, eb.ENC_IN - fe)).to(
        torch.bfloat16).contiguous()
    ge = torch.Generator(device=dev).manual_seed(91)
    ee = torch.randn((*ebatch.win_sidx.shape, 512), generator=ge,
                     device=dev).to(torch.bfloat16)
    eargs = (xe0, ee, ew, ebias, ectx)
    ekw = dict(skip=True)
    ea_ms = event_ms(lambda: eb.ea_block_fwd(*eargs, **ekw))
    ea_plain_ms = event_ms(lambda: eb.ea_block_fwd_plain(*eargs, **ekw),
                           reps=3)
    ea_lib_ms = event_ms(lambda: library_ea_fwd(*eargs, **ekw))
    etkw = dict(skip=True, save_res=True, rate=RATE, seed=SEED)
    ea_train_ms = event_ms(lambda: eb.ea_block_fwd(*eargs, **etkw))
    eenc = (xe0, eraw, ewe, ebiase, ectx)
    ea_enc_ms = event_ms(lambda: eb.ea_block_fwd(
        *eenc, skip=False, save_res=True, rate=RATE, seed=SEED, enc=True))
    (ea_bound_ms, ea_bound_by, eab_bound_ms, eab_bound_by, ea_flops,
     eab_flops) = ea_bounds(xe0, ee, ew, ectx, enc=False, train=False)
    ea_train_bound_ms = ea_bounds(xe0, ee, ew, ectx, enc=False,
                                  train=True)[0]
    _, _, e1s, m1s = eb.ea_block_fwd(*eargs, **etkw)
    dzx = torch.randn(xe0.shape, generator=ge, device=dev).to(xe0.dtype)
    dze = torch.randn(ee.shape, generator=ge, device=dev).to(xe0.dtype)
    bargs = (dzx, dze, e1s, m1s) + eargs
    bkw = dict(skip=True, rate=RATE, seed=SEED)
    eab_ms = event_ms(lambda: eb.ea_block_bwd(*bargs, **bkw))
    eab_plain_ms = event_ms(lambda: eb.ea_block_bwd_plain(*bargs, **bkw),
                            reps=3)
    eab_lib_ms = event_ms(lambda: library_ea_bwd(*bargs, skip=True))
    del e1s, m1s, bargs

    # ---- 8. general graphs: the csr-virtual cell and its xla twin --------
    csr_kernels, csr_paths = general_graphs(dev, card)

    # ---- 9. the unfused banded path and the rest of the family ----------
    unfused, spill2_err = unfused_paths(dev, card, setup, vsetup, vtrain,
                                        etrain)

    # ---- 10. the training run and the checkpoint it serves from ---------
    run_root = tempfile.mkdtemp(prefix="chip_smoke_run_")
    run_paths, run_step_ms, run_log, run_cfg = training_run(
        dev, card, bench["train_step_ms"], train["batch"].n_node_cap,
        run_root)

    # ---- 11. the command line on folder datasets -----------------------
    cli_paths, cli_errs = cli_phase(dev, card, run_step_ms)
    errs += cli_errs["sage_layer_fwd"]
    tile_errs += cli_errs["sage_layer_bwd_tile"]
    banded_errs += cli_errs["banded_matmul"]

    # ---- 12. multi-GPU -------------------------------------------------
    multi_paths, (shard_fwd_err, shard_bwd_err) = multi_phase(dev, card,
                                                              ebatch)
    ea_fwd_err = max(ea_fwd_err, shard_fwd_err)
    ea_bwd_err = max(ea_bwd_err, shard_bwd_err)

    # ---- 13. float32 and every H % 128 == 0: the simple variants -------
    width_kernels, width_paths = widths_phase(dev, card, setup, vsetup)

    # ---- 14. the same for the EA kernels: the ea-virtual-f32 cell -------
    ea_width_kernels, ea_width_paths = ea_widths_phase(dev, card, esetup,
                                                       etrain)

    # ---- 15. the host side: the native library, harvest, softmax --------
    host_phase(dev, card, setup, vsetup, run_root, run_log, run_cfg,
               run_step_ms)
    shutil.rmtree(run_root)

    print(json.dumps({
        "serve": "flagship 6L h512 bf16, 128 supernode panels",
        "card": card, "infer_step_ms": serve["infer_step_ms"],
        "infer_samples_per_s": serve["infer_samples_per_s"],
        "infer_edges_per_s": serve["infer_edges_per_s"],
        "n_edges": serve["n_edges"], "n_graphs": serve["n_graphs"],
        "loss": serve["metrics"]["loss"], "mape": serve["metrics"]["mape"],
        "timer_batch_ms": timer["batch_time_s"] * 1e3,
        "timer_samples_per_s": timer["samples_per_s"],
        "timer_latency_per_sample_ms": timer["latency_per_sample_ms"],
        "timer_n_node_cap": timer["n_node_cap"],
        "layer_flops": flops, "layer_bytes": nbytes}))
    print(json.dumps({
        "train": "flagship 6L h512 bf16, 128 supernode panels, dropout 0.1, "
                 "Adam lr 1e-3",
        "card": card, "train_step_ms": bench["train_step_ms"],
        "train_edges_per_s": bench["train_edges_per_s"],
        "n_edges": bench["n_edges"], "n_graphs": bench["n_graphs"],
        "checked_losses": losses, "loss": bench["metrics"]["loss"],
        "mape": bench["metrics"]["mape"], "peak_mem_gb": flagship_peak_gb}))
    print(json.dumps({
        "serve": "virtual 6L h512 bf16, 128 virtual-edge panels (spill)",
        "card": card, "infer_step_ms": vserve["infer_step_ms"],
        "infer_samples_per_s": vserve["infer_samples_per_s"],
        "infer_edges_per_s": vserve["infer_edges_per_s"],
        "n_edges": vserve["n_edges"], "n_graphs": vserve["n_graphs"],
        "loss": vserve["metrics"]["loss"],
        "mape": vserve["metrics"]["mape"],
        "launches": vserve_launches}))
    print(json.dumps({
        "train": "virtual 6L h512 bf16, 128 virtual-edge panels (spill), "
                 "dropout 0.1, Adam lr 1e-3",
        "card": card, "train_step_ms": vbench["train_step_ms"],
        "train_edges_per_s": vbench["train_edges_per_s"],
        "n_edges": vbench["n_edges"], "n_graphs": vbench["n_graphs"],
        "checked_losses": vlosses, "loss": vbench["metrics"]["loss"],
        "mape": vbench["metrics"]["mape"], "grad_rel_err": vgrad_err,
        "launches": vtrain_launches, "peak_mem_gb": virtual_peak_gb}))
    print(json.dumps({
        "kernel": "sage_layer_fwd, training variant (save_res, dropout 0.1)",
        "card": card, "ms": train_ms, "plain_ms": train_plain_ms,
        "bound_ms": train_bound_ms, "library_ms": train_lib_ms,
        "serving_ms": ms}))
    spill_variant = {
        "shape": "virtual-edge cell, skip on", "ms": sp_ms,
        "training_variant_ms": sp_train_ms, "plain_ms": sp_plain_ms,
        "bound_ms": sp_bound_ms, "bound_by": sp_bound_by,
        "library_ms": sp_lib_ms}
    print(json.dumps(dict(kernel="sage_layer_fwd, spill variant", card=card,
                          **spill_variant)))
    print(json.dumps({
        "kernel": "sage_layer_bwd", "card": card, "ms": bwd_ms,
        "plain_ms": bwd_plain_ms, "library_ms": bwd_lib_ms,
        "bound_ms": bwd_bound_ms, "flops": bwd_flops, "bytes": bwd_bytes}))
    print(json.dumps({
        "serve": "ea-virtual: EA_GNN_Shared 6L h512 bf16, 64 virtual-edge "
                 "panels, tile 128 width 64",
        "card": card, "infer_step_ms": eserve["infer_step_ms"],
        "infer_samples_per_s": eserve["infer_samples_per_s"],
        "infer_edges_per_s": eserve["infer_edges_per_s"],
        "n_edges": eserve["n_edges"], "n_graphs": eserve["n_graphs"],
        "loss": eserve["metrics"]["loss"], "mape": eserve["metrics"]["mape"],
        "launches": eserve_launches}))
    print(json.dumps({
        "train": "ea-virtual: EA_GNN_Shared 6L h512 bf16, 64 virtual-edge "
                 "panels, dropout 0.1, Adam lr 1e-3",
        "card": card, "train_step_ms": ebench["train_step_ms"],
        "train_edges_per_s": ebench["train_edges_per_s"],
        "n_edges": ebench["n_edges"], "n_graphs": ebench["n_graphs"],
        "checked_losses": elosses, "loss": ebench["metrics"]["loss"],
        "mape": ebench["metrics"]["mape"], "grad_rel_err": egrad_err,
        "launches": etrain_launches, "peak_mem_gb": ea_peak_gb}))
    print(json.dumps({
        "kernel": "ea_block_fwd variants", "card": card,
        "serving_skip_ms": ea_ms, "training_ms": ea_train_ms,
        "training_bound_ms": ea_train_bound_ms,
        "encoder_training_ms": ea_enc_ms, "flops": ea_flops,
        "bwd_flops": eab_flops}))
    by_path = {"flagship_serve": serve_launches,
               "flagship_train": train_launches,
               "virtual_serve": vserve_launches,
               "virtual_train": vtrain_launches,
               "ea_serve": eserve_launches,
               "ea_train": etrain_launches, **csr_paths, **unfused,
               **run_paths, **cli_paths, **multi_paths, **width_paths,
               **ea_width_paths}
    print(json.dumps({"kernels": [{
        "name": "sage_layer_fwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_fwd.cu",
        "replaces": TPU_KERNEL,
        "launches": vtrain_launches["sage_layer_fwd"],
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "spill_variant": spill_variant,
    }, {
        "name": "sage_layer_bwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_bwd.cu",
        "replaces": TPU_BWD_KERNEL,
        "launches": train_launches["sage_layer_bwd"],
        "max_abs_err": max(bwd_errs), "ms": bwd_ms,
        "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": bwd_lib_ms,
    }, {
        "name": "sage_layer_bwd_tile", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_bwd.cu",
        "replaces": TPU_TILE_KERNEL,
        "launches": vtrain_launches["sage_layer_bwd_tile"],
        "max_abs_err": max(tile_errs), "ms": t_ms, "plain_ms": t_plain_ms,
        "bound_ms": t_bound_ms, "bound_by": t_bound_by,
        "library_ms": t_lib_ms,
    }, {
        "name": "banded_matmul", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/banded_matmul.cu",
        "replaces": TPU_BANDED_KERNEL,
        "launches": vtrain_launches["banded_matmul"],
        "max_abs_err": max(banded_errs + [spill2_err]), "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms, "bound_by": b_bound_by,
        "library_ms": b_lib_ms,
    }, {
        "name": "ea_block_fwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/ea_block_fwd.cu",
        "replaces": TPU_EA_FWD_KERNEL,
        "launches": etrain_launches["ea_block_fwd"],
        "max_abs_err": ea_fwd_err, "ms": ea_ms, "plain_ms": ea_plain_ms,
        "bound_ms": ea_bound_ms, "bound_by": ea_bound_by,
        "library_ms": ea_lib_ms,
    }, {
        "name": "ea_block_bwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/ea_block_bwd.cu",
        "replaces": TPU_EA_BWD_KERNEL,
        "launches": etrain_launches["ea_block_bwd"],
        "max_abs_err": ea_bwd_err, "ms": eab_ms, "plain_ms": eab_plain_ms,
        "bound_ms": eab_bound_ms, "bound_by": eab_bound_by,
        "library_ms": eab_lib_ms,
    }] + csr_kernels + width_kernels + ea_width_kernels,
        "launches_by_path": by_path,
        "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
