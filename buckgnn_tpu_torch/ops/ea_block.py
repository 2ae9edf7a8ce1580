"""Fully fused edge-augmented GraphNetBlock: forward and backward kernels.

The port of buckgnn_tpu/ops/pallas_ea_block.py. One forward call computes
the whole block of Models/BuckGNN.py:528-566 with the stack's skip and
dropout (:103-106), for every edge slot of the receiver-tiled windows and
every node:

    p    = x @ [W_sp | W_er]                     per node -> x.dtype
    e1   = relu(p_r[recv] + p_s[send] + e @ W_ee + b_e0)       -> x.dtype
    e2f  = e1 @ W_e1 + b_e1                      (f32; e2 = x.dtype)
    m1   = relu(p_p[send] + e2 @ W_pe + b_p0)                   -> x.dtype
    sm   = segment sum of m1 over each receiver's slots         -> x.dtype
    agg  = (sm @ W_p1 + cnt * b_p1) / max(cnt, 1)               -> x.dtype
    g1   = relu([x | agg] @ W_g0 + b_g0)                        -> x.dtype
    x1f  = g1 @ W_g1 + b_g1                      (f32; x1 = x.dtype)
    b1   = relu(x1 @ W_b0 + b_b0)                               -> x.dtype
    x2   = x1f + b1 @ W_b1 + b_b1                (f32)
    zx   = dropout(x2 (+ x)),  ze = dropout(e2f (+ e))          -> x.dtype

with W_sp = [W_es | W_px] (the sender parts of edge_mlp and phi), p_s and
p_p its two halves and p_r = x @ W_er. These are the TPU kernel's cast
points (pallas_ea_block.py:165-226), except that p is computed once per
node: the TPU computes it once per slab row, and its slabs overlap. In
encoder mode (layer 0) ``e`` is the raw [T, W, 8] window and the 3-layer
edge encoder (8 -> 128 -> 128 -> H, zero-padded weights, biases in rows
8-10 of the bias stack) runs first, inside the call. ``save_res`` also
returns e1 and m1, the backward's residuals.

Geometry: the batch's windows are flattened to E = T * W slots; an
`EAContext`, built once per forward, gives each slot its global sender
(slab start + offset, or the far table's sender, or -1 for a pad) and
receiver (-1 for a pad), each node its run of slots [rlo, rhi) (slots are
receiver-sorted within a tile) and each node its sender-sorted slots
(``sorder[soff[n]:soff[n+1]]``). Pads reach neither agg nor a gradient.

The backward (`ea_block_bwd`) replays the chain from the stored e1 and
m1 (pallas_ea_block.py:383-657) and returns the folded dx, de_win (not in
encoder mode), every weight gradient and the bias stack's gradient in
float32. The TPU kernel leaves dx as a tile-centre block, a [2*width, H]
halo and a receiver-tiled far table, and XLA folds them (`_fold_dx`); here
each node sums its sender-sorted slots' [de1 | dzm] once, which makes the
halo and far folds one pass: s = sum over the node's slots -> x.dtype,
dx += s @ W_sp^T.

Far-gradient modes (the JAX package's ``far_grad``,
pallas_ea_block.py:815-842, for the tile-sharded stack of
parallel/ea_shard.py, where far senders are global ids into the
replicated x). The TPU kernel returns the receiver-tiled far table's
gradient and XLA folds or returns it; here 'fold' reads every far sender
from x and the sender fold writes its gradient into dx. In 'autodiff'
every far rank of every tile, in 'hybrid' the ranks from ``far_local`` on
(their senders on other shards), instead get a row of their own appended
below the batch's rows, holding that sender's row of ``x_full``: both
kernels run unchanged on the longer x (the slab starts clamped to the
batch's own N), the appended rows are never receivers, so the backward's
sender fold writes exactly their returned gradient there (s @ W_sp^T),
and autograd's index transpose adds it into x_full's gradient. 'hybrid'
finds its local ranks' rows through the sender-sorted fs tables. The plain
versions take the same contexts, so they serve every mode on the CPU.

Dropout: two keep masks per call from the port's hash (ops/dropout.py),
the edge mask on rows 0..E-1 (slot t*W + w) and the node mask on rows
E..E+N-1, so the backward regenerates both from the two seed words. The
words are not the TPU's: the port matches the JAX package at rate 0 only.

`ea_block_fwd` and `ea_block_bwd` launch hand-written kernels on CUDA
tensors, chosen before any launch by ``ops/banded_matmul.py::
kernel_variant``'s static rule on x's (dtype, H), the SAGE kernels' rule:
bf16 at H in {128, 256, 512} takes the product engine's kernels
(csrc/ea_block_fwd.cu, csrc/ea_block_bwd.cu), counted in ``LAUNCHES`` as
"ea_block_fwd" / "ea_block_bwd"; float32 at every H % 128 == 0, and bf16
at the other widths, take the FFMA variants of csrc/ea_simple.cu, counted
as "ea_block_fwd_simple" / "ea_block_bwd_simple"; any other dtype or width
raises a ValueError naming both. A failed build or launch raises: nothing
gives way to another kernel or to the plain version. On CPU tensors they
run the plain versions (`ea_block_fwd_plain`, `ea_block_bwd_plain`), which
take any float dtype. `fused_ea_block` is the block as the model calls it:
weights sliced and cast outside a ``torch.autograd.Function`` (the JAX
package's ``_fused_block`` / ``_fused_block_enc`` custom VJPs), so that
autograd transposes the slicing and sums the tied layers' bf16 weight
gradients in float32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.nn import functional as F

from buckgnn_tpu_torch.ops import ea_windowed as eaw
from buckgnn_tpu_torch.ops.banded_matmul import variant_of, variant_tol
from buckgnn_tpu_torch.ops.dropout import (
    apply_dropout, dropout_scale, dropout_threshold,
)

LAUNCHES = {"ea_block_fwd": 0, "ea_block_bwd": 0, "ea_block_fwd_simple": 0,
            "ea_block_bwd_simple": 0}

WKEYS = ("wer", "wee", "wsp", "we1", "wpe", "wp1", "wg0", "wg1", "wb0",
         "wb1")
ENC_WKEYS = ("wen0", "wen1", "wen2")
ENC_IN = 8     # raw edge-feature lanes of the encoder window
ENC_HID = 128  # the encoder's padded hidden width

# How close the forward kernel's outputs must be to the plain version's on
# the same bf16 inputs, as (atol as a fraction of rms(ref), rtol):
# |got - ref| <= atol * rms(ref) + rtol * |ref| (sage_layer.gate_tol).
# Both sides take the same bf16 products with f32 sums in another order,
# so every bf16 value of the chain (p, e1, e2, m1, sm, agg, g1, x1, b1 and
# the outputs) can round to its neighbour; one ulp is at most 2^-7 of a value, and a flipped value
# early in the chain moves the later ones by its ulp times a weight row:
# rtol 1.6e-2 takes two ulps, and atol 5% of rms(ref) takes a flip carried
# through a product. A forward without its far senders, without the
# cnt * b_p1 term or without the skip moves entries by O(rms) and fails.
KERNEL_FWD_TOL = (5e-2, 1.6e-2)
# The backward kernel against the plain version, as the largest relative
# Frobenius error ||got - ref|| / ||ref|| of each output. Each side
# recomputes the forward's relu masks (of e1, m1, g1, b1) from its own bf16
# values, and a pre-activation within the forward's rounding noise of zero
# can flip its mask: that moves one element by its whole cotangent, so an
# elementwise gate would have to pass errors of rms size. chip_smoke.py on
# an H100 (NVIDIA H100 80GB HBM3, 700 W), at the ea-virtual shape and on
# its 12-tile ragged batch: dx at most 0.23%, de_win 0.11%, the weight and
# bias gradients at most 0.94% (dW_b0, under the most recomputed masks).
# A backward without the slab-overlap (halo) part of dx moves it by 24% at
# the ea-virtual shape, one without the far part by 19% (11% and 4.9% on
# the test batch of tests/test_torch_port_ea_block.py), so dx and de_win
# take 1e-2; the weight and bias gradients 3e-2.
# A norm over a whole tensor cannot see a fault confined to a few rows, so
# dx and de_win are also held row by row ("dx_row", "de_win_row"): the
# largest per-row relative error, `row_rel_err`. A mask flip moves one
# element of a row by its cotangent, which is a larger share of a row than
# of the tensor. chip_smoke.py on the same card, at the ea-virtual shape
# and on both ragged batches: dx at most 5.5% per row, de_win 1.8%. At the
# ea-virtual shape the faults of `sender_faults` that touch a few rows
# (one node's sender run, one far rank, the clamped first tile's halo)
# read 0.39%, 0.24% and 0.82% in dx's norm, which passes, and 81%, 29% and
# 54% per row; so both rows take 0.12, between the two. A weight pass that
# skips one of its 16 row chunks moves dW_b1 by 24%, and a dW_sp without
# the far slots 32%.
KERNEL_BWD_TOL = {"dx": 1e-2, "de_win": 1e-2, "dw": 3e-2, "dx_row": 0.12,
                  "de_win_row": 0.12}
# rows with a norm under this share of the rms row norm are judged against
# that floor (a near-zero row has no scale of its own)
ROW_FLOOR = 0.1
# The float32 variants (csrc/ea_simple.cu) against the float32 plain
# versions. The forward takes bm.variant_tol's float32 gate, SIMPLE_F32_TOL
# of max|ref| per entry (`variant_fwd_tol`): both sides sum the same f32
# products in another order, and a relu input that lands on the other side
# of zero moves its output by no more than its own rounding. On an H100
# (NVIDIA H100 80GB HBM3, 700 W) over the card tests' 114 float32 cases
# (H 128-1024, plain and encoder mode, skip on and off, dropout 0 and 0.1)
# zx, ze, e1 and m1 lay within 1.4e-6 of max|plain|. The backward takes
# the bf16 gates above, KERNEL_BWD_TOL: its error is a relu mask flip, as
# in bf16. The node side's masks (g1, b1) and the encoder's are recomputed
# from f32 sums in another order, and a pre-activation within their
# rounding of zero flips one element by its whole cotangent. In the same
# measurement 11 cases of 114 moved by one such flip, in either path: each
# time one of the two lay within 1.1e-6 of a float64 evaluation of the
# plain version and the other did not, the kernel at most 5.6e-4 from it
# in dx's norm and the plain version 1.1e-3. The worst kernel-vs-plain
# errors: dx 1.1e-3 by norm and 3.0% per row, de_win 2.1e-4 and 0.71%,
# the weights 6.6e-3 (dW_b0), dbias 2.2e-3; without a flip dx lay within
# 2.5e-5 (median 7.2e-7). At the ea-virtual-f32 shape: dx 2.1e-4, 3.0%
# per row.


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| in float32 (inf if got is not finite)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest per-row ||got_r - ref_r|| / max(||ref_r||, ROW_FLOOR *
    rms row norm) of two [rows, H] tensors (inf if got is not finite)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = ref.norm(dim=1)
    floor = ROW_FLOOR * scale.pow(2).mean().sqrt().clamp_min(1e-30)
    return float(((got - ref).norm(dim=1) / scale.clamp_min(floor)).max())


def bwd_errors(got, ref, ctx: EAContext) -> dict[str, float]:
    """Each backward output's reading against a reference: the relative
    norms of dx, de_win (valid slots), every dW ("d" + key) and dbias, and
    the largest per-row relative errors of dx and de_win. ``got`` and
    ``ref`` are (dx, de_win, dw, dbias) as `ea_block_bwd` returns them."""
    pairs = {"dx": (got[0], ref[0])}
    if ref[1] is not None:
        v = ctx.recv >= 0
        h = ref[1].shape[-1]
        pairs["de_win"] = (got[1].reshape(-1, h)[v],
                           ref[1].reshape(-1, h)[v])
    errs = {k: rel_err(a, r) for k, (a, r) in pairs.items()}
    errs.update({f"{k}_row": row_rel_err(a, r) for k, (a, r) in pairs.items()})
    errs.update({f"d{k}": rel_err(got[2][k], ref[2][k]) for k in ref[2]})
    errs["dbias"] = rel_err(got[3], ref[3])
    return errs


def bwd_tol(key: str) -> float:
    """The gate of a `bwd_errors` key (weights and bias take "dw"), for
    either dtype."""
    return KERNEL_BWD_TOL.get(key, KERNEL_BWD_TOL["dw"])


def variant_fwd_tol(ref: torch.Tensor, dtype: torch.dtype
                    ) -> tuple[float, float]:
    """(atol, rtol) of a forward output's gate for a kernel call in
    ``dtype``: bf16 KERNEL_FWD_TOL (atol a share of rms(ref)), float32
    SIMPLE_F32_TOL of max|ref|."""
    return variant_tol(ref, dtype, KERNEL_FWD_TOL)


def sender_faults(batch, ctx: EAContext) -> dict[str, EAContext]:
    """Faulty contexts for the backward's gates, each with some live slots'
    senders dropped (send = -1), so that the plain backward leaves them out
    of the sender fold of dx and of dW_sp (the forward's residuals come in
    whole): the slab-overlap halo (senders in the slab, outside the
    receiver's tile), the far rows, one node's sender run (the sender of the
    middle live slot), one far rank (the most used one of the tile with the
    most far slots) and the first tile's halo (its slab clamped at 0)."""
    tile = batch.band_tile
    slab = tile + batch.band_width
    code = batch.win_sidx.reshape(-1).long()
    live = ctx.send >= 0
    far = live & (code >= slab)
    recv_tile = torch.where(ctx.recv >= 0, ctx.recv // tile, -1)
    halo = live & (ctx.send // tile != recv_tile) & ~far
    slot_tile = torch.arange(ctx.n_slots, device=code.device) // ctx.w_cap
    k = ctx.send[live][int(live.sum()) // 2]
    t = torch.bincount(slot_tile[far], minlength=ctx.n_tiles).argmax()
    far_t = far & (slot_tile == t)
    r = torch.bincount(code[far_t] - slab).argmax() + slab
    drops = {"no-halo": halo, "no-far-fold": far,
             "one-sender-run": ctx.send == k,
             "one-far-rank": far_t & (code == r),
             "clamped-tile-halo": halo & (slot_tile == 0)}
    for name, d in drops.items():
        if not bool(d.any()):
            raise ValueError(f"fault {name}: no slot to drop in this batch")
    return {name: dataclasses.replace(ctx, send=torch.where(d, -1, ctx.send))
            for name, d in drops.items()}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass
class EAContext:
    """Flattened window geometry of one batch (see the module docstring).
    ``send``/``recv``: [E] int32 row ids, -1 for pads; ``rlo``/``rhi``:
    [N] int32 slot runs; ``sorder``: [E] int32 slots sorted by sender (pads
    last), ``soff``: [N + 1] int32; ``cnt``: [N] float32 in-degree (CSR
    row lengths, pad edges included, as the JAX block divides by).

    ``far_grad`` is the far-gradient mode the context was built for
    (`make_ea_context`). In 'hybrid' and 'autodiff' mode the block's rows
    are the batch's ``n_local`` nodes and, below them, the far rows whose
    gradient is returned rather than folded: row n_local + i holds
    x_src[ext_ids[i]], then zero rows up to N, a multiple of 64."""

    n_nodes: int
    n_tiles: int
    w_cap: int
    send: torch.Tensor
    recv: torch.Tensor
    rlo: torch.Tensor
    rhi: torch.Tensor
    sorder: torch.Tensor
    soff: torch.Tensor
    cnt: torch.Tensor
    far_grad: str = "fold"
    far_local: int = 0
    n_local: int | None = None
    ext_ids: torch.Tensor | None = None

    @property
    def n_slots(self) -> int:
        return self.n_tiles * self.w_cap


FAR_GRADS = ("fold", "hybrid", "autodiff")


def _far_senders(batch, rank, far_grad: str, far_local: int, n: int):
    """Each far slot's sender row (``rank``: its far rank, clamped) and the
    ids of the rows appended below the n node rows (None in 'fold' mode).

    'fold': the far table's own ids, rows of x. 'autodiff': every far rank
    (t, r) gets its own appended row n + t * Ct + r. 'hybrid': ranks below
    ``far_local`` have senders in this batch's rows, found through the
    sender-sorted fs tables (entry c of sender tile ts holds the flat rank
    t * Ct + r, and the sender's row in that tile: the fold tables of the
    JAX package's ``_fold_dx``); the rest get appended rows n + t * (Ct -
    far_local) + r - far_local."""
    tsend = batch.win_far_tsend.long()
    n_tiles, ct = tsend.shape
    t = torch.arange(n_tiles, device=tsend.device)[:, None]
    if far_grad == "fold":
        return torch.gather(tsend, 1, rank), None
    if far_grad == "autodiff":
        return n + t * ct + rank, tsend.reshape(-1)
    fl = int(far_local)
    tile = batch.band_tile
    lidx = batch.win_fs_lidx.long()
    valid = lidx < tile
    rows = torch.arange(n_tiles, device=tsend.device)[:, None] * tile + lidx
    local = torch.full((n_tiles * ct,), -1, dtype=torch.long,
                       device=tsend.device)
    local[batch.win_fs_src.long()[valid]] = rows[valid]
    local_ids = torch.gather(local.reshape(n_tiles, ct), 1, rank)
    remote_ids = n + t * (ct - fl) + (rank - fl)
    return (torch.where(rank < fl, local_ids, remote_ids),
            tsend[:, fl:].reshape(-1))


def make_ea_context(batch, far_grad: str = "fold",
                    far_local: int = 0) -> EAContext:
    """The `EAContext` of a windowed batch (built once per forward) for the
    far-gradient mode ``far_grad`` (`fused_ea_block`): 'fold' reads every
    far sender from x and folds its gradient into dx; 'autodiff' reads
    every far sender from an appended row and returns its gradient there;
    'hybrid' does the first for far ranks below ``far_local`` and the
    second for the rest."""
    if far_grad not in FAR_GRADS:
        raise ValueError(f"far_grad {far_grad!r}: one of {FAR_GRADS}")
    tile, _, slab, n_tiles, n = eaw.window_geometry(batch)
    w_cap = batch.win_sidx.shape[1]
    ct = batch.win_far_tsend.shape[1]
    dev = batch.device
    t = torch.arange(n_tiles, device=dev)
    # the slab starts are clamped to the batch's own n - slab, before any
    # row is appended
    starts = eaw.slab_starts(batch)
    code = batch.win_sidx.long()
    in_slab = code < slab
    is_far = (code >= slab) & (code < slab + ct)
    far_ids, ext_ids = _far_senders(batch, (code - slab).clamp(0, ct - 1),
                                    far_grad, far_local, n)
    rows = n
    if ext_ids is not None and ext_ids.numel() == 0:
        ext_ids = None  # 'hybrid' with every far rank local
    if ext_ids is not None:
        rows = n + ((ext_ids.numel() + 63) // 64) * 64
    send = torch.where(in_slab, starts[:, None] + code,
                       torch.where(is_far, far_ids, -1)).reshape(-1)
    ridx = batch.win_ridx.long()
    valid = ridx < tile
    recv = torch.where(valid, t[:, None] * tile + ridx, -1)
    # monotone key over the flat slots: 2 * receiver, and for a tile's
    # trailing pads 2 * (next tile's first node) - 1
    key = torch.where(valid, 2 * recv,
                      2 * (t[:, None] + 1) * tile - 1).reshape(-1)
    nodes2 = 2 * torch.arange(rows, device=dev)
    rlo = torch.searchsorted(key, nodes2)
    rhi = torch.searchsorted(key, nodes2, right=True)
    skey = torch.where(send >= 0, send, rows)
    sorder = torch.argsort(skey, stable=True)
    soff = torch.searchsorted(skey[sorder],
                              torch.arange(rows + 1, device=dev))
    cnt = eaw.window_count(batch)
    if rows > n:
        cnt = torch.cat([cnt, cnt.new_zeros(rows - n)])
    i32 = torch.int32
    return EAContext(n_nodes=rows, n_tiles=n_tiles,
                     w_cap=w_cap, send=send.to(i32),
                     recv=recv.reshape(-1).to(i32), rlo=rlo.to(i32),
                     rhi=rhi.to(i32), sorder=sorder.to(i32),
                     soff=soff.to(i32), cnt=cnt, far_grad=far_grad,
                     far_local=int(far_local) if far_grad == "hybrid" else 0,
                     n_local=n, ext_ids=ext_ids)


# the kernels' passes (csrc/ea_block_fwd.cu, csrc/ea_block_bwd.cu)
FWD_PASSES = ("fwd_proj", "fwd_edge", "fwd_node")
BWD_PASSES = ("bwd_node1", "bwd_edge", "bwd_node2", "bwd_weights")


def pass_flops(n: int, ev: int, h: int, *, enc: bool = False
               ) -> dict[str, int]:
    """Operations (two per multiply-add) of the products each kernel pass
    runs for ``n`` nodes and ``ev`` valid slots at width ``h``, keyed by
    `FWD_PASSES` and `BWD_PASSES`. Products over slots count valid slots
    only (the kernels compute the pads and drop them); the backward counts
    its recomputed forward products. In encoder mode the encoder's layers
    count too, its first (K = 8, f32 FMAs in the kernels) as a product."""
    c = ENC_HID
    hh = h * h
    enc_f = (ENC_IN * c + c * c + c * h) if enc else 0  # encoder forward
    enc_d = (c * h + c * c) if enc else 0  # its data gradients
    enc_w = (c * h + c * c + ENC_IN * c) if enc else 0  # its weights'
    return {
        "fwd_proj": 2 * n * 3 * hh,  # x @ [W_sp | W_er]
        "fwd_edge": 2 * ev * (3 * hh + enc_f),  # W_ee, W_e1, W_pe
        "fwd_node": 2 * n * 6 * hh,  # W_p1, W_g0 (2H in), W_g1, W_b0, W_b1
        # the five recomputed, then W_b1^T, W_b0^T, W_g1^T, W_g0[H:]^T,
        # W_p1^T
        "bwd_node1": 2 * n * 10 * hh,
        # e2, then W_pe^T, W_e1^T, W_ee^T (and the encoder's recompute and
        # data gradients)
        "bwd_edge": 2 * ev * (4 * hh + enc_f + enc_d),
        # W_g0[:H]^T (dxt), W_er^T, W_sp^T (2H in)
        "bwd_node2": 2 * n * 4 * hh,
        # dW over nodes: W_b1, W_b0, W_g1, W_g0 (2), W_p1, W_er, W_sp (2);
        # over slots: W_pe, W_e1, W_ee (and the encoder's three)
        "bwd_weights": 2 * (n * 9 * hh + ev * (3 * hh + enc_w)),
    }


def supports_fused_encoder(batch, h: int, fe: int) -> bool:
    """In-kernel edge-encoder fusion for layer 0: the 3-layer encoder
    (hidden > 128) with at most 8 raw edge features."""
    return supports_fused_ea(batch, h) and h > 128 and fe <= ENC_IN


def supports_fused_ea(batch, h: int) -> bool:
    """Static eligibility of the fused EA block for this batch/width."""
    return (
        eaw.supports_windowed(batch)
        and batch.win_far_tsend is not None
        and h % 128 == 0
        and batch.band_width % 16 == 0
        and batch.band_width <= batch.band_tile
        and batch.n_node_cap % batch.band_tile == 0
    )


def _check_dropout(rate: float, seed) -> None:
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs two seed words")


def _mm(a, b):
    return a.float() @ b.float()


def _gathered(p: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows p[ids] as float32, a zero row where ids < 0."""
    pz = torch.cat([p, p.new_zeros((1, p.shape[1]))])
    idx = torch.where(ids < 0, p.shape[0], ids.long())
    return pz[idx].float()


def _segment(v: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 sums of the rows of v by ids (rows with ids < 0 dropped)."""
    keep = ids >= 0
    out = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=v.device)
    out.index_add_(0, ids[keep].long(), v[keep].float())
    return out


def _encoder(raw, w, bias, dt):
    """The 3-layer edge encoder from the raw [E, 8] window: (h1, h2, e_in)
    in dt, as the TPU kernel's _enc_chain (pallas_ea_block.py:141-163)."""
    c = ENC_HID
    h1 = torch.relu(_mm(raw, w["wen0"]) + bias[8, :c]).to(dt)
    h2 = torch.relu(_mm(h1, w["wen1"]) + bias[9, :c]).to(dt)
    return h1, h2, (_mm(h2, w["wen2"]) + bias[10]).to(dt)


def _node_chain(x, sm, cnt, w, bias, dt):
    """agg, g1, x1f, x1, b1 of the node side, from the bf16 sm."""
    h = x.shape[1]
    deg = cnt.clamp_min(1.0)[:, None]
    agg = ((_mm(sm, w["wp1"]) + cnt[:, None] * bias[3]) / deg).to(dt)
    g1 = torch.relu(_mm(x, w["wg0"][:h]) + _mm(agg, w["wg0"][h:])
                    + bias[4]).to(dt)
    x1f = _mm(g1, w["wg1"]) + bias[5]
    x1 = x1f.to(dt)
    b1 = torch.relu(_mm(x1, w["wb0"]) + bias[6]).to(dt)
    return agg, g1, x1f, x1, b1


def ea_block_fwd_plain(x, e_win, w, bias, ctx: EAContext, *, skip: bool,
                       rate: float = 0.0, seed=None, save_res: bool = False,
                       enc: bool = False):
    """Plain PyTorch version of the fused block forward, with the kernel's
    casts (module docstring). ``x`` [N, H]; ``e_win`` [T, W, H] (or the raw
    [T, W, 8] window in encoder mode); ``w`` the weight dict (``WKEYS``, and
    ``ENC_WKEYS`` in encoder mode) in x.dtype, [in, out]; ``bias`` float32
    [8 or 11, H]. Returns ``(zx, ze)``, with ``save_res`` ``(zx, ze, e1s,
    m1s)``; ze, e1s, m1s [T, W, H] in x.dtype."""
    _check_dropout(rate, seed)
    if enc and skip:
        raise ValueError("encoder mode is layer 0: no skip")
    n, h = x.shape
    dt = x.dtype
    e = ctx.n_slots
    proj = _mm(x, torch.cat([w["wsp"], w["wer"]], 1)).to(dt)
    gs = _gathered(proj[:, :2 * h], ctx.send)
    pr = _gathered(proj[:, 2 * h:], ctx.recv)
    ein = e_win.reshape(e, -1)
    if enc:
        ein = _encoder(ein, w, bias, dt)[2]
    e1 = torch.relu(_mm(ein, w["wee"]) + pr + gs[:, :h] + bias[0]).to(dt)
    e2f = _mm(e1, w["we1"]) + bias[1]
    m1 = torch.relu(_mm(e2f.to(dt), w["wpe"]) + gs[:, h:]
                    + bias[2]).to(dt)
    sm = _segment(m1, ctx.recv, n).to(dt)
    _, _, x1f, _, b1 = _node_chain(x, sm, ctx.cnt, w, bias, dt)
    x2 = x1f + _mm(b1, w["wb1"]) + bias[7]
    if skip:
        x2 = x2 + x.float()
        e2f = e2f + ein.float()
    if rate > 0.0:
        e2f = apply_dropout(e2f, seed, rate)
        x2 = apply_dropout(x2, seed, rate, row0=e)
    zx = x2.to(dt)
    shape = (ctx.n_tiles, ctx.w_cap, h)
    ze = e2f.to(dt).reshape(shape)
    if save_res:
        return zx, ze, e1.reshape(shape), m1.reshape(shape)
    return zx, ze


def ea_block_bwd_plain(dzx, dze, e1s, m1s, x, e_win, w, bias,
                       ctx: EAContext, *, skip: bool, rate: float = 0.0,
                       seed=None, enc: bool = False):
    """Plain PyTorch version of the fused block backward, step by step as
    the TPU kernel (pallas_ea_block.py:475-623) with its casts, from the
    forward's residuals e1s and m1s. Returns ``(dx, de_win, dw, dbias)``:
    dx [N, H] and de_win [T, W, H] (None in encoder mode) in x.dtype; dw a
    dict of float32 gradients of every weight of ``w``; dbias float32 like
    ``bias``. dx holds the folded sender gradient (halo and far rows)."""
    _check_dropout(rate, seed)
    n, h = x.shape
    dt = x.dtype
    e = ctx.n_slots
    z = torch.zeros((), device=x.device)
    ein = e_win.reshape(e, -1)
    raw = ein
    if enc:
        hen1, hen2, ein = _encoder(raw, w, bias, dt)
    e1 = e1s.reshape(e, h)
    m1 = m1s.reshape(e, h)
    e2 = (_mm(e1, w["we1"]) + bias[1]).to(dt)
    sm = _segment(m1, ctx.recv, n).to(dt)
    agg, g1, _, x1, b1 = _node_chain(x, sm, ctx.cnt, w, bias, dt)
    dzx_eff = dzx.float()
    dze_eff = dze.reshape(e, h).float()
    if rate > 0.0:
        dze_eff = apply_dropout(dze_eff, seed, rate)
        dzx_eff = apply_dropout(dzx_eff, seed, rate, row0=e)
    cnt = ctx.cnt[:, None]
    # ---- node side: beta, gamma, the mean and phi's second layer ----
    dx2 = dzx_eff
    dx2_c = dx2.to(dt)
    db1 = _mm(dx2_c, w["wb1"].t())
    dzb_f = torch.where(b1.float() > 0, db1, z)
    dzb = dzb_f.to(dt)
    dx1 = dx2 + _mm(dzb, w["wb0"].t())
    dx1_c = dx1.to(dt)
    dg1 = _mm(dx1_c, w["wg1"].t())
    dzg_f = torch.where(g1.float() > 0, dg1, z)
    dzg = dzg_f.to(dt)
    dxt = _mm(dzg, w["wg0"][:h].t())
    dagg_d = _mm(dzg, w["wg0"][h:].t()) / cnt.clamp_min(1.0)
    dagg_c = dagg_d.to(dt)
    dsm = _mm(dagg_c, w["wp1"].t()).to(dt)
    # ---- edge side ----
    dm1 = _gathered(dsm, ctx.recv)
    dzm_f = torch.where(m1.float() > 0, dm1, z)
    dzm = dzm_f.to(dt)
    de2 = dze_eff + _mm(dzm, w["wpe"].t())
    de2_c = de2.to(dt)
    de1_f = torch.where(e1.float() > 0, _mm(de2_c, w["we1"].t()), z)
    de1 = de1_f.to(dt)
    deo = _mm(de1, w["wee"].t())
    if skip:
        deo = deo + dze_eff
    # ---- the receiver and sender folds into dx ----
    r_de1 = _segment(de1, ctx.recv, n).to(dt)
    s_node = _segment(torch.cat([de1, dzm], 1), ctx.send, n).to(dt)
    dx = (_mm(r_de1, w["wer"].t()) + _mm(s_node, w["wsp"].t())) + dxt
    if skip:
        dx = dx + dzx_eff
    xa = torch.cat([x, agg], 1)
    dw = dict(wb1=_mm(b1.t(), dx2_c), wb0=_mm(x1.t(), dzb),
              wg1=_mm(g1.t(), dx1_c), wg0=_mm(xa.t(), dzg),
              wp1=_mm(sm.t(), dagg_c), wpe=_mm(e2.t(), dzm),
              we1=_mm(e1.t(), de2_c), wee=_mm(ein.t(), de1),
              wer=_mm(x.t(), r_de1), wsp=_mm(x.t(), s_node))
    rows = [de1_f.sum(0), de2.sum(0), dzm_f.sum(0), (cnt * dagg_d).sum(0),
            dzg_f.sum(0), dx1.sum(0), dzb_f.sum(0), dx2.sum(0)]
    de_win = None
    if enc:
        deo_c = deo.to(dt)
        dz2_f = torch.where(hen2.float() > 0, _mm(deo_c, w["wen2"].t()), z)
        dz2 = dz2_f.to(dt)
        dz1_f = torch.where(hen1.float() > 0, _mm(dz2, w["wen1"].t()), z)
        dw.update(wen2=_mm(hen2.t(), deo_c), wen1=_mm(hen1.t(), dz2),
                  wen0=_mm(raw.t(), dz1_f.to(dt)))
        rows += [F.pad(dz1_f.sum(0), (0, h - ENC_HID)),
                 F.pad(dz2_f.sum(0), (0, h - ENC_HID)), deo.sum(0)]
    else:
        de_win = deo.to(dt).reshape(ctx.n_tiles, ctx.w_cap, h)
    return dx.to(dt), de_win, dw, torch.stack(rows)


# ---- the CUDA kernels -----------------------------------------------------

def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused EA block kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _dropout_args(rate: float, seed):
    if rate <= 0.0:
        return 0, 0, 0, 0, 1.0
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return 1, dropout_threshold(rate), s0, s1, dropout_scale(rate)


def _check_common(x, e_win, w, bias, ctx, enc, extra=(), align=32):
    """The operand rules of both variants: every tensor on x's device and
    contiguous, the activations, weights and ``extra`` in x's dtype and
    ``align``-byte aligned (the engine's TMA boxes take 32 bytes, the
    simple variant's vector loads 16), int32 geometry, the float32 bias
    stack and counts, N % 64 == 0 (the kernels' 64-row blocks) and the
    shapes of every operand."""
    n, h = x.shape
    e = ctx.n_slots
    keys = WKEYS + (ENC_WKEYS if enc else ())
    floats = [x, e_win, *(w[k] for k in keys), *extra]
    ints = [ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.sorder, ctx.soff]
    dev = x.device
    for t in floats + ints + [bias, ctx.cnt]:
        _check(t.device == dev, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
    for t in floats:
        _check(t.dtype == x.dtype,
               f"activations/weights in x's dtype ({x.dtype})")
        _check(t.data_ptr() % align == 0, f"{align}-byte aligned operands")
    for t in ints:
        _check(t.dtype == torch.int32, "int32 geometry")
    _check(bias.dtype == torch.float32 and ctx.cnt.dtype == torch.float32,
           "float32 bias stack and counts")
    _check(n % 64 == 0 and n == ctx.n_nodes, "N % 64 == 0, N of the context")
    _check(tuple(bias.shape) == ((11 if enc else 8), h), "bias [8|11, H]")
    shapes = dict(wer=(h, h), wee=(h, h), wsp=(h, 2 * h), we1=(h, h),
                  wpe=(h, h), wp1=(h, h), wg0=(2 * h, h), wg1=(h, h),
                  wb0=(h, h), wb1=(h, h), wen0=(ENC_IN, ENC_HID),
                  wen1=(ENC_HID, ENC_HID), wen2=(ENC_HID, h))
    for k in keys:
        _check(tuple(w[k].shape) == shapes[k], f"{k} {shapes[k]}")
    if enc:
        _check(h > ENC_HID, "encoder mode needs H > 128")
        _check(e_win.numel() == e * ENC_IN, "raw window [T, W, 8]")
    else:
        _check(e_win.numel() == e * h, "edge window [T, W, H]")
    for t, size in ((ctx.send, e), (ctx.recv, e), (ctx.sorder, e),
                    (ctx.rlo, n), (ctx.rhi, n), (ctx.soff, n + 1),
                    (ctx.cnt, n)):
        _check(t.numel() == size, "context sizes")


def block_variant(x: torch.Tensor) -> str:
    """Which kernels a block call on the card with activations like ``x``
    launches (`kernel_variant`): "engine" (csrc/ea_block_{fwd,bwd}.cu) or
    "simple" (csrc/ea_simple.cu); a ValueError naming x's dtype and width
    when no variant takes them."""
    return variant_of(x, _check)


def _variant(x, e_win, w, bias, ctx, enc, extra=()) -> bool:
    """`block_variant`, refused before any launch when no variant takes x,
    then that variant's operand checks. True for the engine."""
    engine = block_variant(x) == "engine"
    _check_common(x, e_win, w, bias, ctx, enc, extra, 32 if engine else 16)
    return engine


def _weight_ptrs(w, enc):
    return ([_ptr(w[k]) for k in WKEYS]
            + [_ptr(w[k]) if enc else _ptr(None) for k in ENC_WKEYS])


def _scratch(lib, name, dev, *dims):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * len(dims)
    nbytes = int(fn(*dims))
    return torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)


def _launch_fwd(x, e_win, w, bias, ctx, *, skip, rate, seed, save_res, enc):
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    _check(not (enc and skip), "encoder mode is layer 0: no skip")
    engine = _variant(x, e_win, w, bias, ctx, enc)
    n, h = x.shape
    e = ctx.n_slots
    shape = (ctx.n_tiles, ctx.w_cap, h)
    zx = torch.empty_like(x)
    ze = torch.empty(shape, dtype=x.dtype, device=x.device)
    # the simple variant always writes e1
    e1s = torch.empty(shape, dtype=x.dtype, device=x.device) \
        if save_res or not engine else None
    m1s = torch.empty(shape, dtype=x.dtype, device=x.device)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    geometry = (ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.cnt)
    ptrs = [_ptr(x), _ptr(e_win), *_weight_ptrs(w, enc), _ptr(bias),
            *map(_ptr, geometry)]
    outs = [_ptr(zx), _ptr(ze), _ptr(e1s), _ptr(m1s)]
    if engine:
        name = "ea_block_fwd"
        lib = cuda_build.load(name)
        scratch = _scratch(lib, "ea_block_fwd_scratch_bytes", x.device, n, e,
                           h, int(enc))
        fn = lib.ea_block_fwd
        fn.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 7
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        args = (*ptrs, _ptr(scratch), *outs, n, e, h, int(enc), int(skip),
                int(save_res), drop, thr, s0, s1, scale, stream)
    else:
        name = "ea_block_fwd_simple"
        bf = int(x.dtype == torch.bfloat16)
        lib = cuda_build.load("ea_simple")
        scratch = _scratch(lib, "ea_block_fwd_simple_scratch_bytes",
                           x.device, n, e, h, int(enc), bf)
        fn = lib.ea_block_fwd_simple
        fn.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 6
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        args = (*ptrs, _ptr(scratch), *outs, n, e, h, int(enc), int(skip),
                drop, thr, s0, s1, scale, bf, stream)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, name)
    if save_res:
        return zx, ze, e1s, m1s
    return zx, ze


def ea_block_fwd(x, e_win, w, bias, ctx: EAContext, *, skip: bool,
                 rate: float = 0.0, seed=None, save_res: bool = False,
                 enc: bool = False):
    """The fused block forward (arguments and results as
    `ea_block_fwd_plain`). CUDA tensors launch the kernel of
    `kernel_variant` (or raise); CPU tensors take the plain version."""
    kw = dict(skip=skip, rate=rate, seed=seed, save_res=save_res, enc=enc)
    if x.device.type == "cuda":
        return _launch_fwd(x, e_win, w, bias, ctx, **kw)
    if x.device.type == "cpu":
        return ea_block_fwd_plain(x, e_win, w, bias, ctx, **kw)
    raise ValueError(f"ea_block_fwd: unsupported device {x.device}")


def _launch_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx, *, skip, rate,
                seed, enc):
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    _check(not (enc and skip), "encoder mode is layer 0: no skip")
    engine = _variant(x, e_win, w, bias, ctx, enc, (dzx, dze, e1s, m1s))
    n, h = x.shape
    e = ctx.n_slots
    _check(tuple(dzx.shape) == (n, h), "dzx [N, H]")
    for t in (dze, e1s, m1s):
        _check(t.numel() == e * h, "dze, e1s, m1s [T, W, H]")
    dev = x.device
    dx = torch.empty_like(x)
    de_win = None if enc else torch.empty(
        (ctx.n_tiles, ctx.w_cap, h), dtype=x.dtype, device=dev)
    keys = WKEYS + (ENC_WKEYS if enc else ())
    dw = {k: torch.empty(w[k].shape, dtype=torch.float32, device=dev)
          for k in keys}
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=dev)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    geometry = (ctx.recv, ctx.rlo, ctx.rhi, ctx.sorder, ctx.soff, ctx.cnt)
    dw_ptrs = [_ptr(dw.get(k)) for k in WKEYS + ENC_WKEYS]
    ptrs = [_ptr(dzx), _ptr(dze), _ptr(e1s), _ptr(m1s), _ptr(x), _ptr(e_win),
            *_weight_ptrs(w, enc), _ptr(bias), *map(_ptr, geometry)]
    outs = [_ptr(dx), _ptr(de_win), *dw_ptrs, _ptr(dbias)]
    argtypes = ([ctypes.c_void_p] * 43 + [ctypes.c_int] * 6
                + [ctypes.c_uint32] * 3)
    if engine:
        name = "ea_block_bwd"
        lib = cuda_build.load(name)
        scratch = _scratch(lib, "ea_block_bwd_scratch_bytes", dev, n, e, h,
                           int(enc))
        fn = lib.ea_block_bwd
        fn.argtypes = argtypes + [ctypes.c_float, ctypes.c_void_p]
        args = (*ptrs, _ptr(scratch), *outs, n, e, h, int(enc), int(skip),
                drop, thr, s0, s1, scale, stream)
    else:
        name = "ea_block_bwd_simple"
        bf = int(x.dtype == torch.bfloat16)
        lib = cuda_build.load("ea_simple")
        scratch = _scratch(lib, "ea_block_bwd_simple_scratch_bytes", dev, n,
                           e, h, int(enc), bf)
        fn = lib.ea_block_bwd_simple
        fn.argtypes = argtypes + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
        args = (*ptrs, _ptr(scratch), *outs, n, e, h, int(enc), int(skip),
                drop, thr, s0, s1, scale, bf, stream)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, name)
    return dx, de_win, dw, dbias


def engine_product(a: torch.Tensor, w: torch.Tensor, *,
                   transpose: bool = False) -> torch.Tensor:
    """The EA kernels' product engine alone (csrc/ea_common.cuh), for its
    card test: float32 ``a @ w`` (w [K, N], read MN-major) or, with
    ``transpose``, ``a @ w.T`` (w [N, K], read K-major), from bf16 CUDA
    tensors; N in (128, 256, 512), K a multiple of 64 up to 512, or 1024
    (first half streamed, second half in the row tile)."""
    from buckgnn_tpu_torch.utils import cuda_build

    m, k = a.shape
    n = w.shape[0] if transpose else w.shape[1]
    _check(a.is_cuda and w.device == a.device, "CUDA tensors")
    _check(a.dtype == w.dtype == torch.bfloat16, "bfloat16 operands")
    _check(a.is_contiguous() and w.is_contiguous(), "contiguous operands")
    _check(tuple(w.shape) == ((n, k) if transpose else (k, n)), "w shape")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = cuda_build.load("ea_block_fwd").ea_engine_product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_ptr(a), _ptr(w), _ptr(out), m, k, n, int(transpose),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ea_engine_product failed: CUDA error {err}")
    return out


def ea_block_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx: EAContext, *,
                 skip: bool, rate: float = 0.0, seed=None, enc: bool = False):
    """The fused block backward (arguments and results as
    `ea_block_bwd_plain`). CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    kw = dict(skip=skip, rate=rate, seed=seed, enc=enc)
    if x.device.type == "cuda":
        return _launch_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx, **kw)
    if x.device.type == "cpu":
        return ea_block_bwd_plain(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx,
                                  **kw)
    raise ValueError(f"ea_block_bwd: unsupported device {x.device}")


# ---- the block as the model calls it --------------------------------------

class _FusedBlock(torch.autograd.Function):
    """The fused block with its custom backward (the JAX package's
    ``_fused_block`` / ``_fused_block_enc`` custom VJPs; in 'hybrid' and
    'autodiff' mode x's appended rows take the far rows' returned
    gradient, `EAContext`).
    Differentiable inputs: x, e_win (not in encoder mode: the raw window is
    data), the bias stack and the weights (in ``spec['keys']`` order). Each
    weight's gradient is cast to the weight's dtype, as ``_cast_dwd``
    (pallas_ea_block.py:107-111) does."""

    @staticmethod
    def forward(ctx_, x, e_win, bias, spec, *weights):
        w = dict(zip(spec["keys"], weights))
        zx, ze, e1s, m1s = ea_block_fwd(x, e_win, w, bias, spec["ctx"],
                                        save_res=True, **spec["kw"])
        ctx_.save_for_backward(x, e_win, bias, e1s, m1s, *weights)
        ctx_.spec = spec
        return zx, ze

    @staticmethod
    def backward(ctx_, dzx, dze):
        x, e_win, bias, e1s, m1s, *weights = ctx_.saved_tensors
        spec = ctx_.spec
        w = dict(zip(spec["keys"], weights))
        dx, de_win, dw, dbias = ea_block_bwd(
            dzx.contiguous(), dze.contiguous(), e1s, m1s, x, e_win, w, bias,
            spec["ctx"], **spec["kw"])
        return (dx, de_win, dbias, None,
                *(dw[k].to(w[k].dtype) for k in spec["keys"]))


def block_weights(block, cdt: torch.dtype, encoder=None, param=None):
    """(w, bias) of a `models.blocks.GraphNetBlock` for the kernels: its
    Dense weights as [in, out] in ``cdt``, sliced into the kernels' dict
    (pallas_ea_block.py:964-1008), and the float32 bias stack; with an
    ``encoder`` (the model's edge_encoder MLP) also the zero-padded encoder
    weights and bias rows 8-10. Built from the parameters under autograd,
    each passed through ``param`` first when given."""
    h = block.hidden_channels
    param = param or (lambda t: t)

    def k(lin):
        return param(lin.weight).t().to(cdt)

    k_e0 = k(block.edge_mlp.lin_0)
    k_p0 = k(block.node_mlp_phi.lin_0)
    w = dict(
        wer=k_e0[:h], wee=k_e0[2 * h:],
        wsp=torch.cat([k_e0[h:2 * h], k_p0[:h]], 1),
        we1=k(block.edge_mlp.lin_1), wpe=k_p0[h:],
        wp1=k(block.node_mlp_phi.lin_1),
        wg0=k(block.node_mlp_gamma.lin_0),
        wg1=k(block.node_mlp_gamma.lin_1),
        wb0=k(block.node_mlp_beta.lin_0),
        wb1=k(block.node_mlp_beta.lin_1))
    rows = [param(m.bias) for m in (
        block.edge_mlp.lin_0, block.edge_mlp.lin_1, block.node_mlp_phi.lin_0,
        block.node_mlp_phi.lin_1, block.node_mlp_gamma.lin_0,
        block.node_mlp_gamma.lin_1, block.node_mlp_beta.lin_0,
        block.node_mlp_beta.lin_1)]
    if encoder is not None:
        k0, k1, k2 = k(encoder.lin_0), k(encoder.lin_1), k(encoder.lin_2)
        fe, c0 = k0.shape
        w.update(wen0=F.pad(k0, (0, ENC_HID - c0, 0, ENC_IN - fe)),
                 wen1=F.pad(k1, (0, 0, 0, ENC_HID - k1.shape[0])), wen2=k2)
        rows += [F.pad(param(encoder.lin_0.bias), (0, h - c0)),
                 F.pad(param(encoder.lin_1.bias), (0, h - ENC_HID)),
                 param(encoder.lin_2.bias)]
    w = {key: v.contiguous() for key, v in w.items()}
    return w, torch.stack(rows).float()


def extended_rows(x, ctx: EAContext, x_full=None):
    """The rows the kernels run on: x, then (in 'hybrid' and 'autodiff'
    mode) the far rows x_src[ctx.ext_ids] whose gradient is returned
    (x_src: ``x_full``, default x) and zero rows up to ctx.n_nodes."""
    if ctx.ext_ids is None:
        return x
    src = x if x_full is None else x_full
    pad = ctx.n_nodes - x.shape[0] - ctx.ext_ids.numel()
    return torch.cat([x, src[ctx.ext_ids], x.new_zeros((pad, x.shape[1]))])


def fused_ea_block(x, e_win, block, ctx: EAContext, *, skip: bool,
                   rate: float = 0.0, seed=None, deterministic: bool = True,
                   encoder=None, far_grad: str = "fold", far_local: int = 0,
                   x_full=None, weights=None):
    """One full GraphNetBlock + skip + dropout (the JAX package's
    ``fused_ea_block``), differentiable in x, e_win and the parameters of
    ``block`` (and of ``encoder``). ``encoder`` (layer 0, requires
    `supports_fused_encoder`): ``e_win`` is then the raw [T, W, fe] window
    and the model's edge_encoder runs inside the call; the raw window
    carries no gradient. ``seed``: two ints, needed when training with
    ``rate`` > 0. Returns ``(zx, ze)``. Requires `supports_fused_ea`.

    ``far_grad`` (the context's mode, `make_ea_context`): 'fold' folds
    every far sender's gradient into dx. 'autodiff' and 'hybrid' (the
    tile-sharded stack, parallel/ea_shard.py) read the far rows they do
    not fold from ``x_full`` (default x) by their ids: the kernels run on
    [x; those rows], and the backward kernel's sender fold writes each
    appended row's gradient, which autograd's index transpose adds into
    x_full's gradient (the JAX package's ``take`` transpose). ``weights``:
    the kernels' (w, bias) of `block_weights`, built by the caller."""
    if far_grad not in FAR_GRADS:
        raise ValueError(f"far_grad {far_grad!r}: one of {FAR_GRADS}")
    fl = int(far_local) if far_grad == "hybrid" else 0
    if (ctx.far_grad, ctx.far_local) != (far_grad, fl):
        raise ValueError(
            f"far_grad {far_grad!r} (far_local {fl}) on a context built for "
            f"{ctx.far_grad!r} (far_local {ctx.far_local})")
    if x_full is not None and far_grad == "fold":
        raise ValueError("x_full needs far_grad 'hybrid' or 'autodiff'")
    rate = float(rate) if not deterministic else 0.0
    _check_dropout(rate, seed)
    enc = encoder is not None
    if enc:
        if skip:
            raise ValueError("encoder fusion is layer 0 (no skip)")
        fe = e_win.shape[2]
        e_win = F.pad(e_win.to(x.dtype), (0, ENC_IN - fe)).contiguous()
    w, bias = weights if weights is not None else block_weights(
        block, x.dtype, encoder)
    n = x.shape[0]
    x = extended_rows(x, ctx, x_full)
    kw = dict(skip=skip, rate=rate, seed=seed, enc=enc)
    keys = WKEYS + (ENC_WKEYS if enc else ())
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or e_win.requires_grad or bias.requires_grad
        or any(w[k].requires_grad for k in keys))
    if not needs_grad:
        zx, ze = ea_block_fwd(x, e_win, w, bias, ctx, **kw)
    else:
        spec = dict(ctx=ctx, kw=kw, keys=keys)
        zx, ze = _FusedBlock.apply(x, e_win, bias, spec,
                                   *(w[k] for k in keys))
    return zx[:n], ze
