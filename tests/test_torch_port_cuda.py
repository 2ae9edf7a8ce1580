"""The CUDA kernels against their plain PyTorch versions, on the card.

The fused layer's forward (with and without the spill term), its merged
backward, the split backward's tile kernel and the banded SpMM with the
spill window, each held to its plain version within its gate; the split
kernels' determinism; and gates that fail a forward or a banded product
without its spill term. The EA kernels' product engine alone
(ea_common.cuh: TMA ring, wgmma) against a float32 matmul for W and W^T
at every width and depth the kernels use. The fused EA block's forward
and backward (ea_block_fwd.cu, ea_block_bwd.cu) on three small ragged
windowed batches (one ends in a partial 64-slot block, one at tile 64
has N % 128 = 64, so its last cluster of two 64-row blocks has an empty
block), in plain and encoder mode, skip on and off, dropout 0 and 0.1;
their determinism; and gates that fail a
forward without its far senders, its cnt * b_p1 term or its skip, a
backward without its halo or far part or wrong in a few rows of dx only,
and a dW_sp without the far slots. The CSR segment sum (csr_segment.cu),
forward and over the transposed CSR, add and mean, bf16 and float32, on a
graph with an 800-degree hub and on a trainer-packed batch whose dead row
owns thousands of pad edges, within its gate, twice the same bits, and
refusing what it does not take; the epilogue kernels (epilogue.cu) bit for
bit against their plain versions with and without the skip; the gates
failing their faults; and the unfused model's launches per train step.
The unfused layers' banded aggregation (ops/banded.py: kernel #4 in its
forward and its symmetric backward, with star terms, the spill window and
spill2) against the same aggregation on the plain band product. The
float32 and any-width variants of #1-#4 (sage_simple.cu): at float32 H in
{128, 384, 512, 640, 1024} and bf16 H in {384, 640, 1024}, the forward
(serving and training, every star case, the spill batches), the merged
backward, the split tile kernel and the banded product (spill, table, acc,
both output types) against their plain versions within the variant gates
(bm.variant_tol), each launch counted under its own name; their gates
failing faults, their determinism and refusals, and the unfused banded
route taking #4's variant for float32 rows and bf16 at H = 384. The
fused EA block's 'hybrid' and 'autodiff' far-gradient modes on the
shards of a tile-split batch (parallel/ea_shard.py): the kernels against
their plain versions, the appended far rows' gradient included.

This file imports only the port (no JAX), so it runs on a machine with a
card and no JAX. The repo's conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Here, with no card, every case skips: the kernels have no CPU mode.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import csr_segment as cs
from buckgnn_tpu_torch.ops import ea_block as eb
from buckgnn_tpu_torch.ops import epilogue as ep
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.dropout import keep_mask
from buckgnn_tpu_torch.ops.banded import make_agg_context

TILE, WIDTH = 128, 64
SEED = (0x1234567, 0x89ABCDEF)
# The gates, with their reasons, are sl.KERNEL_Z_TOL (z, y and agg against
# the plain ones), sl.KERNEL_INV_TOL (inv), sl.KERNEL_TABLE_TOL (the emitted
# table against the plain emission of the kernel's own z) and
# sl.KERNEL_BWD_TOL (the backward's outputs).
Z_ATOL, Z_RTOL = sl.KERNEL_Z_TOL
TAB_ATOL, TAB_RTOL = sl.KERNEL_TABLE_TOL


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# band geometries besides (TILE, WIDTH): (tile, width, N / 64 odd). At tile
# 64 the two 64-row blocks of a kernel cluster lie in two node tiles (their
# slabs differ); with N / 64 odd the last cluster's second block is empty;
# T + W = 112 leaves phase 1's last slab slice half full (K1 % 32 = 16)
GEOMETRIES = {"t64": (64, 48, False), "t64_odd": (64, 48, True)}


def _cap(n, tile, odd):
    """n rounded up to whole tiles, and by one more tile when N / 64 must
    change parity (``odd`` None: as it falls)."""
    ncap = ((n + tile - 1) // tile) * tile
    if odd is not None and (ncap // 64) % 2 != odd:
        ncap += tile
    return ncap


def _batch(dev, supernode=True, geo=(TILE, WIDTH, None)):
    tile, width, odd = geo
    ds = generate_dataset(12, seed=4, min_side=5, max_side=9,
                          use_super_node=supernode, use_virtual_edges=False)
    n = sum(g.n_node for g in ds) + 1
    ncap = _cap(n, tile, odd)
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, 13, band_width=width, band_tile=tile,
                       device="cpu")
    assert not b.has_spill_edges and b.has_supernode_edges == supernode
    assert odd is None or (ncap // 64) % 2 == odd
    return b.to(dev)


def _inputs(n, h, dev, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    w_l = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    # a bias as large as x @ W_r's entries, so a dropped b_l fails the gate
    b_l = rng.normal(size=(h,)).astype(np.float32)
    w_r = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    return [torch.from_numpy(a).to(dev, dtype) for a in (x, w_l, b_l, w_r)]


def _layer(dev, h, star, seed, geo=(TILE, WIDTH, None)):
    """(batch, x, W_l, b_l, W_r, band, star kwargs) for one case; star is
    "local", "local_emit", "full" (the whole table) or "none"."""
    b = _batch(dev, supernode=star != "none", geo=geo)
    if star == "full":
        b = b.replace(gwin=None, lcode=None, lacc=None)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, h, dev, seed=seed)
    kw = {}
    if star != "none":
        code, gwin, gw, acc = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        table = sl._super_tables(x, b.node_graph, b.node_mask,
                                 b.supernode_index, b.n_graph_cap, tg)
        kw.update(table=table, code=code, gwin=gwin, gw=gw, t0=t0,
                  acc_code=acc if star == "local_emit" else None)
    return b, x, w_l, b_l, w_r, make_agg_context(b).band, kw


@pytest.mark.parametrize("h", [128, 256, 512])
@pytest.mark.parametrize("star", ["local_emit", "local", "full", "none"])
@pytest.mark.parametrize("skip", [False, True])
def test_kernel_matches_plain_on_cuda(h, star, skip):
    dev = _card()
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, h, star, seed=h)
    emit = star == "local_emit"
    kw.update(tile=TILE, width=WIDTH, skip=skip, emit=emit)
    before = sl.LAUNCHES["sage_layer_fwd"]
    z, tab = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["sage_layer_fwd"] == before + 1
    zp, _ = sl.sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    m = b.node_mask
    torch.testing.assert_close(z[m].float(), zp[m].float(), atol=Z_ATOL,
                               rtol=Z_RTOL)
    assert (tab is None) == (not emit)
    if emit:
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], TILE)
        torch.testing.assert_close(tab, tabp, atol=TAB_ATOL, rtol=TAB_RTOL)


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("star", ["local_emit", "full", "none"])
def test_training_forward_matches_plain_on_cuda(h, star):
    """The training variant (residuals y, inv, agg; dropout at 0.1, skip
    on): every output within its gate, and the dropped positions are
    exactly those of the hashed keep mask on both sides."""
    dev = _card()
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, h, star, seed=h + 1)
    kw.update(tile=TILE, width=WIDTH, skip=True, emit=star == "local_emit",
              save_res=True, rate=0.1, seed=SEED)
    z, _, y, inv, agg = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    torch.cuda.synchronize()
    zp, _, yp, invp, aggp = sl.sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    m = b.node_mask
    for got, ref, tol in ((z, zp, sl.KERNEL_Z_TOL), (y, yp, sl.KERNEL_Z_TOL),
                          (agg, aggp, sl.KERNEL_Z_TOL),
                          (inv, invp, sl.KERNEL_INV_TOL)):
        torch.testing.assert_close(got[m].float(), ref[m].float(),
                                   atol=tol[0], rtol=tol[1])
    dropped = ~keep_mask(SEED, b.n_node_cap, h, 0.1, dev)
    assert 0.05 < float(dropped.float().mean()) < 0.15
    assert bool((z[dropped] == 0).all()) and bool((zp[dropped] == 0).all())
    # a kept entry the plain version holds above the z gate's atol is kept
    # by the kernel too (one near zero may round to zero on one side only)
    kept_big = ~dropped & (zp.float().abs() > Z_ATOL)
    assert bool((z[kept_big] != 0).all())


def _bwd_case(dev, h, star, apply_prev, skip, rate, seed=7,
              geo=(TILE, WIDTH, None)):
    """Inputs of one backward call: residuals from the kernel's own
    training forward, a random dz and (apply_prev) a random bf16
    next-layer table."""
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, h, star, seed=seed, geo=geo)
    tile, width = b.band_tile, b.band_width
    fwd = dict(kw, tile=tile, width=width, skip=skip, save_res=True,
               rate=rate, seed=SEED if rate else None)
    _, _, y, inv, agg = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **fwd)
    rng = np.random.default_rng(seed + 1)
    dz = torch.from_numpy(rng.normal(size=(b.n_node_cap, h)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bwd = dict(tile=tile, width=width, skip=skip, rate=rate,
               seed=SEED if rate else None, has_super=star != "none")
    if star != "none":
        code, gwin, gw, acc = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        bwd.update(code=code, gwin=gwin, gw=gw, t0=t0, acc_code=acc)
        if apply_prev:
            bwd["table_prev"] = torch.from_numpy(rng.normal(
                size=(tg, h)).astype(np.float32)).to(dev, torch.bfloat16)
    return b, (dz, y, inv, agg, x, w_l, w_r, band), bwd


@pytest.mark.parametrize("h", [128, 256, 512])
@pytest.mark.parametrize("star,apply_prev", [
    ("local", True), ("local", False), ("full", True), ("none", False)])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_kernel_matches_plain_on_cuda(h, star, apply_prev, skip, rate):
    dev = _card()
    b, args, kw = _bwd_case(dev, h, star, apply_prev, skip, rate)
    before = sl.LAUNCHES["sage_layer_bwd"]
    got = sl.sage_layer_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["sage_layer_bwd"] == before + 1
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    m = b.node_mask
    for name, g, r in zip(("dx", "dw_l", "dw_r", "db_l", "town"), got, ref):
        if name == "town" and star == "none":
            assert g is None and r is None
            continue
        if name == "dx":
            g, r = g[m], r[m]
        atol, rtol = sl.gate_tol(r, sl.KERNEL_BWD_TOL[name])
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


def test_bwd_kernel_is_deterministic():
    """No float atomics: two calls on the same inputs give the same bits."""
    dev = _card()
    _, args, kw = _bwd_case(dev, 512, "local", True, True, 0.1)
    first = sl.sage_layer_bwd(*args, **kw)
    second = sl.sage_layer_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_kernel_rejects_what_it_does_not_take():
    """A CUDA tensor the kernels cannot take raises; they never fall back."""
    dev = _card()
    b = _batch(dev, supernode=False)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, 128, dev, seed=0)
    band = make_agg_context(b).band
    with pytest.raises(ValueError, match="bfloat16"):
        sl.sage_layer_fwd(x.float(), w_l, b_l, w_r, band, tile=TILE,
                          width=WIDTH)
    with pytest.raises(ValueError, match="H in"):
        sl.sage_layer_fwd(x[:, :64].contiguous(), w_l[:64, :64].contiguous(),
                          b_l[:64].contiguous(), w_r[:64, :64].contiguous(),
                          band, tile=TILE, width=WIDTH)
    _, args, kw = _bwd_case(dev, 128, "none", False, False, 0.0)
    dz, y, inv, agg = args[:4]
    with pytest.raises(ValueError, match="bfloat16"):
        sl.sage_layer_bwd(dz.float(), *args[1:], **kw)
    with pytest.raises(ValueError, match="inv f32"):
        sl.sage_layer_bwd(dz, y, inv.bfloat16(), *args[3:], **kw)
    with pytest.raises(ValueError, match="dropout needs"):
        sl.sage_layer_bwd(*args, **dict(kw, rate=0.1))


def _spill_batch(dev, kind, geo=(TILE, WIDTH, None)):
    """A small batch with spill edges: "virtual" (virtual edges, no
    supernodes) or "super" (supernode panels with their node order
    scrambled inside each graph, tests/test_fused_layer.py:213-236)."""
    tile, width, odd = geo
    if kind == "virtual":
        ds = generate_dataset(12, seed=2, min_side=5, max_side=9,
                              use_super_node=False, use_virtual_edges=True)
    else:
        rng = np.random.default_rng(1)
        ds = []
        for g in generate_dataset(3, seed=9, min_side=8, max_side=11,
                                  use_super_node=True,
                                  use_virtual_edges=False):
            perm = rng.permutation(g.n_node)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(g.n_node)
            ds.append(dc.replace(
                g, x=g.x[perm], senders=inv[g.senders].astype(np.int32),
                receivers=inv[g.receivers].astype(np.int32),
                supernode=int(inv[g.supernode])))
    n = sum(g.n_node for g in ds) + 1
    ncap = _cap(max(n, tile + width), tile, odd)
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, len(ds) + 1, band_width=width,
                       band_tile=tile, device="cpu")
    assert b.has_spill_edges and not b.has_spill2_edges
    assert odd is None or (ncap // 64) % 2 == odd
    assert b.has_supernode_edges == (kind == "super")
    return b.to(dev)


def _spill_kw(b, rows):
    return dict(spill_offsets=b.spill_offsets, spill_lo=b.spill_lo,
                spill_hi=b.spill_hi,
                spill_messages=rows[b.spill_senders.long()].contiguous())


def _spill_layer(dev, h, kind, seed, geo=(TILE, WIDTH, None)):
    """(batch, layer args, kwargs) of one forward with the spill term."""
    b = _spill_batch(dev, kind, geo)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, h, dev, seed=seed)
    kw = dict(tile=b.band_tile, width=b.band_width, **_spill_kw(b, x))
    if kind == "super":
        code, gwin, gw, _ = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        kw.update(table=sl._super_tables(x, b.node_graph, b.node_mask,
                                         b.supernode_index, b.n_graph_cap,
                                         tg),
                  code=code, gwin=gwin, gw=gw, t0=t0)
    return b, (x, w_l, b_l, w_r, make_agg_context(b).band), kw


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("kind", ["virtual", "super"])
@pytest.mark.parametrize("train", [False, True])
def test_spill_forward_matches_plain_on_cuda(h, kind, train):
    """The forward with its spill term, serving and training variants (skip
    on; dropout 0.1 in training): every output within its gate."""
    dev = _card()
    b, args, kw = _spill_layer(dev, h, kind, seed=h + 2)
    kw["skip"] = True
    if train:
        kw.update(save_res=True, rate=0.1, seed=SEED)
    got = sl.sage_layer_fwd(*args, **kw)
    torch.cuda.synchronize()
    ref = sl.sage_layer_plain(*args, **kw)
    m = b.node_mask
    pairs = [(got[0], ref[0], sl.KERNEL_Z_TOL)]
    if train:
        pairs += [(got[2], ref[2], sl.KERNEL_Z_TOL),
                  (got[4], ref[4], sl.KERNEL_Z_TOL),
                  (got[3], ref[3], sl.KERNEL_INV_TOL)]
    for g, r, tol in pairs:
        torch.testing.assert_close(g[m].float(), r[m].float(), atol=tol[0],
                                   rtol=tol[1])


def test_spill_gate_catches_a_forward_without_spill():
    """The z gate fails the kernel's own z held against a plain forward
    that leaves the spill term out."""
    dev = _card()
    b, args, kw = _spill_layer(dev, 512, "virtual", seed=5)
    z, _ = sl.sage_layer_fwd(*args, **kw)
    no_spill = {k: v for k, v in kw.items() if not k.startswith("spill")}
    zp, _ = sl.sage_layer_plain(*args, **no_spill)
    m = b.node_mask
    err = (z[m].float() - zp[m].float()).abs()
    assert bool((err > Z_ATOL + Z_RTOL * zp[m].float().abs()).any())


def _tile_case(dev, h, kind, skip, rate, seed=11, geo=(TILE, WIDTH, None)):
    """Inputs of one split tile call: residuals of the kernel's own spill
    forward, a random dz, and (supernode batch) the global codes."""
    b, args, kw = _spill_layer(dev, h, kind, seed=seed, geo=geo)
    _, _, y, inv, agg = sl.sage_layer_fwd(
        *args, **dict(kw, skip=skip, save_res=True, rate=rate,
                      seed=SEED if rate else None))
    rng = np.random.default_rng(seed + 1)
    dz = torch.from_numpy(rng.normal(size=(b.n_node_cap, h)).astype(
        np.float32)).to(dev, torch.bfloat16)
    x, w_l, _, w_r, _ = args
    _, tg = tb.star_table_geometry(b.n_graph_cap)
    tkw = dict(tile=b.band_tile, skip=skip, rate=rate,
               seed=SEED if rate else None,
               acc_code=b.gacc if kind == "super" else None, tg=tg)
    return b, (dz, y, inv, agg, x, w_l, w_r), tkw


TILE_NAMES = ("dagg", "dxp", "dw_l", "dw_r", "db_l", "tbwd")


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("kind", ["virtual", "super"])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_tile_kernel_matches_plain_on_cuda(h, kind, skip, rate):
    dev = _card()
    b, args, kw = _tile_case(dev, h, kind, skip, rate)
    before = sl.LAUNCHES["sage_layer_bwd_tile"]
    got = sl.sage_layer_bwd_tile(*args, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["sage_layer_bwd_tile"] == before + 1
    ref = sl.sage_layer_bwd_tile_plain(*args, **kw)
    m = b.node_mask
    for name, g, r in zip(TILE_NAMES, got, ref):
        if name == "tbwd" and kind == "virtual":
            assert g is None and r is None
            continue
        if name in ("dagg", "dxp"):
            g, r = g[m], r[m]
        atol, rtol = sl.gate_tol(r, sl.KERNEL_BWD_TOL[name])
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda s: f"{name}: {s}")


def _banded_case(dev, h, seed=13, geo=(TILE, WIDTH, None)):
    """(batch, band, x, options) on the supernode + spill batch: x and the
    table random bf16, the batch's own spill ranges and global codes."""
    b = _spill_batch(dev, "super", geo)
    rng = np.random.default_rng(seed)
    n = b.n_node_cap
    _, tg = tb.star_table_geometry(b.n_graph_cap)
    x, acc = (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    table = torch.from_numpy(rng.normal(size=(tg, h)).astype(
        np.float32)).to(dev, torch.bfloat16)
    opts = dict(spill=_spill_kw(b, x), table=dict(gcode=b.gcode, table=table),
                acc=dict(acc=acc))
    return b, make_agg_context(b).band, x, opts


def _options(opts, spill, table, acc):
    kw = {}
    for on, name in ((spill, "spill"), (table, "table"), (acc, "acc")):
        if on:
            kw.update(opts[name])
    return kw


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("spill,table,acc", [
    (True, False, False), (False, True, False), (False, False, True),
    (True, True, True), (False, False, False)])
def test_banded_kernel_matches_plain_on_cuda(h, spill, table, acc):
    dev = _card()
    b, band, x, opts = _banded_case(dev, h)
    kw = dict(tile=TILE, width=WIDTH, out_dtype=torch.bfloat16,
              **_options(opts, spill, table, acc))
    before = sl.LAUNCHES["banded_matmul"]
    got = bm.banded_matmul(band, x, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["banded_matmul"] == before + 1
    ref = bm.banded_matmul_plain(band, x, **kw)
    atol, rtol = sl.gate_tol(ref, bm.KERNEL_BANDED_TOL)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_banded_kernel_float32_output():
    """With a float32 output both sides keep the f32 sums: the same values
    up to f32 summation order (1e-5 relative to the output's rms)."""
    dev = _card()
    b, band, x, opts = _banded_case(dev, 256)
    kw = dict(tile=TILE, width=WIDTH, out_dtype=torch.float32,
              **_options(opts, True, True, True))
    got = bm.banded_matmul(band, x, **kw)
    ref = bm.banded_matmul_plain(band, x, **kw)
    rms = float(ref.pow(2).mean().sqrt())
    torch.testing.assert_close(got, ref, atol=1e-5 * rms, rtol=1e-5)


def test_banded_gate_catches_dropped_spill():
    """bm.KERNEL_BANDED_TOL fails the kernel's output held against a plain
    product without the spill messages."""
    dev = _card()
    b, band, x, opts = _banded_case(dev, 512)
    got = bm.banded_matmul(band, x, tile=TILE, width=WIDTH,
                           out_dtype=torch.bfloat16,
                           **_options(opts, True, True, True))
    wrong = bm.banded_matmul_plain(band, x, tile=TILE, width=WIDTH,
                                   out_dtype=torch.bfloat16,
                                   **_options(opts, False, True, True))
    atol, rtol = sl.gate_tol(wrong, bm.KERNEL_BANDED_TOL)
    err = (got.float() - wrong.float()).abs()
    assert bool((err > atol + rtol * wrong.float().abs()).any())


def test_split_kernels_are_deterministic():
    """No float atomics: two calls of the tile kernel and of the banded
    kernel on the same inputs give the same bits."""
    dev = _card()
    _, args, kw = _tile_case(dev, 512, "super", True, 0.1)
    first = sl.sage_layer_bwd_tile(*args, **kw)
    second = sl.sage_layer_bwd_tile(*args, **kw)
    _, band, x, opts = _banded_case(dev, 512)
    bkw = dict(tile=TILE, width=WIDTH, out_dtype=torch.bfloat16,
               **_options(opts, True, True, True))
    out1 = bm.banded_matmul(band, x, **bkw)
    out2 = bm.banded_matmul(band, x, **bkw)
    torch.cuda.synchronize()
    for a, c in zip(first + (out1,), second + (out2,)):
        assert torch.equal(a, c)


def test_split_kernels_reject_what_they_do_not_take():
    dev = _card()
    _, band, x, opts = _banded_case(dev, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        bm.banded_matmul(band, x.half(), tile=TILE, width=WIDTH)
    with pytest.raises(ValueError, match="int8"):
        bm.banded_matmul(band.float(), x, tile=TILE, width=WIDTH)
    _, args, kw = _tile_case(dev, 128, "virtual", False, 0.0)
    with pytest.raises(ValueError, match="dropout needs"):
        sl.sage_layer_bwd_tile(*args, **dict(kw, rate=0.1))
    with pytest.raises(ValueError, match="bfloat16"):
        sl.sage_layer_bwd_tile(args[0].float(), *args[1:], **kw)


# ---- the fused SAGE kernels on the product engine: band and clusters -------

@pytest.mark.parametrize("h", [128, 256, 512])
@pytest.mark.parametrize("tile,width", [(128, 64), (64, 48), (128, 48)])
def test_band_product_matches_dense_on_cuda(h, tile, width):
    """The band product alone (the band kernel, csrc/banded.cuh, through
    bm.banded_matmul with no spill, table or acc and a float32 output: the
    int8 band converted into the swizzled A tile by #1's phase-1 code, the
    slab streamed through the ring) against torch.matmul of the dense bf16
    band [N, N] with x, at every width: T + W = 112 and 176 leave the last
    slab slice half empty (K1 % 32 = 16), and the first and last tiles'
    slabs are clamped; at tile 64, N / 64 = 9 is odd, so the last cluster
    has an empty block. Both sides sum exact products of small counts and
    bf16 values in float32 in another order (differences ~1e-6 at unit
    scale); a wrong swizzle offset or slice moves entries by O(1)."""
    dev = _card()
    rng = np.random.default_rng(h + tile + width)
    n, s = 9 * tile, tile + width
    band = torch.from_numpy(rng.integers(0, 4, size=(n // tile, tile, s))
                            .astype(np.int8))
    x = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(
        dev, torch.bfloat16)
    starts = bm.slab_starts(n, tile, width, "cpu").tolist()
    assert starts[0] == 0 and starts[-1] == n - s
    dense = torch.zeros((n, n))
    for t, st in enumerate(starts):
        dense[t * tile:(t + 1) * tile, st:st + s] = band[t].float()
    got = bm.banded_matmul(band.to(dev), x, tile=tile, width=width,
                           out_dtype=torch.float32)
    ref = dense.to(dev) @ x.float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("spill,table,acc", [
    (True, True, True), (False, False, True), (True, False, False)])
def test_banded_kernel_on_cluster_geometries_on_cuda(geo, h, spill, table,
                                                     acc):
    """The band kernel at tile 64, width 48 (T + W = 112: the last slab
    slice half empty; a tile pair's two blocks in two node tiles, so each
    loads its own slab) with N / 64 even and odd (the last pair's second
    block empty), the first and last slabs clamped: within
    KERNEL_BANDED_TOL, and the same bits twice."""
    dev = _card()
    b, band, x, opts = _banded_case(dev, h, seed=h + 17, geo=GEOMETRIES[geo])
    assert b.band_tile + b.band_width == 112
    kw = dict(tile=b.band_tile, width=b.band_width, out_dtype=torch.bfloat16,
              **_options(opts, spill, table, acc))
    got = bm.banded_matmul(band, x, **kw)
    again = bm.banded_matmul(band, x, **kw)
    torch.cuda.synchronize()
    ref = bm.banded_matmul_plain(band, x, **kw)
    atol, rtol = sl.gate_tol(ref, bm.KERNEL_BANDED_TOL)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_banded_kernel_walks_many_tile_pairs_on_cuda(out_dtype):
    """A batch with more 128-row tile pairs than twice the card's SMs, so
    every persistent cluster (at most one per SM pair) walks at least two
    pairs: every row within its gate (bf16: KERNEL_BANDED_TOL; float32: the
    f32 sums up to their order, 1e-5 of the output's rms), the same bits
    twice."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile, width, h = 256, 64, 128
    n = tile * ((2 * sms + 2) * 128 // tile + 1)
    assert n // 128 > 2 * (sms // 2)
    rng = np.random.default_rng(23)
    band = torch.from_numpy(rng.integers(0, 3, size=(n, tile + width))
                            .astype(np.int8)).to(dev)
    x, acc = (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    kw = dict(tile=tile, width=width, out_dtype=out_dtype, acc=acc)
    got = bm.banded_matmul(band, x, **kw)
    again = bm.banded_matmul(band, x, **kw)
    torch.cuda.synchronize()
    ref = bm.banded_matmul_plain(band, x, **kw)
    if out_dtype == torch.bfloat16:
        atol, rtol = sl.gate_tol(ref, bm.KERNEL_BANDED_TOL)
    else:
        atol, rtol = 1e-5 * float(ref.pow(2).mean().sqrt()), 1e-5
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("star", ["local_emit", "full"])
def test_forward_on_cluster_geometries_on_cuda(geo, h, star):
    """#1's training variant (skip, dropout 0.1; the emitted table with the
    local windows) where a cluster's two blocks lie in two node tiles and
    where the last cluster's second block is empty (GEOMETRIES), in both
    star modes: every output within its gate, the dropped positions
    exact."""
    dev = _card()
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, h, star, seed=h + 3,
                                           geo=GEOMETRIES[geo])
    emit = star == "local_emit"
    kw.update(tile=b.band_tile, width=b.band_width, skip=True, emit=emit,
              save_res=True, rate=0.1, seed=SEED)
    z, tab, y, inv, agg = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    torch.cuda.synchronize()
    zp, _, yp, invp, aggp = sl.sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    m = b.node_mask
    for got, ref, tol in ((z, zp, sl.KERNEL_Z_TOL), (y, yp, sl.KERNEL_Z_TOL),
                          (agg, aggp, sl.KERNEL_Z_TOL),
                          (inv, invp, sl.KERNEL_INV_TOL)):
        torch.testing.assert_close(got[m].float(), ref[m].float(),
                                   atol=tol[0], rtol=tol[1])
    dropped = ~keep_mask(SEED, b.n_node_cap, h, 0.1, dev)
    assert bool((z[dropped] == 0).all())
    assert (tab is None) == (not emit)
    if emit:
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], b.band_tile)
        torch.testing.assert_close(tab, tabp, atol=TAB_ATOL, rtol=TAB_RTOL)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("star", ["local", "full"])
def test_bwd_on_cluster_geometries_on_cuda(geo, h, star):
    """#2 (the next layer's star on dz, skip, dropout 0.1) on the
    GEOMETRIES batches, in both star modes: every output within its
    gate."""
    dev = _card()
    b, args, kw = _bwd_case(dev, h, star, True, True, 0.1,
                            geo=GEOMETRIES[geo])
    got = sl.sage_layer_bwd(*args, **kw)
    torch.cuda.synchronize()
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    m = b.node_mask
    for name, g, r in zip(("dx", "dw_l", "dw_r", "db_l", "town"), got, ref):
        if name == "dx":
            g, r = g[m], r[m]
        atol, rtol = sl.gate_tol(r, sl.KERNEL_BWD_TOL[name])
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda s: f"{name}: {s}")


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("kind", ["virtual", "super"])
def test_bwd_tile_on_cluster_geometries_on_cuda(geo, h, kind):
    """#3 (skip, dropout 0.1) on spill batches at the GEOMETRIES: every
    output within its gate."""
    dev = _card()
    b, args, kw = _tile_case(dev, h, kind, True, 0.1, geo=GEOMETRIES[geo])
    got = sl.sage_layer_bwd_tile(*args, **kw)
    torch.cuda.synchronize()
    ref = sl.sage_layer_bwd_tile_plain(*args, **kw)
    m = b.node_mask
    for name, g, r in zip(TILE_NAMES, got, ref):
        if name == "tbwd" and kind == "virtual":
            assert g is None and r is None
            continue
        if name in ("dagg", "dxp"):
            g, r = g[m], r[m]
        atol, rtol = sl.gate_tol(r, sl.KERNEL_BWD_TOL[name])
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda s: f"{name}: {s}")


def test_forward_is_deterministic():
    """No float atomics: two calls of #1 on the same inputs give the same
    z, emitted table, y, inv and agg, bit for bit."""
    dev = _card()
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, 512, "local_emit", seed=9)
    kw.update(tile=TILE, width=WIDTH, skip=True, emit=True, save_res=True,
              rate=0.1, seed=SEED)
    first = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    second = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


# ---- the fused EA block (kernels #5 and #6) --------------------------------

EA_MODES = [(128, False), (256, False), (256, True), (512, False),
            (512, True)]  # (H, encoder mode); the encoder needs H > 128


# (panels, W floor, band tile, node-cap multiple, E % 64)
EA_BATCHES = {"full": (16, 0, 128, 256, 0), "partial": (12, 552, 128, 256, 16),
              "tile64": (8, 0, 64, 64, 48), "odd": (5, 0, 64, 64, 48)}


def _ea_batch(dev, which="full"):
    """Virtual-edge panels of 8-11 nodes a side, width 64, packed by
    batch_iterator with a floor on W: "full" is 16 panels at tile 128, 12
    node tiles of W = 528 (not a multiple of 64), E a whole number of the
    kernels' 64-slot blocks; "partial" is 12 panels with W = 552, 10 tiles
    and E % 64 = 16, so the last block is partial; "tile64" is 8 panels at
    tile 64, N = 704 (N % 128 = 64: the last cluster of two 64-row blocks
    has one empty block) and E % 64 = 48; "odd" is 5 panels at tile 64, N =
    448 (N / 64 = 7, the last cluster's second block empty) and E % 64 =
    48. All have far senders."""
    n_graphs, w_floor, tile, mult, e_rem = EA_BATCHES[which]
    ds = generate_dataset(n_graphs, seed=2, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + mult - 1) // mult) * mult
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    (b,) = tb.batch_iterator(ds, n_graphs, ncap, ecap, band_width=WIDTH,
                             band_tile=tile, min_win_cap=w_floor,
                             device="cpu")
    b = b.to(dev)
    t, wc = b.win_sidx.shape
    assert t >= 4 and wc % 64 != 0
    assert (t * wc) % 64 == e_rem
    assert tile == 128 or b.n_node_cap % 128 == 64
    return b, eb.make_ea_context(b)


@pytest.mark.parametrize("n", [128, 256, 512])
@pytest.mark.parametrize("k", [128, 512, 1024])
@pytest.mark.parametrize("transpose", [False, True])
def test_ea_engine_product_matches_matmul(n, k, transpose):
    """The EA kernels' product engine alone (TMA ring, wgmma, both
    major-nesses of the weight) against a float32 matmul of the same bf16
    operands, on 138 rows: two clusters of two 64-row blocks, the third
    block partial and the fourth empty. Both sides sum exact bf16 products
    in float32 in another order (differences ~1e-6 at unit scale); a wrong
    descriptor, swizzle or slice order moves entries by O(1)."""
    dev = _card()
    rng = np.random.default_rng(n + k + int(transpose))
    m = 138
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(n, k) if transpose else (k, n))
                          / np.sqrt(k)).astype(np.float32))
    a, w = (v.to(dev, torch.bfloat16).contiguous() for v in (a, w))
    got = eb.engine_product(a, w, transpose=transpose)
    ref = a.float() @ (w.float().t() if transpose else w.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)


def _ea_case(dev, h, enc, seed, which="full", dtype=torch.bfloat16):
    """(batch, ctx, x, e_win, w, bias): lecun-normal weights in ``dtype``,
    a bias stack of 0.3 rms (a dropped cnt * b_p1 then fails the gate), x
    and the window of unit rms (the raw features in encoder mode)."""
    b, ctx = _ea_batch(dev, which)
    rng = np.random.default_rng(seed)
    dims = dict(wer=(h, h), wee=(h, h), wsp=(h, 2 * h), we1=(h, h),
                wpe=(h, h), wp1=(h, h), wg0=(2 * h, h), wg1=(h, h),
                wb0=(h, h), wb1=(h, h))
    if enc:
        dims.update(wen0=(8, 128), wen1=(128, 128), wen2=(128, h))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dev, dtype).contiguous()
    w = {k: bf(rng.normal(size=d) / np.sqrt(d[0])) for k, d in dims.items()}
    bias = torch.from_numpy((rng.normal(size=(11 if enc else 8, h)) * 0.3)
                            .astype(np.float32)).to(dev)
    x = rng.normal(size=(b.n_node_cap, h))
    x[-1] = 0.0
    t, wc = b.win_sidx.shape
    if enc:
        e = torch.nn.functional.pad(b.win_edges, (0, 3)).to(dtype)
    else:
        e = bf(rng.normal(size=(t, wc, h)))
    return b, ctx, bf(x), e.contiguous(), w, bias


def _ea_fwd_close(got, ref, ctx, h):
    v = ctx.recv >= 0
    for name, a, r in zip(("zx", "ze", "e1s", "m1s"), got, ref):
        if name != "zx":
            a, r = a.reshape(-1, h)[v], r.reshape(-1, h)[v]
        atol, rtol = sl.gate_tol(r, eb.KERNEL_FWD_TOL)
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("h,enc", EA_MODES)
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("which", sorted(EA_BATCHES))
def test_ea_forward_matches_plain_on_cuda(h, enc, skip, rate, which):
    dev = _card()
    if enc and skip:
        pytest.skip("encoder mode is layer 0, which has no skip")
    b, ctx, x, e, w, bias = _ea_case(dev, h, enc, seed=h + 2 * skip,
                                     which=which)
    kw = dict(skip=skip, rate=rate, seed=SEED if rate else None, enc=enc,
              save_res=True)
    got = eb.ea_block_fwd(x, e, w, bias, ctx, **kw)
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, **kw)
    torch.cuda.synchronize()
    _ea_fwd_close(got, ref, ctx, h)
    if rate:
        drop_x = ~keep_mask(SEED, x.shape[0], h, rate, dev,
                            row0=ctx.n_slots)
        assert bool((got[0][drop_x] == 0).all())
        assert 0.09 < float(drop_x.float().mean()) < 0.11


def _ea_bwd(dev, h, enc, skip, rate, seed, which="full",
            dtype=torch.bfloat16):
    b, ctx, x, e, w, bias = _ea_case(dev, h, enc, seed, which, dtype)
    kw = dict(skip=skip, rate=rate, seed=SEED if rate else None, enc=enc)
    _, ze, e1s, m1s = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True,
                                      **kw)
    g = torch.Generator(device=dev).manual_seed(seed)
    dzx = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    dze = torch.randn(ze.shape, generator=g, device=dev).to(x.dtype)
    return b, ctx, (dzx, dze, e1s, m1s, x, e, w, bias, ctx), kw


@pytest.mark.parametrize("h,enc", EA_MODES)
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("which", sorted(EA_BATCHES))
def test_ea_backward_matches_plain_on_cuda(h, enc, skip, rate, which):
    """dx, de_win, every dW and dbias within KERNEL_BWD_TOL (relative
    norms, and per row for dx and de_win; reasons in ops/ea_block.py)."""
    dev = _card()
    if enc and skip:
        pytest.skip("encoder mode is layer 0, which has no skip")
    b, ctx, args, kw = _ea_bwd(dev, h, enc, skip, rate, seed=h + 5,
                               which=which)
    got = eb.ea_block_bwd(*args, **kw)
    ref = eb.ea_block_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    if enc:
        assert got[1] is None and ref[1] is None
    assert sorted(got[2]) == sorted(ref[2])
    errs = eb.bwd_errors(got, ref, ctx)
    assert {"dx", "dx_row", "dbias"} <= set(errs)
    assert enc or {"de_win", "de_win_row"} <= set(errs)
    for k, err in errs.items():
        assert err <= eb.bwd_tol(k), (k, err)


@pytest.mark.parametrize("which", ["odd", "tile64"])
@pytest.mark.parametrize("h", [128, 512])
def test_ea_kernels_with_an_empty_last_block_on_cuda(which, h):
    """#5 and #6 on batches with N / 64 odd: the node passes' last cluster
    of two 64-row blocks has an empty second block, whose per-row loads
    (cnt, the receiver runs) must form no address past the end (they read
    row 0 and drop it). The forward and the backward (skip, dropout 0.1)
    within their gates, and the backward's same bits twice."""
    dev = _card()
    b, ctx, args, kw = _ea_bwd(dev, h, False, True, 0.1, seed=h + 7,
                               which=which)
    assert (b.n_node_cap // 64) % 2 == 1
    x, e, w, bias = args[4:8]
    got = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True, **kw)
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, save_res=True, **kw)
    first = eb.ea_block_bwd(*args, **kw)
    second = eb.ea_block_bwd(*args, **kw)
    torch.cuda.synchronize()
    _ea_fwd_close(got, ref, ctx, h)
    errs = eb.bwd_errors(first, eb.ea_block_bwd_plain(*args, **kw), ctx)
    for k, err in errs.items():
        assert err <= eb.bwd_tol(k), (k, err)
    (dx, de, dw, dbias), (dx2, de2, dw2, dbias2) = first, second
    assert torch.equal(dx, dx2) and torch.equal(de, de2)
    assert torch.equal(dbias, dbias2)
    assert all(torch.equal(dw[k], dw2[k]) for k in dw)


@pytest.mark.parametrize("mode", ["hybrid", "autodiff"])
@pytest.mark.parametrize("shard", [0, 1])
def test_ea_far_grad_modes_match_plain_on_cuda(mode, shard):
    """#5 and #6 on one shard of the "full" batch split in two tile ranges
    (parallel/ea_shard.py), in 'hybrid' and 'autodiff' mode: the kernels
    run on the shard's rows and the appended far rows of the whole x, and
    the backward's sender fold writes those rows' gradient. zx, ze, e1s
    and m1s within the forward's gate; dx (its own rows and the appended
    rows, by norm and per row), de_win and every dW within the backward's
    (skip on, dropout 0.1)."""
    from buckgnn_tpu_torch.parallel.ea_shard import _ShardView, shard_ea_batch

    dev = _card()
    h = 512
    b, _, x_full, _, w, bias = _ea_case(dev, h, False, seed=41)
    shards = shard_ea_batch(b, 2).to(dev)
    fl = shards.cf_local if mode == "hybrid" else 0
    ctx = eb.make_ea_context(_ShardView(shards, shard), mode, fl)
    nl = ctx.n_local
    assert ctx.ext_ids is not None and ctx.n_nodes > nl
    x = eb.extended_rows(x_full[shard * nl:(shard + 1) * nl].contiguous(),
                         ctx, x_full)
    g = torch.Generator(device=dev).manual_seed(43)
    t, wc = shards.sidx.shape[1:]
    e = torch.randn((t, wc, h), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(skip=True, rate=0.1, seed=SEED, enc=False)
    got = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True, **kw)
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, save_res=True, **kw)
    _ea_fwd_close(got, ref, ctx, h)
    dzx = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    dzx[nl:] = 0
    dze = torch.randn(e.shape, generator=g, device=dev).to(x.dtype)
    args = (dzx, dze, ref[2], ref[3], x, e, w, bias, ctx)
    gb = eb.ea_block_bwd(*args, **kw)
    rb = eb.ea_block_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for k, err in eb.bwd_errors(gb, rb, ctx).items():
        assert err <= eb.bwd_tol(k), (k, err)
    n_ext = nl + ctx.ext_ids.numel()
    remote = rb[0][nl:n_ext]
    assert float(remote.float().abs().max()) > 0
    assert eb.rel_err(gb[0][nl:n_ext], remote) <= eb.bwd_tol("dx")
    assert eb.row_rel_err(gb[0][nl:n_ext], remote) <= eb.bwd_tol("dx_row")


def test_ea_kernels_are_deterministic():
    dev = _card()
    outs = []
    for _ in range(2):
        _, ctx, args, kw = _ea_bwd(dev, 512, True, False, 0.1, seed=21)
        dx, _, dw, dbias = eb.ea_block_bwd(*args, **kw)
        outs.append([*args[2:4], dx, dbias] + [dw[k] for k in sorted(dw)])
    torch.cuda.synchronize()
    for a, c in zip(*outs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("which", sorted(EA_BATCHES))
def test_ea_gates_catch_faults_on_cuda(which):
    """The kernels' outputs against faulty plain versions: a forward
    without its far senders, without cnt * b_p1 or without the skip fails
    the forward gate; a backward without the slab-overlap halo, the far
    rows, one node's sender run, one far rank or the first tile's halo
    (ops/ea_block.py::sender_faults) fails dx's norm or row gate, and one
    without the far rows fails dW_sp's gate."""
    dev = _card()
    h = 512
    b, ctx, args, kw = _ea_bwd(dev, h, False, True, 0.1, seed=31,
                               which=which)
    x, e, w, bias = args[4:8]
    zx, ze = eb.ea_block_fwd(x, e, w, bias, ctx, **kw)
    v = ctx.recv >= 0
    no_far = eb.sender_faults(b, ctx)["no-far-fold"]
    no_cnt_b = bias.clone()
    no_cnt_b[3] = 0.0

    def passes(got, ref):
        atol, rtol = sl.gate_tol(ref, eb.KERNEL_FWD_TOL)
        err = (got.float() - ref.float()).abs()
        return not bool((err > atol + rtol * ref.float().abs()).any())

    for fault, fargs, fkw in (
            ("no-far", (x, e, w, bias, no_far), kw),
            ("no-cnt-b", (x, e, w, no_cnt_b, ctx), kw),
            ("no-skip", (x, e, w, bias, ctx), dict(kw, skip=False))):
        fzx, fze = eb.ea_block_fwd_plain(*fargs, **fkw)
        assert not (passes(fzx, zx) and passes(
            fze.reshape(-1, h)[v], ze.reshape(-1, h)[v])), fault
    got = eb.ea_block_bwd(*args, **kw)
    for fault, bad in eb.sender_faults(b, ctx).items():
        errs = eb.bwd_errors(got, eb.ea_block_bwd_plain(*args[:-1], bad, **kw),
                             ctx)
        assert (errs["dx"] > eb.bwd_tol("dx")
                or errs["dx_row"] > eb.bwd_tol("dx_row")), (fault, errs)
        if fault == "no-far-fold":
            assert errs["dwsp"] > eb.bwd_tol("dwsp"), errs


def test_ea_kernels_reject_what_they_do_not_take():
    """float32 throughout takes the simple variant; mixed dtypes, float16
    and a width no variant takes (H = 192) raise before any launch, the
    last two naming the dtype and the width."""
    dev = _card()
    _, ctx, args, kw = _ea_bwd(dev, 128, False, False, 0.0, seed=41)
    dzx, dze, e1s, m1s, x, e, w, bias, _ = args
    f32 = {k: v.float() for k, v in w.items()}
    before = dict(eb.LAUNCHES)
    eb.ea_block_fwd(x.float(), e.float(), f32, bias, ctx, skip=False)
    torch.cuda.synchronize()
    assert eb.LAUNCHES == dict(
        before, ea_block_fwd_simple=before["ea_block_fwd_simple"] + 1)
    with pytest.raises(ValueError, match="x's dtype"):
        eb.ea_block_fwd(x.float(), e, w, bias, ctx, skip=False)
    half = {k: v.half() for k, v in w.items()}
    with pytest.raises(ValueError, match="torch.float16 at H = 128"):
        eb.ea_block_fwd(x.half(), e.half(), half, bias, ctx, skip=False)
    x192 = torch.zeros((x.shape[0], 192), dtype=x.dtype, device=dev)
    with pytest.raises(ValueError, match="torch.bfloat16 at H = 192"):
        eb.ea_block_fwd(x192, e, w, bias, ctx, skip=False)
    assert eb.LAUNCHES == dict(
        before, ea_block_fwd_simple=before["ea_block_fwd_simple"] + 1)
    with pytest.raises(ValueError, match="encoder mode needs H > 128"):
        raw = torch.zeros((*e.shape[:2], 8), dtype=x.dtype, device=dev)
        enc_w = dict(w, wen0=w["wee"][:8].contiguous(),
                     wen1=w["wee"].contiguous(), wen2=w["wee"].contiguous())
        eb.ea_block_fwd(x, raw, enc_w, torch.zeros((11, 128), device=dev),
                        ctx, skip=False, enc=True)
    with pytest.raises(ValueError, match="dropout needs"):
        eb.ea_block_bwd(*args, **dict(kw, rate=0.1))
    with pytest.raises(ValueError, match="float32 bias"):
        eb.ea_block_bwd(*args[:7], bias.bfloat16(), ctx, **kw)


# ---- the CSR segment sum (#7) and the epilogue (#8, #9) -------------------

def _csr(dev, which):
    """(CSR context, n) of "hub": random edges on 512 nodes and an
    800-degree hub, or "padded": a batch packed at suggest_capacities' caps,
    whose dead row owns every pad edge (over a thousand)."""
    if which == "hub":
        rng = np.random.default_rng(5)
        n = 512
        r = np.concatenate([rng.integers(0, n - 1, size=2000),
                            np.full(800, 3)])
        s = rng.integers(0, n - 1, size=len(r))
        o = np.argsort(r, kind="stable")
        s, r = (torch.from_numpy(a[o].astype(np.int32)).to(dev)
                for a in (s, r))
        return cs.make_csr_context(s, r, n), n
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset

    ds = normalize_dataset(generate_dataset(
        32, seed=7, min_side=10, max_side=20, use_super_node=False,
        use_virtual_edges=True))[0]
    ncap, ecap = tb.suggest_capacities(ds, 32)
    b = next(tb.batch_iterator(ds, 32, ncap, ecap, device=dev))
    assert int((b.receivers == ncap - 1).sum()) > 1000
    return cs.make_csr_context(b.senders, b.receivers, ncap), ncap


@pytest.mark.parametrize("which", ["hub", "padded"])
@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mean", [False, True])
def test_csr_kernel_matches_plain_on_cuda(which, h, dtype, mean):
    """Forward (receiver CSR) and backward (transposed CSR) within
    cs.gate; one launch each; the same bits twice."""
    dev = _card()
    ctx, n = _csr(dev, which)
    g = torch.Generator(device=dev).manual_seed(h)
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    for idx, off in ((ctx.senders, ctx.row_off), (ctx.t_idx, ctx.t_off)):
        before = cs.LAUNCHES["csr_segment"]
        got = cs.csr_segment_sum(x, idx, off, mean)
        again = cs.csr_segment_sum(x, idx, off, mean)
        torch.cuda.synchronize()
        assert cs.LAUNCHES["csr_segment"] == before + 2
        assert got.dtype == (torch.float32 if mean else dtype)
        assert torch.equal(got, again)
        ref = cs.csr_segment_sum_plain(x, idx, off, mean)
        ok, err, share = cs.gate(got, ref, dtype)
        assert ok, (err, share)


@pytest.mark.parametrize("which", ["hub", "padded"])
@pytest.mark.parametrize("h", [128, 512])
def test_csr_split_path_on_cuda(which, h):
    """The runs longer than cs.SPLIT edges (the 800-degree hub; the dead
    row's pads, forward and transposed) through the kernel's split blocks:
    add and mean within cs.gate of both plain versions
    (`csr_segment_sum_plain`, `csr_segment_sum_split_plain`), the same bits
    twice."""
    dev = _card()
    ctx, n = _csr(dev, which)
    assert int((ctx.row_off[1:] - ctx.row_off[:-1]).max()) > cs.SPLIT
    g = torch.Generator(device=dev).manual_seed(h + 1)
    x = torch.randn((n, h), generator=g, device=dev).to(torch.bfloat16)
    for idx, off in ((ctx.senders, ctx.row_off), (ctx.t_idx, ctx.t_off)):
        for mean in (False, True):
            got = cs.csr_segment_sum(x, idx, off, mean)
            again = cs.csr_segment_sum(x, idx, off, mean)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            for ref in (cs.csr_segment_sum_plain(x, idx, off, mean),
                        cs.csr_segment_sum_split_plain(x, idx, off, mean)):
                ok, err, share = cs.gate(got, ref, x.dtype)
                assert ok, (err, share)


@pytest.mark.parametrize("mean", [False, True])
def test_csr_gate_catches_faults_on_cuda(mean):
    dev = _card()
    ctx, n = _csr(dev, "hub")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((n, 512), generator=g, device=dev).to(torch.bfloat16)
    got = cs.csr_segment_sum(x, ctx.senders, ctx.row_off, mean)
    for fault, bad in cs.faults(x, ctx.senders, ctx.row_off, mean).items():
        assert not cs.gate(bad, got, x.dtype)[0], fault


def test_csr_kernel_rejects_what_it_does_not_take():
    dev = _card()
    ctx, n = _csr(dev, "hub")
    x = torch.zeros((n, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="H % 8"):
        cs.csr_segment_sum(x, ctx.senders, ctx.row_off)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cs.csr_segment_sum(torch.zeros((n, 64), dtype=torch.float16,
                                       device=dev), ctx.senders, ctx.row_off)
    with pytest.raises(ValueError, match="int32"):
        cs.csr_segment_sum(torch.zeros((n, 64), device=dev),
                           ctx.senders.long(), ctx.row_off)
    with pytest.raises(ValueError, match="contiguous"):
        cs.csr_segment_sum(torch.zeros((64, n), device=dev).t(),
                           ctx.senders, ctx.row_off)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shape", [(1000, 136), (4099, 512)])
def test_epilogue_kernels_match_plain_bit_for_bit(dtype, skip, shape):
    """#8 and #9 against their plain versions at dropout 0.1: equal values;
    one launch each; the faults of ep.faults differ."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(shape[0])
    c, p, dy = (torch.randn(shape, generator=g, device=dev).to(dtype)
                for _ in range(3))
    pp = p if skip else None
    before = dict(ep.LAUNCHES)
    y = ep.epilogue_fwd(c, pp, SEED, 0.1)
    dc, dp = ep.epilogue_bwd(dy, c, SEED, 0.1, skip)
    torch.cuda.synchronize()
    assert ep.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert torch.equal(y, ep.epilogue_fwd_plain(c, pp, SEED, 0.1))
    dcp, dpp = ep.epilogue_bwd_plain(dy, c, SEED, 0.1, skip)
    assert torch.equal(dc, dcp)
    assert (dp is None) == (not skip) and (dp is None or torch.equal(dp, dpp))
    for fault, (fy, (fdc, _)) in ep.faults(dy, c, pp, SEED, 0.1).items():
        assert not torch.equal(fdc, dc), fault
        assert fy is None or not torch.equal(fy, y), fault


def test_epilogue_kernels_reject_what_they_do_not_take():
    dev = _card()
    c = torch.zeros((16, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="H % 8"):
        ep.epilogue_fwd(c, None, SEED, 0.1)
    c = torch.zeros((16, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="one dtype and shape"):
        ep.epilogue_fwd(c, c.float(), SEED, 0.1)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ep.epilogue_bwd(c.half(), c.half(), SEED, 0.1, False)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_unfused_model_launches_per_train_step_on_cuda(impl):
    """One train step of a 3-layer unfused model on a trainer-packed batch:
    'pallas' launches #7 twice per layer (forward and backward), 'xla'
    never; both launch #8 and #9 once per layer; no fused kernel."""
    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import (
        build_model, init_state, make_optimizer, make_train_step,
    )

    dev = _card()
    ds, nz = normalize_dataset(generate_dataset(
        8, seed=3, min_side=8, max_side=12, use_super_node=False,
        use_virtual_edges=True))
    ncap, ecap = tb.suggest_capacities(ds, 8)
    b = next(tb.batch_iterator(ds, 8, ncap, ecap, device=dev))
    cfg = TrainConfig(hidden_channels=128, num_layers=3,
                      compute_dtype="bfloat16", segment_impl=impl)
    model = build_model(cfg, ds[0].x.shape[1], 5, device=dev)
    state = init_state(model, make_optimizer(cfg, model))
    step, _ = make_train_step(state.model, state.optimizer,
                              get_loss_function(cfg.loss_function), cfg, nz)
    for mod in (sl, eb, cs, ep):
        mod.reset_launch_counts()
    loss = float(step(b, 1e-3, torch.Generator().manual_seed(0))["loss"])
    assert np.isfinite(loss)
    assert cs.LAUNCHES["csr_segment"] == (6 if impl == "pallas" else 0)
    assert ep.LAUNCHES == {"epilogue_fwd": 3, "epilogue_bwd": 3}
    assert set(sl.LAUNCHES.values()) == {0}
    assert set(eb.LAUNCHES.values()) == {0}


def _hub_batch(dev):
    """One graph whose hub's out-of-band edges overflow its tile's spill
    window into spill2 (tests/test_torch_port_banded_path.py::_hub)."""
    rng = np.random.default_rng(0)
    far = rng.integers(450, 700, size=320)
    s_und = np.concatenate([far, np.arange(1, 640, 2)])
    r_und = np.concatenate([np.zeros(len(far), np.int64),
                            np.arange(2, 641, 2)])
    senders = np.concatenate([s_und, r_und]).astype(np.int32)
    receivers = np.concatenate([r_und, s_und]).astype(np.int32)
    g = tb.GraphData(x=rng.normal(size=(700, 15)).astype(np.float32),
                     senders=senders, receivers=receivers,
                     edge_attr=rng.normal(size=(len(senders), 5)).astype(
                         np.float32), y=np.ones((1,), np.float32))
    b = tb.pack_graphs([g], 1024, ((len(senders) + 127) // 128) * 128, 2,
                       band_width=128, band_tile=256, device="cpu")
    assert b.has_spill2_edges
    return b.to(dev)


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("kind", ["super", "virtual", "spill2"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_unfused_banded_aggregate_on_cuda(h, kind, aggr, monkeypatch):
    """The unfused layers' banded aggregation (ops/banded.py): kernel #4
    once in the forward and once in the symmetric backward, with the star
    terms (super), the spill window (virtual) and spill2 (the hub batch),
    against the same aggregation on the plain band product, within #4's
    gate."""
    from buckgnn_tpu_torch.ops.banded import banded_sage_aggregate

    dev = _card()
    b = {"super": lambda: _batch(dev),
         "virtual": lambda: _spill_batch(dev, "virtual"),
         "spill2": lambda: _hub_batch(dev)}[kind]()
    ctx = make_agg_context(b, use_pallas=True, need_degree=aggr == "mean")
    x, g = (_inputs(b.n_node_cap, h, dev, seed=s)[0] for s in (h, h + 1))

    def run():
        xr = x.clone().requires_grad_()
        out = banded_sage_aggregate(xr, ctx, aggr)
        out.backward(g.to(out.dtype))
        return out.detach(), xr.grad

    sl.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert sl.LAUNCHES["banded_matmul"] == 2
    monkeypatch.setattr(bm, "_launch", bm.banded_matmul_plain)
    ref = run()
    for gv, rv in zip(got, ref):
        atol, rtol = sl.gate_tol(rv, bm.KERNEL_BANDED_TOL)
        torch.testing.assert_close(gv.float(), rv.float(), atol=atol,
                                   rtol=rtol)


# ---- the simple variants (csrc/sage_simple.cu): float32 and other widths -

# (dtype, H) of every variant check: float32 at the engine's widths and
# beyond, bf16 at the widths the engine does not take
SIMPLE_CASES = [(torch.float32, h) for h in (128, 384, 512, 640, 1024)] + [
    (torch.bfloat16, h) for h in (384, 640, 1024)]
SIMPLE_IDS = [f"{str(d)[6:]}-{h}" for d, h in SIMPLE_CASES]


def _vclose(got, ref, dtype, bf16_tol, frac=False, what=""):
    """got within the variant gate of ``dtype`` (bm.variant_tol: float32
    bm.SIMPLE_F32_TOL of max|ref|, bf16 the engine's ``bf16_tol``)."""
    atol, rtol = bm.variant_tol(ref, dtype, bf16_tol, frac)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{what}: {m}")


def _simple_layer(dev, dtype, h, star, seed, spill=None):
    """(batch, layer args, kwargs) in ``dtype``: `_layer`'s star cases on
    the supernode batch, or with ``spill`` ("virtual" or "super")
    `_spill_layer`'s spill batch."""
    if spill:
        b = _spill_batch(dev, spill)
    else:
        b = _batch(dev, supernode=star != "none")
        if star == "full":
            b = b.replace(gwin=None, lcode=None, lacc=None)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, h, dev, seed, dtype)
    kw = dict(tile=b.band_tile, width=b.band_width)
    if spill:
        kw.update(_spill_kw(b, x))
    if b.has_supernode_edges:
        code, gwin, gw, acc = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        kw.update(table=sl._super_tables(x, b.node_graph, b.node_mask,
                                         b.supernode_index, b.n_graph_cap,
                                         tg),
                  code=code, gwin=gwin, gw=gw, t0=t0,
                  acc_code=acc if star == "local_emit" else None,
                  emit=star == "local_emit")
    return b, (x, w_l, b_l, w_r, make_agg_context(b).band), kw


def _counted(name, fn):
    """fn()'s result, and that it launched ``name`` once and no engine
    kernel."""
    before = dict(sl.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    want = dict(before, **{name: before[name] + 1})
    assert sl.LAUNCHES == want, (sl.LAUNCHES, want)
    return out


@pytest.mark.parametrize("dtype,h", SIMPLE_CASES, ids=SIMPLE_IDS)
@pytest.mark.parametrize("star", ["local_emit", "full", "none", "virtual",
                                  "super_spill"])
@pytest.mark.parametrize("train", [False, True])
def test_simple_forward_matches_plain_on_cuda(dtype, h, star, train):
    """#1's variant, serving (skip on) and training (residuals, dropout
    0.1): z, y, agg and inv within their gates, the emitted table against
    the plain emission of the kernel's own z, the same dropped positions;
    on supernode batches (local windows with emit, the whole table), a
    batch without stars and the spill batches."""
    dev = _card()
    spill = {"virtual": "virtual", "super_spill": "super"}.get(star)
    b, args, kw = _simple_layer(dev, dtype, h, star, seed=h + 3,
                                spill=spill)
    kw["skip"] = True
    if train:
        kw.update(save_res=True, rate=0.1, seed=SEED)
    got = _counted("sage_layer_fwd_simple",
                   lambda: sl.sage_layer_fwd(*args, **kw))
    ref = sl.sage_layer_plain(*args, **kw)
    m = b.node_mask
    _vclose(got[0][m], ref[0][m], dtype, sl.KERNEL_Z_TOL, what="z")
    if kw.get("emit"):
        tabp = sl.emit_table_plain(got[0], kw["acc_code"], kw["gwin"],
                                   kw["gw"], kw["t0"], kw["tile"])
        _vclose(got[1], tabp, dtype, sl.KERNEL_TABLE_TOL, what="table")
    else:
        assert got[1] is None
    if train:
        for what, i, tol in (("y", 2, sl.KERNEL_Z_TOL),
                             ("agg", 4, sl.KERNEL_Z_TOL)):
            _vclose(got[i][m], ref[i][m], dtype, tol, what=what)
        torch.testing.assert_close(got[3][m], ref[3][m], atol=0.0,
                                   rtol=sl.KERNEL_INV_TOL[1])
        dropped = ~keep_mask(SEED, b.n_node_cap, h, 0.1, dev)
        z, zp = got[0], ref[0]
        assert bool((z[dropped] == 0).all()) and bool((zp[dropped] == 0).all())
        kept_big = ~dropped & (zp.float().abs() > Z_ATOL)
        assert bool((z[kept_big] != 0).all())


def _simple_bwd_case(dev, dtype, h, star, apply_prev, skip, rate, seed=17):
    """`_bwd_case` in ``dtype``: residuals of #1's variant, a random dz and
    (apply_prev) a random next-layer table."""
    b, args, kw = _simple_layer(dev, dtype, h, star, seed)
    fwd = {k: v for k, v in kw.items() if k not in ("acc_code", "emit")}
    _, _, y, inv, agg = sl.sage_layer_fwd(
        *args, **dict(fwd, skip=skip, save_res=True, rate=rate,
                      seed=SEED if rate else None))
    rng = np.random.default_rng(seed + 1)
    dz = torch.from_numpy(rng.normal(size=(b.n_node_cap, h)).astype(
        np.float32)).to(dev, dtype)
    x, w_l, _, w_r, band = args
    bwd = dict(tile=b.band_tile, width=b.band_width, skip=skip, rate=rate,
               seed=SEED if rate else None, has_super=star != "none")
    if star != "none":
        code, gwin, gw, acc = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        bwd.update(code=code, gwin=gwin, gw=gw, t0=t0, acc_code=acc)
        if apply_prev:
            bwd["table_prev"] = torch.from_numpy(rng.normal(
                size=(tg, h)).astype(np.float32)).to(dev, dtype)
    return b, (dz, y, inv, agg, x, w_l, w_r, band), bwd


@pytest.mark.parametrize("dtype,h", SIMPLE_CASES, ids=SIMPLE_IDS)
@pytest.mark.parametrize("star,apply_prev", [
    ("local", True), ("full", True), ("none", False)])
@pytest.mark.parametrize("skip,rate", [(True, 0.1), (False, 0.0)])
def test_simple_bwd_matches_plain_on_cuda(dtype, h, star, apply_prev, skip,
                                          rate):
    """#2's variant: dx, dW_l, dW_r, db_l and the own table within their
    gates."""
    dev = _card()
    b, args, kw = _simple_bwd_case(dev, dtype, h, star, apply_prev, skip,
                                   rate)
    got = _counted("sage_layer_bwd_simple",
                   lambda: sl.sage_layer_bwd(*args, **kw))
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    m = b.node_mask
    for name, g, r in zip(("dx", "dw_l", "dw_r", "db_l", "town"), got, ref):
        if name == "town" and star == "none":
            assert g is None and r is None
            continue
        if name == "dx":
            g, r = g[m], r[m]
        _vclose(g, r, dtype, sl.KERNEL_BWD_TOL[name], frac=True, what=name)


@pytest.mark.parametrize("dtype,h", SIMPLE_CASES, ids=SIMPLE_IDS)
@pytest.mark.parametrize("kind", ["virtual", "super"])
@pytest.mark.parametrize("skip,rate", [(True, 0.1), (False, 0.0)])
def test_simple_bwd_tile_matches_plain_on_cuda(dtype, h, kind, skip, rate):
    """#3's variant: dagg, dxp, dW_l, dW_r, db_l and (supernodes) the own
    table by global codes within their gates."""
    dev = _card()
    b, args, kw = _simple_layer(dev, dtype, h, "local", seed=h + 5,
                                spill=kind)
    _, _, y, inv, agg = sl.sage_layer_fwd(
        *args, **dict(kw, skip=skip, save_res=True, rate=rate,
                      seed=SEED if rate else None))
    rng = np.random.default_rng(h)
    dz = torch.from_numpy(rng.normal(size=(b.n_node_cap, h)).astype(
        np.float32)).to(dev, dtype)
    x, w_l, _, w_r, _ = args
    _, tg = tb.star_table_geometry(b.n_graph_cap)
    tkw = dict(tile=b.band_tile, skip=skip, rate=rate,
               seed=SEED if rate else None,
               acc_code=b.gacc if kind == "super" else None, tg=tg)
    targs = (dz, y, inv, agg, x, w_l, w_r)
    got = _counted("sage_layer_bwd_tile_simple",
                   lambda: sl.sage_layer_bwd_tile(*targs, **tkw))
    ref = sl.sage_layer_bwd_tile_plain(*targs, **tkw)
    m = b.node_mask
    for name, g, r in zip(TILE_NAMES, got, ref):
        if name == "tbwd" and kind == "virtual":
            assert g is None and r is None
            continue
        if name in ("dagg", "dxp"):
            g, r = g[m], r[m]
        _vclose(g, r, dtype, sl.KERNEL_BWD_TOL[name], frac=True, what=name)


@pytest.mark.parametrize("dtype,h", SIMPLE_CASES, ids=SIMPLE_IDS)
@pytest.mark.parametrize("spill,table,acc,out_f32", [
    (True, True, True, False), (True, False, False, True),
    (False, True, False, False), (False, False, True, True),
    (False, False, False, False)])
def test_simple_banded_matches_plain_on_cuda(dtype, h, spill, table, acc,
                                             out_f32):
    """#4's variant with the spill window, the table, acc and both output
    types."""
    dev = _card()
    b = _spill_batch(dev, "super")
    rng = np.random.default_rng(h)
    n = b.n_node_cap
    _, tg = tb.star_table_geometry(b.n_graph_cap)
    x, a = (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    tab = torch.from_numpy(rng.normal(size=(tg, h)).astype(np.float32)).to(
        dev, dtype)
    opts = dict(spill=_spill_kw(b, x), table=dict(gcode=b.gcode, table=tab),
                acc=dict(acc=a))
    kw = dict(tile=b.band_tile, width=b.band_width,
              out_dtype=torch.float32 if out_f32 else dtype,
              **_options(opts, spill, table, acc))
    band = make_agg_context(b).band
    got = _counted("banded_matmul_simple",
                   lambda: bm.banded_matmul(band, x, **kw))
    ref = bm.banded_matmul_plain(band, x, **kw)
    assert got.dtype == ref.dtype
    _vclose(got, ref, dtype, bm.KERNEL_BANDED_TOL, frac=True, what="out")


@pytest.mark.parametrize("dtype,h", [(torch.float32, 384),
                                     (torch.bfloat16, 640)])
def test_simple_gates_catch_faults(dtype, h):
    """The variant gates fail the kernel's own outputs held against plain
    versions that drop b_l, the spill term, the norm backward's s term or
    the next layer's star table, and a band product without its spill
    messages."""
    dev = _card()

    def caught(got, wrong, bf16_tol, frac):
        atol, rtol = bm.variant_tol(wrong, dtype, bf16_tol, frac)
        err = (got.float() - wrong.float()).abs()
        assert bool((err > atol + rtol * wrong.float().abs()).any())

    b, args, kw = _simple_layer(dev, dtype, h, "none", seed=3,
                                spill="virtual")
    m = b.node_mask
    z, _ = sl.sage_layer_fwd(*args, **kw)
    nb = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
    caught(z[m], sl.sage_layer_plain(*nb, **kw)[0][m], sl.KERNEL_Z_TOL,
           False)
    no_spill = {k: v for k, v in kw.items() if not k.startswith("spill")}
    caught(z[m], sl.sage_layer_plain(*args, **no_spill)[0][m],
           sl.KERNEL_Z_TOL, False)
    b, bargs, bkw = _simple_bwd_case(dev, dtype, h, "local", True, True, 0.1)
    got = sl.sage_layer_bwd(*bargs, **bkw)
    no_prev = sl.sage_layer_bwd_plain(*bargs, **dict(bkw, table_prev=None))
    caught(got[0][b.node_mask], no_prev[0][b.node_mask],
           sl.KERNEL_BWD_TOL["dx"], True)
    real = sl._norm_backward
    sl._norm_backward = lambda dz, y, inv: torch.where(y > 0.0, dz, 0.0) * inv
    try:
        no_s = sl.sage_layer_bwd_plain(*bargs, **bkw)
    finally:
        sl._norm_backward = real
    caught(got[1], no_s[1], sl.KERNEL_BWD_TOL["dw_l"], True)
    sb = _spill_batch(dev, "virtual")
    x = _inputs(sb.n_node_cap, h, dev, 9, dtype)[0]
    band = make_agg_context(sb).band
    bkw = dict(tile=sb.band_tile, width=sb.band_width, out_dtype=dtype,
               **_spill_kw(sb, x))
    out = bm.banded_matmul(band, x, **bkw)
    wrong = bm.banded_matmul_plain(band, x, tile=sb.band_tile,
                                   width=sb.band_width, out_dtype=dtype)
    caught(out, wrong, bm.KERNEL_BANDED_TOL, True)


def test_simple_kernels_are_deterministic():
    """No float atomics: two calls of each variant give the same bits."""
    dev = _card()
    b, args, kw = _simple_layer(dev, torch.float32, 640, "local_emit", 4)
    f1 = sl.sage_layer_fwd(*args, **kw)
    f2 = sl.sage_layer_fwd(*args, **kw)
    _, bargs, bkw = _simple_bwd_case(dev, torch.float32, 640, "local", True,
                                     True, 0.1)
    g1 = sl.sage_layer_bwd(*bargs, **bkw)
    g2 = sl.sage_layer_bwd(*bargs, **bkw)
    torch.cuda.synchronize()
    for a, c in zip(f1 + g1, f2 + g2):
        assert torch.equal(a, c)


def test_simple_kernels_reject_what_they_do_not_take():
    """A CUDA call no variant takes raises (float16, H % 128 != 0, mixed
    dtypes); nothing falls back to another kernel."""
    dev = _card()
    b, args, kw = _simple_layer(dev, torch.float32, 384, "none", seed=0)
    x, w_l, b_l, w_r, band = args
    with pytest.raises(ValueError, match="bfloat16"):
        sl.sage_layer_fwd(x, w_l.bfloat16(), b_l, w_r, band, **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sl.sage_layer_fwd(x.half(), w_l.half(), b_l.half(), w_r.half(),
                          band, **kw)
    with pytest.raises(ValueError, match="H in"):
        bm.banded_matmul(band, x[:, :320].contiguous(), tile=b.band_tile,
                         width=b.band_width)


@pytest.mark.parametrize("dtype,h", [(torch.float32, 128),
                                     (torch.bfloat16, 384),
                                     (torch.float32, 640)])
@pytest.mark.parametrize("kind", ["super", "virtual"])
def test_unfused_banded_route_takes_the_simple_variant(dtype, h, kind,
                                                       monkeypatch):
    """On the card the banded_pallas route of float32 rows and of bf16 at
    H = 384 (which the engine does not take) goes through #4's simple
    variant, once in the forward and once in the symmetric backward,
    against the same aggregation on the plain band product."""
    from buckgnn_tpu_torch.ops.banded import banded_sage_aggregate

    dev = _card()
    b = _batch(dev) if kind == "super" else _spill_batch(dev, "virtual")
    ctx = make_agg_context(b, use_pallas=True)
    x, g = (_inputs(b.n_node_cap, h, dev, seed=s, dtype=dtype)[0]
            for s in (h, h + 1))

    def run():
        xr = x.clone().requires_grad_()
        out = banded_sage_aggregate(xr, ctx)
        out.backward(g.to(out.dtype))
        return out.detach(), xr.grad

    sl.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert sl.LAUNCHES["banded_matmul_simple"] == 2
    assert sl.LAUNCHES["banded_matmul"] == 0
    monkeypatch.setattr(bm, "_launch", bm.banded_matmul_plain)
    ref = run()
    for gv, rv in zip(got, ref):
        _vclose(gv, rv, dtype, bm.KERNEL_BANDED_TOL, frac=True)


# ---- the simple variants of the EA block (csrc/ea_simple.cu) -------------

# (dtype, H, encoder mode, skip, dropout rate): every mode of #5 and #6 at
# every (dtype, H) of SIMPLE_CASES, the encoder at H > 128 only
EA_SIMPLE_MODES = [(False, True, 0.0), (False, False, 0.1),
                   (False, True, 0.1), (True, False, 0.0), (True, False, 0.1)]
EA_SIMPLE_CASES = [(d, h, enc, skip, rate) for d, h in SIMPLE_CASES
                   for enc, skip, rate in EA_SIMPLE_MODES
                   if not (enc and h <= 128)]
EA_SIMPLE_IDS = [f"{str(d)[6:]}-{h}-{'enc' if enc else 'plain'}-skip"
                 f"{int(skip)}-rate{rate}"
                 for d, h, enc, skip, rate in EA_SIMPLE_CASES]


def _ea_counted(name, fn):
    """fn()'s result, and that it launched EA kernel ``name`` once and no
    other EA kernel."""
    before = dict(eb.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    want = dict(before, **{name: before[name] + 1})
    assert eb.LAUNCHES == want, (eb.LAUNCHES, want)
    return out


def _ea_vfwd_close(got, ref, ctx, h, dtype):
    """zx, and ze, e1s and m1s on valid slots, within eb.variant_fwd_tol."""
    v = ctx.recv >= 0
    for name, a, r in zip(("zx", "ze", "e1s", "m1s"), got, ref):
        if name != "zx":
            a, r = a.reshape(-1, h)[v], r.reshape(-1, h)[v]
        atol, rtol = eb.variant_fwd_tol(r, dtype)
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


def _ea_vbwd_close(got, ref, ctx):
    """Every backward output within eb.bwd_tol (either dtype)."""
    errs = eb.bwd_errors(got, ref, ctx)
    for k, err in errs.items():
        assert err <= eb.bwd_tol(k), (k, err)
    return errs


def _ea_simple_run(dev, dtype, h, enc, skip, rate, seed, which):
    """#5's and #6's variants and their plain versions on one case: the
    forward from the case's inputs, the backward from the variant's own
    residuals and a seeded cotangent. Returns (ctx, x, fwd, fwd ref, bwd,
    bwd ref)."""
    b, ctx, x, e, w, bias = _ea_case(dev, h, enc, seed, which, dtype)
    kw = dict(skip=skip, rate=rate, seed=SEED if rate else None, enc=enc)
    got = _ea_counted("ea_block_fwd_simple", lambda: eb.ea_block_fwd(
        x, e, w, bias, ctx, save_res=True, **kw))
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, save_res=True, **kw)
    g = torch.Generator(device=dev).manual_seed(seed)
    dzx = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    dze = torch.randn(got[1].shape, generator=g, device=dev).to(dtype)
    args = (dzx, dze, got[2], got[3], x, e, w, bias, ctx)
    gb = _ea_counted("ea_block_bwd_simple",
                     lambda: eb.ea_block_bwd(*args, **kw))
    rb = eb.ea_block_bwd_plain(*args, **kw)
    return ctx, x, got, ref, gb, rb


@pytest.mark.parametrize("dtype,h,enc,skip,rate", EA_SIMPLE_CASES,
                         ids=EA_SIMPLE_IDS)
@pytest.mark.parametrize("which", ["full", "partial", "odd"])
def test_ea_simple_matches_plain_on_cuda(dtype, h, enc, skip, rate, which):
    """#5's and #6's float32 / any-width variants on the small ragged
    batches (one ends in a partial 64-slot block, one has N / 64 odd):
    zx, ze, e1s and m1s within eb.variant_fwd_tol, the node mask's dropped
    positions exact; dx, de_win, every dW and dbias within eb.bwd_tol
    (the relu-mask flips that bound them are the same in float32, see
    ops/ea_block.py); each launch counted under its simple name."""
    dev = _card()
    ctx, x, got, ref, gb, rb = _ea_simple_run(dev, dtype, h, enc, skip, rate,
                                              h + 3 * skip, which)
    _ea_vfwd_close(got, ref, ctx, h, dtype)
    if rate:
        drop_x = ~keep_mask(SEED, x.shape[0], h, rate, dev, row0=ctx.n_slots)
        assert bool((got[0][drop_x] == 0).all())
    if enc:
        assert gb[1] is None and rb[1] is None
    assert sorted(gb[2]) == sorted(rb[2])
    _ea_vbwd_close(gb, rb, ctx)


@pytest.mark.parametrize("mode", ["hybrid", "autodiff"])
@pytest.mark.parametrize("dtype,h", [(torch.float32, 384),
                                     (torch.bfloat16, 640)])
def test_ea_simple_far_grad_modes_on_cuda(mode, dtype, h):
    """The variants on one shard of the "full" batch split in two tile
    ranges, in 'hybrid' and 'autodiff' mode (skip on, dropout 0.1): the
    forward and backward within their gates, the appended far rows'
    gradient included."""
    from buckgnn_tpu_torch.parallel.ea_shard import _ShardView, shard_ea_batch

    dev = _card()
    b, _, x_full, _, w, bias = _ea_case(dev, h, False, 45, dtype=dtype)
    shards = shard_ea_batch(b, 2).to(dev)
    fl = shards.cf_local if mode == "hybrid" else 0
    ctx = eb.make_ea_context(_ShardView(shards, 1), mode, fl)
    nl = ctx.n_local
    assert ctx.ext_ids is not None and ctx.n_nodes > nl
    x = eb.extended_rows(x_full[nl:2 * nl].contiguous(), ctx, x_full)
    g = torch.Generator(device=dev).manual_seed(47)
    t, wc = shards.sidx.shape[1:]
    e = torch.randn((t, wc, h), generator=g, device=dev).to(dtype)
    kw = dict(skip=True, rate=0.1, seed=SEED, enc=False)
    got = _ea_counted("ea_block_fwd_simple", lambda: eb.ea_block_fwd(
        x, e, w, bias, ctx, save_res=True, **kw))
    ref = eb.ea_block_fwd_plain(x, e, w, bias, ctx, save_res=True, **kw)
    _ea_vfwd_close(got, ref, ctx, h, dtype)
    dzx = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    dzx[nl:] = 0
    dze = torch.randn(e.shape, generator=g, device=dev).to(dtype)
    args = (dzx, dze, got[2], got[3], x, e, w, bias, ctx)
    gb = _ea_counted("ea_block_bwd_simple",
                     lambda: eb.ea_block_bwd(*args, **kw))
    rb = eb.ea_block_bwd_plain(*args, **kw)
    _ea_vbwd_close(gb, rb, ctx)
    n_ext = nl + ctx.ext_ids.numel()
    remote = rb[0][nl:n_ext]
    assert float(remote.float().abs().max()) > 0
    assert eb.rel_err(gb[0][nl:n_ext], remote) <= eb.bwd_tol("dx")
    assert (eb.row_rel_err(gb[0][nl:n_ext], remote)
            <= eb.bwd_tol("dx_row"))


@pytest.mark.parametrize("which", ["odd", "tile64"])
def test_ea_simple_is_deterministic(which):
    """No float atomics: two calls of each variant give the same bits, in
    encoder mode (float32 H 384) and with the skip (bf16 H 640), on
    batches with N / 64 odd."""
    dev = _card()
    for dtype, h, enc, skip in ((torch.float32, 384, True, False),
                                (torch.bfloat16, 640, False, True)):
        _, ctx, args, kw = _ea_bwd(dev, h, enc, skip, 0.1, seed=23,
                                   which=which, dtype=dtype)
        x, e, w, bias = args[4:8]
        outs = []
        for _ in range(2):
            fwd = eb.ea_block_fwd(x, e, w, bias, ctx, save_res=True, **kw)
            dx, de, dw, dbias = eb.ea_block_bwd(*args, **kw)
            outs.append(list(fwd) + [dx, dbias] + ([] if enc else [de])
                        + [dw[k] for k in sorted(dw)])
        torch.cuda.synchronize()
        for a, c in zip(*outs):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype,h", [(torch.float32, 384),
                                     (torch.bfloat16, 640)])
@pytest.mark.parametrize("which", ["full", "partial"])
def test_ea_simple_gates_catch_faults(dtype, h, which):
    """The variants' outputs against faulty plain versions, at the dtype's
    gates: a forward without its far senders, its cnt * b_p1 term or its
    skip fails eb.variant_fwd_tol; a backward without its sender fold (the
    halo, the far rows, one node's sender run, one far rank, the first
    tile's halo) fails dx's norm or row gate, and one without the far rows
    also dW_sp's."""
    dev = _card()
    b, ctx, args, kw = _ea_bwd(dev, h, False, True, 0.1, seed=33,
                               which=which, dtype=dtype)
    x, e, w, bias = args[4:8]
    zx, ze = eb.ea_block_fwd(x, e, w, bias, ctx, **kw)
    v = ctx.recv >= 0
    no_far = eb.sender_faults(b, ctx)["no-far-fold"]
    no_cnt_b = bias.clone()
    no_cnt_b[3] = 0.0

    def passes(got, ref):
        atol, rtol = eb.variant_fwd_tol(ref, dtype)
        err = (got.float() - ref.float()).abs()
        return not bool((err > atol + rtol * ref.float().abs()).any())

    for fault, fargs, fkw in (
            ("no-far", (x, e, w, bias, no_far), kw),
            ("no-cnt-b", (x, e, w, no_cnt_b, ctx), kw),
            ("no-skip", (x, e, w, bias, ctx), dict(kw, skip=False))):
        fzx, fze = eb.ea_block_fwd_plain(*fargs, **fkw)
        assert not (passes(fzx, zx) and passes(
            fze.reshape(-1, h)[v], ze.reshape(-1, h)[v])), fault
    got = eb.ea_block_bwd(*args, **kw)
    for fault, bad in eb.sender_faults(b, ctx).items():
        errs = eb.bwd_errors(got, eb.ea_block_bwd_plain(*args[:-1], bad, **kw),
                             ctx)
        assert (errs["dx"] > eb.bwd_tol("dx")
                or errs["dx_row"] > eb.bwd_tol("dx_row")), (fault, errs)
        if fault == "no-far-fold":
            assert errs["dwsp"] > eb.bwd_tol("dwsp"), errs
