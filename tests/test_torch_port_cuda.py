"""The CUDA fused-layer kernels against their plain PyTorch versions, on the card.

This file imports only the port (no JAX), so it runs on a machine with a
card and no JAX. The repo's conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Here, with no card, every case skips: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
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


def _batch(dev, supernode=True):
    ds = generate_dataset(12, seed=4, min_side=5, max_side=9,
                          use_super_node=supernode, use_virtual_edges=False)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, 13, band_width=WIDTH, band_tile=TILE,
                       device="cpu")
    assert not b.has_spill_edges and b.has_supernode_edges == supernode
    return b.to(dev)


def _inputs(n, h, dev, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    w_l = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    # a bias as large as x @ W_r's entries, so a dropped b_l fails the gate
    b_l = rng.normal(size=(h,)).astype(np.float32)
    w_r = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    return [torch.from_numpy(a).to(dev, torch.bfloat16)
            for a in (x, w_l, b_l, w_r)]


def _layer(dev, h, star, seed):
    """(batch, x, W_l, b_l, W_r, band, star kwargs) for one case; star is
    "local", "local_emit", "full" (the whole table) or "none"."""
    b = _batch(dev, supernode=star != "none")
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


def _bwd_case(dev, h, star, apply_prev, skip, rate, seed=7):
    """Inputs of one backward call: residuals from the kernel's own
    training forward, a random dz and (apply_prev) a random bf16
    next-layer table."""
    b, x, w_l, b_l, w_r, band, kw = _layer(dev, h, star, seed=seed)
    fwd = dict(kw, tile=TILE, width=WIDTH, skip=skip, save_res=True,
               rate=rate, seed=SEED if rate else None)
    _, _, y, inv, agg = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **fwd)
    rng = np.random.default_rng(seed + 1)
    dz = torch.from_numpy(rng.normal(size=(b.n_node_cap, h)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bwd = dict(tile=TILE, width=WIDTH, skip=skip, rate=rate,
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
