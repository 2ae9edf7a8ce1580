"""The port's fused SAGE layer (buckgnn_tpu_torch.ops.sage_layer) == the JAX
package's `fused_sage_layer`, which runs its Pallas kernel `_fwd_kernel` in
interpret mode on the CPU at dropout rate 0.

Both sides get the same batch (packed from the same graphs by each
package), the same activations and the same weights, made with numpy from
a seed. Outputs are compared on node_mask rows: the dead row's band cell
is clipped at pack time and is not part of the contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.banded import make_agg_context as j_ctx
from buckgnn_tpu.ops.pallas_sage_layer import (
    fused_sage_layer as j_layer,
    star_source,
)
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context

H = 128
TILE, WIDTH = 128, 64


def _batches(supernode: bool, windows: bool = True, seed: int = 0):
    ds = generate_dataset(12, seed=seed, min_side=5, max_side=9,
                          use_super_node=supernode, use_virtual_edges=False)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(ds, ncap, ecap, 13, device="cpu", **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, 13, **kw)
    assert ncap // TILE >= 4 and not ours.has_spill_edges
    assert ours.has_supernode_edges == supernode
    if supernode:
        assert ours.gwin is not None
    if not windows:
        ours = ours.replace(gwin=None, lcode=None, lacc=None)
        ref = ref.replace(gwin=None, lcode=None, lacc=None)
    return ours, ref


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, H)).astype(np.float32)
    x[-1] = 0.0
    w_l = (rng.normal(size=(H, H)) * 0.1).astype(np.float32)
    b_l = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    w_r = (rng.normal(size=(H, H)) * 0.1).astype(np.float32)
    return x, w_l, b_l, w_r


def _run_both(ours, ref, dtype, skip, emit=False):
    x, w_l, b_l, w_r = _inputs(ours.n_node_cap)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jx, jwl, jbl, jwr = (jnp.asarray(a, jdt) for a in (x, w_l, b_l, w_r))
    ctx = j_ctx(ref, band_dtype=jdt, use_pallas=True)
    if emit:
        _, star = star_source(jx, ctx)
        jz, _, jtab = j_layer(jx, jwl, jbl, jwr, ctx, skip=skip, rate=0.0,
                              seed=None, deterministic=True, star_in=star,
                              emit_table=True)
    else:
        jz = j_layer(jx, jwl, jbl, jwr, ctx, skip=skip, rate=0.0, seed=None,
                     deterministic=True)
        jtab = None
    tx, twl, tbl, twr = (torch.from_numpy(a).to(dtype)
                         for a in (x, w_l, b_l, w_r))
    z, tab = sl.fused_sage_layer(tx, twl, tbl, twr, make_agg_context(ours),
                                 skip=skip, emit_table=emit)
    m = ours.node_mask.numpy()
    return (z.float().numpy()[m], np.asarray(jz, np.float32)[m],
            None if tab is None else tab.numpy(),
            None if jtab is None else np.asarray(jtab, np.float32))


# fp32: the algorithm. Both sides accumulate the same f32 products in a
# different order, so values agree to f32 round-off of O(1) sums.
@pytest.mark.parametrize("case", ["super_local", "super_full", "plain"])
@pytest.mark.parametrize("skip", [False, True])
def test_fused_layer_matches_jax_fp32(case, skip):
    ours, ref = _batches(supernode=case != "plain",
                         windows=case != "super_full")
    z, jz, _, _ = _run_both(ours, ref, torch.float32, skip)
    np.testing.assert_allclose(z, jz, rtol=1e-4, atol=1e-5)


def test_emitted_star_table_matches_jax_fp32():
    """The next layer's table summed from z (the kernel's emit) == the JAX
    kernel's ftab, on all tg rows."""
    ours, ref = _batches(supernode=True, seed=1)
    z, jz, tab, jtab = _run_both(ours, ref, torch.float32, skip=True,
                                 emit=True)
    np.testing.assert_allclose(z, jz, rtol=1e-4, atol=1e-5)
    assert tab.shape == jtab.shape
    np.testing.assert_allclose(tab, jtab, rtol=1e-4, atol=1e-4)


def test_fused_layer_matches_jax_bf16():
    """bf16 activations and weights, f32 accumulation on both sides. A
    different summation order can round z to the neighbouring bf16 value,
    which the kernel's own gate sl.KERNEL_Z_TOL allows (its reasons stand
    beside it). Each such flip moves the table, a sum of z rows, by one
    ulp of z: under 0.04 for |z| < 8, so atol 4e-2 plus f32 round-off."""
    ours, ref = _batches(supernode=True, seed=2)
    z, jz, tab, jtab = _run_both(ours, ref, torch.bfloat16, skip=True,
                                 emit=True)
    atol, rtol = sl.KERNEL_Z_TOL
    np.testing.assert_allclose(z, jz, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tab, jtab, rtol=1e-4, atol=4e-2)


@pytest.mark.parametrize("fault,caught", [
    ("one_ulp", False), ("norm_7_8", True), ("no_bias", True)])
def test_kernel_gate_catches_faults(fault, caught):
    """sl.KERNEL_Z_TOL, the gate the CUDA kernel is held to against the
    plain version, passes a z with every value one bf16 ulp away and fails
    a layer with its norm taken over 7/8 of the sum of squares (relu(y)
    scaled by sqrt(8/7), no skip) or without b_l. Inputs as the kernel's
    tests draw them: x ~ N(0, 1), lecun-normal W, b_l ~ N(0, 1)."""
    ours, _ = _batches(supernode=True, seed=3)
    rng = np.random.default_rng(5)
    n = ours.n_node_cap
    x, w_l, b_l, w_r = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                        for a in (rng.normal(size=(n, H)),
                                  rng.normal(size=(H, H)) / np.sqrt(H),
                                  rng.normal(size=(H,)),
                                  rng.normal(size=(H, H)) / np.sqrt(H)))
    code, gwin, gw, _ = sl.star_codes(ours)
    t0, tg = tb.star_table_geometry(ours.n_graph_cap)
    table = sl._super_tables(x, ours.node_graph, ours.node_mask,
                             ours.supernode_index, ours.n_graph_cap, tg)
    kw = dict(tile=TILE, width=WIDTH, table=table, code=code, gwin=gwin,
              gw=gw, t0=t0, skip=False)
    band = make_agg_context(ours).band
    ref, _ = sl.sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    if fault == "one_ulp":   # magnitude up one ulp (the bf16 bits + 1)
        got = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    elif fault == "norm_7_8":
        got = (ref.float() * np.sqrt(8 / 7)).bfloat16()
    else:
        got, _ = sl.sage_layer_plain(x, w_l, torch.zeros_like(b_l), w_r,
                                     band, **kw)
    m = ours.node_mask
    atol, rtol = sl.KERNEL_Z_TOL
    err = (got[m].float() - ref[m].float()).abs()
    assert bool((err > atol + rtol * ref[m].float().abs()).any()) == caught


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    ours, _ = _batches(supernode=True, seed=3)
    x, w_l, b_l, w_r = (torch.from_numpy(a)
                        for a in _inputs(ours.n_node_cap, seed=3))
    ctx = make_agg_context(ours)
    code, gwin, gw, acc = sl.star_codes(ours)
    t0, tg = tb.star_table_geometry(ours.n_graph_cap)
    table = sl._super_tables(x, ours.node_graph, ours.node_mask,
                             ours.supernode_index, ours.n_graph_cap, tg)
    kw = dict(tile=TILE, width=WIDTH, table=table, code=code, gwin=gwin,
              gw=gw, t0=t0, acc_code=acc, skip=True, emit=True)
    before = sl.LAUNCHES["sage_layer_fwd"]
    z, tab = sl.sage_layer_fwd(x, w_l, b_l, w_r, ctx.band, **kw)
    zp, tabp = sl.sage_layer_plain(x, w_l, b_l, w_r, ctx.band, **kw)
    assert sl.LAUNCHES["sage_layer_fwd"] == before
    assert torch.equal(z, zp) and torch.equal(tab, tabp)


def _flop_case(n=256, h=32, tile=64, width=16, gw=8, t0=16, seed=7):
    """Random operands of one layer at a small shape (T + W = 80, so K1 %
    32 = 16 as the kernel's phase 1 pads it): the counter reads shapes."""
    rng = np.random.default_rng(seed)
    nt = n // tile
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    i32 = lambda hi, *s: torch.from_numpy(
        rng.integers(0, hi, size=s).astype(np.int32))
    band = torch.from_numpy(rng.integers(0, 3, size=(nt, tile, tile + width))
                            .astype(np.int8))
    x, w_l, b_l, w_r = f32(n, h), f32(h, h), f32(h), f32(h, h)
    star = dict(table=f32(2 * t0, h), code=i32(2 * gw + 1, nt, tile),
                gwin=i32(t0 - gw + 1, nt), gw=gw, t0=t0,
                acc_code=i32(2 * gw + 1, nt, tile))
    return (x, w_l, b_l, w_r, band), star


def _count(fn, *args, **kw):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kw)
    return fc.get_total_flops(), out


@pytest.mark.parametrize("case", ["plain", "super", "super_emit", "spill"])
def test_forward_pass_flops_match_the_flop_counter(case):
    """`sl.pass_flops` (the per-pass operation counts behind chip_smoke.py's
    bounds and its sage_pass lines) against
    torch.utils.flop_counter.FlopCounterMode over the plain forward: the
    band and star selection as dense one-hot products, both weights, the
    emitted table by accumulate code. The spill case adds the plain
    version's one-hot [T, SPILL_CHUNK] product with the message window by
    formula: the kernels take those sums as f32 adds, not a product."""
    args, star = _flop_case()
    x = args[0]
    n, h = x.shape
    kw = dict(tile=64, width=16)
    extra = 0
    if case.startswith("super"):
        kw.update(star, emit=case == "super_emit")
    if case == "spill":
        rng = np.random.default_rng(8)
        nt = n // 64
        lo = rng.integers(0, 4, size=n).astype(np.int32)
        kw.update(spill_offsets=torch.arange(0, 64 * (nt + 1), 64,
                                             dtype=torch.int32),
                  spill_lo=torch.from_numpy(lo),
                  spill_hi=torch.from_numpy(lo + 2),
                  spill_messages=torch.from_numpy(rng.normal(
                      size=(tb.SPILL_CHUNK + 64, h)).astype(np.float32)))
        extra = 2 * n * tb.SPILL_CHUNK * h
    got, _ = _count(sl.sage_layer_plain, *args, **kw)
    want = sl.pass_flops(n, h, 64, 16, star["gw"],
                         has_super=case.startswith("super"),
                         emit=case == "super_emit")
    assert got == sum(want[k] for k in sl.FWD_PASSES) + extra


@pytest.mark.parametrize("case", ["plain", "super", "super_prev"])
def test_backward_pass_flops_match_the_flop_counter(case):
    """The merged backward's passes (tile, band, weights) summed against
    the counter over `sage_layer_bwd_plain`: dout @ W_l^T and W_r^T, the
    band product of dagg, both weight products, the own table and (with
    the next layer's star) the selection on dz."""
    args, star = _flop_case(seed=9)
    x, w_l, _, w_r, band = args
    n, h = x.shape
    sup = case != "plain"
    kw = dict(tile=64, width=16, has_super=sup)
    if sup:
        kw.update({k: star[k] for k in ("code", "gwin", "gw", "t0",
                                        "acc_code")})
    if case == "super_prev":
        kw["table_prev"] = star["table"]
    rng = np.random.default_rng(10)
    dz, y, agg = (torch.from_numpy(rng.normal(size=(n, h)).astype(
        np.float32)) for _ in range(3))
    inv = torch.ones(n)
    got, _ = _count(sl.sage_layer_bwd_plain, dz, y, inv, agg, x, w_l, w_r,
                    band, **kw)
    want = sl.pass_flops(n, h, 64, 16, star["gw"], has_super=sup,
                         apply_prev=case == "super_prev")
    assert got == sum(want[k] for k in sl.BWD_PASSES)


@pytest.mark.parametrize("sup", [False, True])
def test_tile_pass_flops_match_the_flop_counter(sup):
    """The split backward's tile kernel (#3): its tile and weight passes
    against the counter over `sage_layer_bwd_tile_plain`, the own table of
    a supernode batch over the whole [tg, H] table."""
    args, star = _flop_case(seed=11)
    x, w_l, _, w_r, _ = args
    n, h = x.shape
    tg = 2 * star["t0"]
    rng = np.random.default_rng(12)
    dz, y, agg = (torch.from_numpy(rng.normal(size=(n, h)).astype(
        np.float32)) for _ in range(3))
    acc = (torch.from_numpy(rng.integers(0, tg + 1, size=(n // 64, 1, 64))
                            .astype(np.int32)) if sup else None)
    got, _ = _count(sl.sage_layer_bwd_tile_plain, dz, y, torch.ones(n), agg,
                    x, w_l, w_r, tile=64, acc_code=acc, tg=tg)
    want = sl.pass_flops(n, h, 64, 0, 0, has_super=sup, tg=tg)
    assert got == sum(want[k] for k in sl.TILE_PASSES)


def test_pass_flops_at_the_flagship_shape():
    """The flagship's counts behind chip_smoke.py's bounds: #1 149.1 GFLOP
    (star selection and emit, N = 103,424, T + W = 320, 2GW = 32, H = 512)
    and #2 257.6 GFLOP (with the next layer's star)."""
    pf = sl.pass_flops(103424, 512, 256, 64, 16, has_super=True, emit=True)
    assert round(sum(pf[k] for k in sl.FWD_PASSES) / 1e9, 1) == 149.1
    pb = sl.pass_flops(103424, 512, 256, 64, 16, has_super=True,
                       apply_prev=True)
    assert round(sum(pb[k] for k in sl.BWD_PASSES) / 1e9, 1) == 257.6
