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
