"""The port's fused SAGE layer backward (buckgnn_tpu_torch.ops.sage_layer).

On the CPU the layer's ``torch.autograd.Function`` runs `sage_layer_bwd_plain`,
the plain version of the CUDA kernel `sage_layer_bwd`. It is held to:

- the JAX package's `fused_sage_layer` gradients (its merged backward
  `_bwd_merged_kernel`, Pallas in interpret mode at dropout rate 0), for one
  layer and for a threaded 3-layer chain (`star_source`, star_in/star_next,
  table_in/emit_table);
- PyTorch autograd of the plain forward `sage_layer_plain`, at dropout rates
  0 and 0.1 with the same seeds: this holds the mask regeneration and the
  use of the forward's band for dx (the adjacency is symmetric);
- the kernel's own gate (``sl.KERNEL_BWD_TOL``), which must fail a
  backward without the norm's s term and one without the next layer's star.

Both sides get the same packed graphs, activations and weights, made with
numpy from a seed. dx is compared on node_mask rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.banded import make_agg_context as j_ctx
from buckgnn_tpu.ops.pallas_sage_layer import (
    fused_sage_layer as j_layer,
    star_source as j_star_source,
)
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context

H = 128
TILE, WIDTH = 128, 64
SEED = (0x2545F491, 0x9E3779B9)
# fp32 against JAX: both sides run the same algorithm in float32 and sum in
# another order, so gradients agree to f32 round-off of sums of O(100)
# terms: 1e-4 relative, with an absolute floor of 1e-5 of the largest entry
# for entries that cancel to near zero.
RTOL, ATOL_FRAC = 1e-4, 1e-5


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


def _weights(rng):
    return [(rng.normal(size=s) * 0.1).astype(np.float32)
            for s in ((H, H), (H,), (H, H))]


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", ["super_local", "super_full", "plain"])
@pytest.mark.parametrize("skip", [False, True])
def test_layer_grads_match_jax_fp32(case, skip):
    """dx, dW_l, db_l and dW_r of one layer == jax.vjp of the JAX layer."""
    ours, ref = _batches(supernode=case != "plain",
                         windows=case != "super_full", seed=1)
    n = ours.n_node_cap
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, H)).astype(np.float32)
    x[-1] = 0.0
    w_l, b_l, w_r = _weights(rng)
    probe = rng.normal(size=(n, H)).astype(np.float32)
    probe *= ours.node_mask.numpy()[:, None]

    ctx = j_ctx(ref, band_dtype=jnp.float32, use_pallas=True)
    _, vjp = jax.vjp(
        lambda *a: j_layer(*a, ctx, skip=skip, rate=0.0,
                           seed=jnp.zeros((2,), jnp.int32),
                           deterministic=False),
        *(jnp.asarray(a) for a in (x, w_l, b_l, w_r)))
    want = vjp(jnp.asarray(probe))

    params = [torch.from_numpy(a).requires_grad_() for a in (x, w_l, b_l, w_r)]
    z, _ = sl.fused_sage_layer(*params, make_agg_context(ours), skip=skip,
                               deterministic=False)
    (z * torch.from_numpy(probe)).sum().backward()
    m = ours.node_mask.numpy()
    _close(params[0].grad.numpy()[m], np.asarray(want[0])[m], "dx")
    for p, w, name in zip(params[1:], want[1:], ("dW_l", "db_l", "dW_r")):
        _close(p.grad.numpy(), w, name)


def test_threaded_chain_grads_match_jax_fp32():
    """A 3-layer chain with star threading (star_source, star_in/star_next,
    table_in/emit_table): each layer's own star table leaves through its
    ghost input and the layer below adds it to its dz. The loss and the
    gradients of x and of all three layers' weights == the JAX chain's."""
    ours, ref = _batches(supernode=True, seed=5)
    n = ours.n_node_cap
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, H)).astype(np.float32)
    x[-1] = 0.0
    ws = [_weights(rng) for _ in range(3)]
    probe = rng.normal(size=(n, H)).astype(np.float32)
    probe *= ours.node_mask.numpy()[:, None]
    ctx = j_ctx(ref, band_dtype=jnp.float32, use_pallas=True)

    def j_loss(x, ws):
        z, star = j_star_source(x, ctx)
        table = None
        for i, (w_l, b_l, w_r) in enumerate(ws):
            z, star, table = j_layer(
                z, w_l, b_l, w_r, ctx, skip=i == 1, rate=0.0,
                seed=jnp.zeros((2,), jnp.int32), deterministic=False,
                star_in=star, star_next=i < 2, table_in=table,
                emit_table=i < 2)
        return jnp.sum(z * probe)

    jws = [tuple(jnp.asarray(a) for a in w) for w in ws]
    j_val, (j_dx, j_dws) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jws)

    tx = torch.from_numpy(x).requires_grad_()
    tws = [[torch.from_numpy(a).requires_grad_() for a in w] for w in ws]
    tctx = make_agg_context(ours)
    z, star = sl.star_source(tx, tctx)
    table = None
    for i, (w_l, b_l, w_r) in enumerate(tws):
        z, star, table = sl.fused_sage_layer(
            z, w_l, b_l, w_r, tctx, skip=i == 1, deterministic=False,
            star_in=star, star_next=i < 2, table_in=table, emit_table=i < 2)
    loss = (z * torch.from_numpy(probe)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=RTOL)
    m = ours.node_mask.numpy()
    _close(tx.grad.numpy()[m], np.asarray(j_dx)[m], "dx")
    for i, (tw, jw) in enumerate(zip(tws, j_dws)):
        for p, w, name in zip(tw, jw, ("dW_l", "db_l", "dW_r")):
            _close(p.grad.numpy(), w, f"layer {i} {name}")


def _plain_layer(x, w_l, b_l, w_r, batch, skip, rate):
    """The plain forward as a function autograd differentiates whole: the
    star table is built from x inside the graph."""
    code, gwin, gw, _ = sl.star_codes(batch)
    t0, tg = tb.star_table_geometry(batch.n_graph_cap)
    table = sl._super_tables(x, batch.node_graph, batch.node_mask,
                             batch.supernode_index, batch.n_graph_cap, tg)
    z, _ = sl.sage_layer_plain(
        x, w_l, b_l, w_r, make_agg_context(batch).band, tile=TILE,
        width=WIDTH, table=table, code=code, gwin=gwin, gw=gw, t0=t0,
        skip=skip, rate=rate, seed=SEED if rate else None)
    return z


@pytest.mark.parametrize("windows", [True, False])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_custom_backward_matches_autograd(windows, skip, rate):
    """The layer's Function (forward with residuals, `sage_layer_bwd_plain`,
    own star folded into dx) == autograd of `sage_layer_plain` with the
    table built from x, at the same dropout seeds. fp32, the same
    operations in another order: 1e-5 relative."""
    ours, _ = _batches(supernode=True, windows=windows, seed=7)
    n = ours.n_node_cap
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, H)).astype(np.float32)
    probe = torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32))
    arrays = [x, *_weights(rng)]
    fused = [torch.from_numpy(a).requires_grad_() for a in arrays]
    z, _ = sl.fused_sage_layer(*fused, make_agg_context(ours), skip=skip,
                               rate=rate, seed=SEED, deterministic=False)
    (z * probe).sum().backward()
    plain = [torch.from_numpy(a).requires_grad_() for a in arrays]
    zp = _plain_layer(*plain, ours, skip, rate)
    (zp * probe).sum().backward()
    assert torch.equal(z, zp)
    if rate:
        assert 0.05 < float((zp == 0).float().mean()) < 0.6
    for a, b, name in zip(fused, plain, ("dx", "dW_l", "db_l", "dW_r")):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-6 * scale, msg=name)


def _bwd_inputs(seed=9):
    """bf16 inputs of one backward call as the kernel gets them, with the
    next layer's table (apply_prev) and dropout 0.1."""
    ours, _ = _batches(supernode=True, seed=3)
    rng = np.random.default_rng(seed)
    n = ours.n_node_cap
    x, w_l, b_l, w_r = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                        for a in (rng.normal(size=(n, H)),
                                  rng.normal(size=(H, H)) / np.sqrt(H),
                                  rng.normal(size=(H,)),
                                  rng.normal(size=(H, H)) / np.sqrt(H)))
    code, gwin, gw, acc = sl.star_codes(ours)
    t0, tg = tb.star_table_geometry(ours.n_graph_cap)
    table = sl._super_tables(x, ours.node_graph, ours.node_mask,
                             ours.supernode_index, ours.n_graph_cap, tg)
    band = make_agg_context(ours).band
    star = dict(tile=TILE, width=WIDTH, code=code, gwin=gwin, gw=gw, t0=t0,
                skip=True, rate=0.1, seed=SEED)
    _, _, y, inv, agg = sl.sage_layer_plain(x, w_l, b_l, w_r, band,
                                            table=table, save_res=True,
                                            **star)
    dz = torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32))
    tprev = torch.from_numpy(rng.normal(size=(tg, H)).astype(np.float32))
    kw = dict(star, table_prev=tprev.bfloat16(), acc_code=acc,
              has_super=True)
    return ours, (dz.bfloat16(), y, inv, agg, x, w_l, w_r, band), kw


def _caught(got, ref, node_mask):
    """Does any output fail its sl.KERNEL_BWD_TOL gate?"""
    for name, g, r in zip(("dx", "dw_l", "dw_r", "db_l", "town"), got, ref):
        if name == "dx":
            g, r = g[node_mask], r[node_mask]
        atol, rtol = sl.gate_tol(r, sl.KERNEL_BWD_TOL[name])
        if bool(((g.float() - r.float()).abs()
                 > atol + rtol * r.float().abs()).any()):
            return True
    return False


@pytest.mark.parametrize("fault,caught", [
    ("one_ulp", False), ("no_s_term", True), ("no_apply_prev", True)])
def test_bwd_gate_catches_faults(monkeypatch, fault, caught):
    """sl.KERNEL_BWD_TOL, the gate the CUDA backward is held to against
    its plain version, passes a dx with every value one bf16 ulp away and
    fails a plain backward whose norm backward drops the s term
    (dout = dy * inv) or that ignores the next layer's star table."""
    ours, args, kw = _bwd_inputs()
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    if fault == "one_ulp":   # magnitude up one ulp (the bf16 bits + 1)
        dx = (ref[0].view(torch.int16) + 1).view(torch.bfloat16)
        got = (dx, *ref[1:])
    elif fault == "no_s_term":
        monkeypatch.setattr(
            sl, "_norm_backward",
            lambda dz, y, inv: torch.where(y > 0.0, dz, 0.0) * inv)
        got = sl.sage_layer_bwd_plain(*args, **kw)
    else:
        got = sl.sage_layer_bwd_plain(*args, **dict(kw, table_prev=None))
    assert _caught(got, ref, ours.node_mask) == caught


def test_bwd_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the backward wrapper runs the plain version and
    launches nothing; the plain version never calls the wrapper."""
    _, args, kw = _bwd_inputs()
    before = sl.LAUNCHES["sage_layer_bwd"]
    got = sl.sage_layer_bwd(*args, **kw)
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    assert sl.LAUNCHES["sage_layer_bwd"] == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_bwd_scope_guards():
    """The backward raises on what the fused path does not take: dropout
    without seeds, apply_prev without a supernode batch, and a dropout
    layer called in training without seeds."""
    ours, args, kw = _bwd_inputs()
    with pytest.raises(ValueError, match="seed"):
        sl.sage_layer_bwd(*args, **dict(kw, seed=None))
    x = args[4].float().requires_grad_()
    w = [a.float() for a in (args[5], torch.zeros(H), args[6])]
    with pytest.raises(ValueError, match="seed"):
        sl.fused_sage_layer(x, *w, make_agg_context(ours), skip=False,
                            rate=0.1, deterministic=False)
    plain, _ = _batches(supernode=False)
    with pytest.raises(ValueError, match="supernode"):
        sl.fused_sage_layer(x[:plain.n_node_cap], *w,
                            make_agg_context(plain), skip=False,
                            deterministic=False,
                            star_in=torch.zeros(8, H))
