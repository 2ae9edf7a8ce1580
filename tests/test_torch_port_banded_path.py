"""The port's unfused banded SAGE path == the JAX package's.

`ops/banded.py` (the device band build, the aggregation context, the
banded sum over the band, the spill and spill2 lists and the supernode
stars, its symmetric VJP) against buckgnn_tpu/ops/banded.py on three
batches: supernode panels (stars, no spill), virtual-edge panels (spill)
and one graph whose hub receives 320 out-of-band edges, more than its
tile's spill window holds (spill2). Then the weight-tied model on that
path (``remat=True``, and the spill2 batch the fused layer refuses)
against the JAX model with the same config, and against the port's own
fused route.

Every JAX call stays off interpret mode: at H = 32 both sides take the
slab product; at H = 128 the port's ``banded_pallas`` route runs kernel
#4's plain version (spill in the window) and is held to JAX
``use_pallas=False`` (the same terms summed in another order). Float32
throughout: 1e-5 relative with an absolute floor of 1e-5 of the largest
entry for the aggregation, the model tests' 1e-4 for whole models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.models import BuckGNN as JBuckGNN
from buckgnn_tpu.ops import banded as jbd
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.ops import banded as bd
from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import sage_layer as sl

TILE, WIDTH = 128, 64
AGG_RTOL, AGG_ATOL_FRAC = 1e-5, 1e-5
PRED_RTOL, PRED_ATOL, GRAD_REL = 1e-4, 1e-5, 1e-4


def _pack(ds, n_graphs, tile=TILE, width=WIDTH, materialize=True):
    n = sum(g.n_node for g in ds) + 1
    ncap = ((max(n, tile + width) + tile - 1) // tile) * tile
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=width, band_tile=tile)
    ours = tb.pack_graphs(ds, ncap, ecap, n_graphs + 1, device="cpu",
                          materialize_band=materialize, **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, n_graphs + 1,
                         materialize_band=materialize, **kw)
    return ours, ref


def _super(materialize=True):
    ds = generate_dataset(6, seed=3, min_side=6, max_side=8,
                          use_super_node=True, use_virtual_edges=False)
    ours, ref = _pack(ds, 6, materialize=materialize)
    assert ours.has_supernode_edges and not ours.has_spill_edges
    return ds, ours, ref


def _virtual(materialize=True):
    ds = generate_dataset(8, seed=4, min_side=6, max_side=8,
                          use_super_node=False, use_virtual_edges=True)
    ours, ref = _pack(ds, 8, materialize=materialize)
    assert ours.has_spill_edges and not ours.has_spill2_edges
    return ds, ours, ref


def _hub(materialize=True):
    """One graph whose node 0 receives 320 out-of-band edges: more than
    its tile's spill window holds, so spill2 carries the overflow
    (tests/test_banded.py::test_fused_spill_with_tile_cap_overflow)."""
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
    ours, ref = _pack([g], 1, tile=256, width=128, materialize=materialize)
    assert ours.has_spill2_edges and ours.has_spill_edges
    return [g], ours, ref


BATCHES = {"super": _super, "virtual": _virtual, "spill2": _hub}


def _close(got, want, what, rtol=AGG_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = AGG_ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_device_band_build_matches_packed_band_and_jax(case):
    """`build_band_matrix` on a batch packed with materialize_band=False:
    int8, bit for bit the pack-time band, and equal to JAX
    `build_band_matrix` off the dead row's pad cell (JAX does not clip
    its stacked pad loops); the context takes it."""
    _, packed, _ = BATCHES[case]()
    _, ours, ref = BATCHES[case](materialize=False)
    assert ours.band is None
    band = bd.build_band_matrix(ours)
    assert band.dtype == torch.int8
    want = packed.band.reshape(band.shape)
    assert torch.equal(band, want)
    jband = np.asarray(jbd.build_band_matrix(ref)).reshape(band.shape)
    live = np.ones(band.shape, bool)
    n = ours.n_node_cap
    live.reshape(n, -1)[n - 1] = False
    np.testing.assert_array_equal(band.numpy()[live],
                                  jband[live].astype(np.int8))
    assert torch.equal(bd.make_agg_context(ours).band, band)


def test_device_band_build_refuses_counts_over_127():
    """128 copies of one edge cannot be an int8 count."""
    _, ours, _ = _super(materialize=False)
    s, r = ours.band_senders, ours.band_receivers
    dup = ours.replace(band_senders=torch.cat([s, s[:1].repeat(128)]),
                       band_receivers=torch.cat([r, r[:1].repeat(128)]))
    with pytest.raises(ValueError, match="127"):
        bd.build_band_matrix(dup)


def _x(batch, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch.n_node_cap, h)).astype(np.float32)
    return x


@pytest.mark.parametrize("case", sorted(BATCHES))
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_banded_aggregate_matches_jax(case, aggr):
    """The aggregation (H = 32, the slab product; and H = 128 on the
    port's kernel route, the spill list in kernel #4's window) against JAX
    `banded_sage_aggregate` with use_pallas=False."""
    _, ours, ref = BATCHES[case]()
    need = aggr == "mean"
    jctx = jbd.make_agg_context(ref, need_degree=need)
    for h, pallas in ((32, False), (128, True)):
        x = _x(ours, h, seed=h)
        want = jbd.banded_sage_aggregate(jnp.asarray(x), jctx, aggr=aggr)
        ctx = bd.make_agg_context(ours, use_pallas=pallas, need_degree=need)
        got = bd.banded_sage_aggregate(torch.from_numpy(x), ctx, aggr=aggr)
        _close(got.numpy(), np.asarray(want), f"{case}/{aggr}/h{h}")


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_banded_aggregate_vjp_matches_jax(case, monkeypatch):
    """The symmetric VJP (the same aggregation of the cotangent; spill
    messages are the cotangent's rows) against `jax.vjp` of the JAX
    aggregation, add and mean, on both of the port's routes; the kernel
    route's backward runs the band product again."""
    _, ours, ref = BATCHES[case]()
    calls = []
    real = bm.banded_matmul_plain

    def counted(*a, **k):
        calls.append(k.get("spill_offsets") is not None)
        return real(*a, **k)

    monkeypatch.setattr(bd, "banded_matmul", counted)
    for aggr in ("add", "mean"):
        for h, pallas in ((32, False), (128, True)):
            x = _x(ours, h, seed=h + 1)
            g = _x(ours, h, seed=h + 2)
            jctx = jbd.make_agg_context(ref, need_degree=aggr == "mean")
            _, vjp = jax.vjp(lambda v: jbd.banded_sage_aggregate(
                v, jctx, aggr=aggr), jnp.asarray(x))
            (want,) = vjp(jnp.asarray(g))
            ctx = bd.make_agg_context(ours, use_pallas=pallas,
                                      need_degree=aggr == "mean")
            tx = torch.from_numpy(x).requires_grad_()
            calls.clear()
            bd.banded_sage_aggregate(tx, ctx, aggr=aggr).backward(
                torch.from_numpy(g))
            _close(tx.grad.numpy(), np.asarray(want), f"{case}/{aggr}/h{h}")
            assert calls == ([ours.has_spill_edges] * 2 if pallas else [])


def test_max_aggregate_vjp_at_ties_matches_jax():
    """'max' takes the gather path; where several neighbours hold the
    maximum (every row duplicated, rounded to a coarse grid), both sides
    split the cotangent evenly among them."""
    _, ours, ref = _super()
    rng = np.random.default_rng(7)
    x = np.round(rng.normal(size=(ours.n_node_cap, 32)) * 2) / 2
    x = x.astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jctx = jbd.make_agg_context(ref)
    _, vjp = jax.vjp(lambda v: jbd.banded_sage_aggregate(v, jctx, "max"),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    bd.banded_sage_aggregate(tx, bd.make_agg_context(ours), "max").backward(
        torch.from_numpy(g))
    s, r = ours.senders.long(), ours.receivers.long()
    msgs = torch.from_numpy(x)[s]
    best = torch.zeros(x.shape).index_reduce_(0, r, msgs, "amax",
                                              include_self=False)
    hits = torch.zeros(x.shape).index_add_(0, r, (msgs == best[r]).float())
    assert int((hits[:-1] >= 2).sum()) > 100, "ties at the maximum"
    _close(tx.grad.numpy(), np.asarray(want), "max/ties")


def test_band_route_follows_the_jax_rule_and_the_cards_limits():
    """Kernel #4 when use_pallas and H % 128 == 0 (else the slab product);
    on the card one of its variants takes float32 and bf16 at every such
    width (the engine bf16 at H in {128, 256, 512}, sage_simple.cu the
    rest), and another dtype raises there rather than take the slab
    product."""
    assert bd.band_route("cpu", torch.float32, 128, True)
    assert bd.band_route("cpu", torch.float32, 384, True)
    assert not bd.band_route("cpu", torch.float32, 32, True)
    assert not bd.band_route("cuda", torch.float32, 128, False)
    assert not bd.band_route("cuda", torch.bfloat16, 96, True)
    for h in (128, 256, 384, 512, 640, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            assert bd.band_route("cuda", dtype, h, True)
            want = ("engine" if dtype == torch.bfloat16
                    and h in (128, 256, 512) else "simple")
            assert bd.kernel_variant(dtype, h) == want
    for dtype, h in ((torch.float16, 128), (torch.float64, 384)):
        with pytest.raises(NotImplementedError, match="kernel #4"):
            bd.band_route("cuda", dtype, h, True)


def test_partitioned_batches_raise_naming_item_9():
    """A partitioned context needs batch.part and raises without it, as the
    JAX package's make_agg_context (item 9's refusal is gone: the
    partitioned aggregation is parallel/partitioned.py). With one shard it
    is the banded sum, forward and backward, and the model runs it."""
    from buckgnn_tpu_torch.parallel.partitioned import partition_batch

    _, ours, _ = _super()
    with pytest.raises(ValueError, match="batch.part"):
        bd.make_agg_context(ours, partitioned=True)
    part = ours.replace(part=partition_batch(ours, 1))
    ctx = bd.make_agg_context(part, partitioned=True)
    assert ctx.part is part.part and ctx.band is None
    g = torch.Generator().manual_seed(0)
    x = torch.randn((ours.n_node_cap, 16), generator=g)
    probe = torch.randn(x.shape, generator=g)
    got_x, want_x = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = bd.banded_sage_aggregate(got_x, ctx)
    want = bd.banded_sage_aggregate(want_x, bd.make_agg_context(ours))
    (got * probe).sum().backward()
    (want * probe).sum().backward()
    m = ours.node_mask
    torch.testing.assert_close(got[m], want[m], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_x.grad[m], want_x.grad[m], rtol=1e-5,
                               atol=1e-5)
    model = BuckGNN(ours.nodes.shape[1], 5, hidden_channels=32,
                    num_layers=2, impl="banded_partitioned")
    pred, _ = model(part)
    assert bool(torch.isfinite(pred[ours.graph_mask]).all())


def _kw(ds, h, **extra):
    return dict(num_node_features=ds[0].x.shape[1], num_edge_features=5,
                hidden_channels=h, num_layers=3, pooling_layer="mean",
                dropout_rate=0.0, model_name="GraphSage_addAggr_Shared",
                **extra)


def _jax_params(kw, ref, seed=1):
    params = JBuckGNN(impl="xla", **kw).init(
        jax.random.key(seed), ref, deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + ((rng.normal(size=p.shape) * 0.05).astype(
            np.float32) if p.ndim == 1 else np.float32(0.0)), params)


def _grads_jax(model, params, batch):
    def f(p):
        pred, _ = model.apply({"params": p}, batch, deterministic=True)
        return jnp.sum(jnp.where(batch.graph_mask, pred, 0.0) ** 2), pred

    (_, pred), g = jax.value_and_grad(f, has_aux=True)(params)
    return np.asarray(pred), params_from_flax(jax.tree.map(np.asarray, g))


def _grads_port(model, batch):
    model.zero_grad(set_to_none=True)
    pred, _ = model(batch, deterministic=True)
    (torch.where(batch.graph_mask, pred, 0.0) ** 2).sum().backward()
    return pred.detach().numpy(), {k: p.grad.clone() for k, p in
                                   model.named_parameters()}


def _rel_close(got, want, what, tol=GRAD_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / denom < tol, what


def _hold(port, ours, jmodel, params, ref):
    jpred, jgrads = _grads_jax(jmodel, params, ref)
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    pred, grads = _grads_port(port, ours)
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(pred[gm], jpred[gm], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    assert grads.keys() == jgrads.keys()
    for k in jgrads:
        _rel_close(grads[k], jgrads[k], k)
    return pred


@pytest.mark.parametrize("case", ["super", "virtual"])
@pytest.mark.parametrize("impl", ["banded", "banded_pallas"])
def test_remat_model_matches_jax(case, impl, monkeypatch):
    """GraphSage_addAggr_Shared with remat=True (unfused convs under
    torch.utils.checkpoint, no fused layer) against the JAX model with the
    same impl at H = 32 (slab products on both sides, no fused layer):
    pred and every gradient. The JAX model runs without remat: its
    nn.remat(SAGEConv) cannot take the banded AggContext as an argument
    (a TypeError on any banded batch), and remat changes memory, not math
    (tests/test_model.py::test_remat_matches_plain)."""
    ds, ours, ref = BATCHES[case]()

    def refuse(*a, **k):
        raise AssertionError("the fused layer was called")

    monkeypatch.setattr(sl, "fused_sage_layer", refuse)
    kw = _kw(ds, 32)
    params = _jax_params(kw, ref)
    _hold(BuckGNN(impl=impl, remat=True, **kw), ours,
          JBuckGNN(impl=impl, **kw), params, ref)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_kernel_route_model_matches_jax(case, monkeypatch):
    """At H = 128 the port's banded_pallas remat model aggregates by kernel
    #4's route (its plain version here): 3 band products a forward, 9 with
    the recompute and the backward; held to the JAX model on the slab
    route (impl 'banded', the same terms). The spill2 batch, which the
    fused layer refuses, runs the unfused path without remat too."""
    ds, ours, ref = BATCHES[case]()
    calls = []
    real = bm.banded_matmul_plain
    monkeypatch.setattr(bd, "banded_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = _kw(ds, 128)
    params = _jax_params(kw, ref)
    jmodel = JBuckGNN(impl="banded", **kw)
    _hold(BuckGNN(impl="banded_pallas", remat=True, **kw), ours, jmodel,
          params, ref)
    assert len(calls) == 9
    if case == "spill2":
        calls.clear()
        _hold(BuckGNN(impl="banded_pallas", **kw), ours, jmodel, params, ref)
        assert len(calls) == 6


@pytest.mark.parametrize("case", ["super", "virtual"])
def test_unfused_and_fused_routes_agree(case):
    """One model, one batch: the unfused banded route (remat) and the
    fused layer's route give the same pred and gradients within the fused
    path's tolerance against JAX (1e-4)."""
    ds, ours, ref = BATCHES[case]()
    kw = _kw(ds, 128)
    sd = params_from_flax(jax.tree.map(np.asarray, _jax_params(kw, ref)))
    out = []
    for remat in (True, None):
        port = BuckGNN(impl="banded_pallas", remat=remat, **kw)
        port.load_state_dict(sd)
        out.append(_grads_port(port, ours))
    (p_u, g_u), (p_f, g_f) = out
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(p_u[gm], p_f[gm], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    for k in g_f:
        _rel_close(g_u[k], g_f[k], k)


def test_device_band_model_matches_packed_band():
    """A batch packed with materialize_band=False serves as the packed
    batch does, on the unfused and the fused route."""
    ds, packed, _ = _virtual()
    _, bandless, _ = _virtual(materialize=False)
    kw = _kw(ds, 128)
    for remat in (True, None):
        port = BuckGNN(impl="banded_pallas", remat=remat,
                       generator=torch.Generator().manual_seed(0), **kw)
        with torch.no_grad():
            a, _ = port(packed)
            b, _ = port(bandless)
        assert torch.equal(a, b)
