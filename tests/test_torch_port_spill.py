"""The port's spill path: the virtual-edge config, end to end on the CPU.

Batches with out-of-band (spill) edges add each tile's spill window to the
fused layer's accumulator and take the split backward: the tile kernel
(`sage_layer_bwd_tile`, TPU `_bwd_kernel`) and the banded SpMM
(`banded_matmul`, TPU `pallas_banded._kernel`). On the CPU the wrappers run
their plain versions. Held here, float32 unless stated:
- `sage_layer_bwd_tile_plain` against JAX `_call_bwd_tile` (Pallas in
  interpret mode, rate 0), with and without supernodes;
- the spill branch of `fused_sage_layer` (forward and gradients) against
  the JAX `fused_sage_layer` and `jax.vjp` on a virtual-edge batch and a
  supernode batch with spill edges;
- the whole model on a virtual-edge batch, weights carried by
  `params_from_flax`: `eval_step`, three `train_step`s (fp32 and bf16)
  against the JAX trainer, and the gradients of a supernode + spill model;
- at dropout 0.1, port only: the split backward against autograd of the
  plain forward;
- the star-threading conditions of the JAX model (`star_threading`).

Inputs are made with numpy from a seed and given to both sides.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.config import TrainConfig as JConfig
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.models.buckgnn import BuckGNN as JBuckGNN
from buckgnn_tpu.ops.banded import make_agg_context as j_ctx
from buckgnn_tpu.ops.pallas_sage_layer import (
    _call_bwd_tile as j_bwd_tile,
    fused_sage_layer as j_layer,
)
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu.train.trainer import (
    build_model as j_build, init_state as j_init, make_optimizer as j_opt,
    make_train_step as j_train_step,
)
from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.build import rcm_reorder
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.buckgnn import BuckGNN, star_threading
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import (
    build_model, init_state, make_eval_step, make_optimizer, make_train_step,
)

H = 128
TILE, WIDTH = 128, 64
SEED = (0x2545F491, 0x9E3779B9)
LR = 1e-3
WEIGHT_DECAY = 1e-2  # large enough that its placement in Adam shows
# fp32 against JAX: the same algorithm in float32, sums in another order:
# 1e-4 relative, with an absolute floor of 1e-5 of the largest entry.
RTOL, ATOL_FRAC = 1e-4, 1e-5


def _pack(ds, n_graphs):
    n = sum(g.n_node for g in ds) + 1
    ncap = ((max(n, TILE + WIDTH) + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(ds, ncap, ecap, n_graphs + 1, device="cpu", **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, n_graphs + 1, **kw)
    assert ours.has_spill_edges and not ours.has_spill2_edges
    return ours, ref


def _virtual(seed=1):
    """A virtual-edge batch: random long edges spill out of the band."""
    ds = generate_dataset(12, seed=seed, min_side=5, max_side=9,
                          use_super_node=False, use_virtual_edges=True)
    ours, ref = _pack(ds, 12)
    assert not ours.has_supernode_edges and ours.n_node_cap // TILE >= 4
    return ours, ref


def _scrambled(seed=9):
    """A supernode batch with spill edges: node order scrambled inside each
    graph so that mesh edges leave the band (tests/test_fused_layer.py)."""
    ds = generate_dataset(3, seed=seed, min_side=8, max_side=11,
                          use_super_node=True, use_virtual_edges=False)
    rng = np.random.default_rng(1)
    out = []
    for g in ds:
        perm = rng.permutation(g.n_node)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(g.n_node)
        out.append(dc.replace(
            g, x=g.x[perm], senders=inv[g.senders].astype(np.int32),
            receivers=inv[g.receivers].astype(np.int32),
            supernode=int(inv[g.supernode])))
    ours, ref = _pack(out, 3)
    assert ours.has_supernode_edges
    return ours, ref, out


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _weights(rng):
    return [(rng.normal(size=s) * 0.1).astype(np.float32)
            for s in ((H, H), (H,), (H, H))]


@pytest.mark.parametrize("case", ["virtual", "virtual_skip", "super"])
def test_bwd_tile_plain_matches_jax(case):
    """dagg, dxp, dW_l, dW_r, db_l and (supernode batch) the own table tbwd
    of `sage_layer_bwd_tile_plain` == JAX `_call_bwd_tile` at rate 0."""
    ours = _scrambled()[0] if case == "super" else _virtual()[0]
    skip = case != "virtual"
    n = ours.n_node_cap
    nt = n // TILE
    rng = np.random.default_rng(3)
    dz, y, agg, x = (rng.normal(size=(n, H)).astype(np.float32)
                     for _ in range(4))
    inv = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    w_l, _, w_r = _weights(rng)
    has_super = case == "super"
    _, tg = tb.star_table_geometry(ours.n_graph_cap)
    gacc = ours.gacc if has_super else None
    want = j_bwd_tile(
        *(jnp.asarray(a) for a in (dz, y, inv.reshape(nt, 1, TILE), agg, x,
                                   w_l, w_r)),
        jnp.zeros((2,), jnp.int32),
        jnp.asarray(gacc.numpy()) if has_super else None, tile=TILE,
        skip=skip, rate=0.0, training_rate_active=False, interpret=True,
        has_super=has_super, tg=tg)
    got = sl.sage_layer_bwd_tile_plain(
        *(torch.from_numpy(a) for a in (dz, y, inv, agg, x, w_l, w_r)),
        tile=TILE, skip=skip, acc_code=gacc, tg=tg)
    names = ("dagg", "dxp", "dW_l", "dW_r", "db_l", "tbwd")
    assert (got[5] is None) == (not has_super)
    for name, g, w in zip(names, got, want):
        _close(g.numpy(), np.asarray(w).reshape(g.shape), name)


def _probe(ours, seed):
    rng = np.random.default_rng(seed)
    n = ours.n_node_cap
    x = rng.normal(size=(n, H)).astype(np.float32)
    x[-1] = 0.0
    w = _weights(rng)
    probe = rng.normal(size=(n, H)).astype(np.float32)
    probe *= ours.node_mask.numpy()[:, None]
    return x, w, probe


@pytest.mark.parametrize("case,skip", [
    ("virtual", False), ("virtual", True), ("super", True)])
def test_spill_layer_matches_jax_fp32(case, skip):
    """The spill branch of the fused layer: z and the gradients dx, dW_l,
    db_l, dW_r (split backward) == the JAX layer and jax.vjp at rate 0."""
    ours, ref = (_scrambled()[:2] if case == "super" else _virtual(seed=4))
    x, (w_l, b_l, w_r), probe = _probe(ours, seed=5)
    ctx = j_ctx(ref, band_dtype=jnp.float32, use_pallas=True)
    z_j, vjp = jax.vjp(
        lambda *a: j_layer(*a, ctx, skip=skip, rate=0.0,
                           seed=jnp.zeros((2,), jnp.int32),
                           deterministic=False),
        *(jnp.asarray(a) for a in (x, w_l, b_l, w_r)))
    want = vjp(jnp.asarray(probe))

    params = [torch.from_numpy(a).requires_grad_()
              for a in (x, w_l, b_l, w_r)]
    z, _ = sl.fused_sage_layer(*params, make_agg_context(ours), skip=skip,
                               deterministic=False)
    (z * torch.from_numpy(probe)).sum().backward()
    m = ours.node_mask.numpy()
    _close(z.detach().numpy()[m], np.asarray(z_j)[m], "z")
    _close(params[0].grad.numpy()[m], np.asarray(want[0])[m], "dx")
    for p, w, name in zip(params[1:], want[1:], ("dW_l", "db_l", "dW_r")):
        _close(p.grad.numpy(), w, name)


def _plain_layer(x, w_l, b_l, w_r, batch, skip, rate):
    """The plain forward with the spill window, as a function autograd
    differentiates whole (the star table built from x inside the graph)."""
    kw = {}
    if batch.has_supernode_edges:
        code, gwin, gw, _ = sl.star_codes(batch)
        t0, tg = tb.star_table_geometry(batch.n_graph_cap)
        kw = dict(table=sl._super_tables(x, batch.node_graph,
                                         batch.node_mask,
                                         batch.supernode_index,
                                         batch.n_graph_cap, tg),
                  code=code, gwin=gwin, gw=gw, t0=t0)
    z, _ = sl.sage_layer_plain(
        x, w_l, b_l, w_r, make_agg_context(batch).band, tile=TILE,
        width=WIDTH, skip=skip, rate=rate, seed=SEED if rate else None,
        spill_offsets=batch.spill_offsets, spill_lo=batch.spill_lo,
        spill_hi=batch.spill_hi,
        spill_messages=x[batch.spill_senders.long()], **kw)
    return z


@pytest.mark.parametrize("case", ["virtual", "super"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_backward_matches_autograd(case, rate):
    """The layer's Function with the split backward (tile kernel, then the
    banded SpMM with the spill window of dagg, the own star by global codes
    and dxp) == autograd of `sage_layer_plain` with the spill term, at the
    same dropout seeds. fp32, the same operations in another order: 1e-5
    relative. At rate 0.1 this holds the backward's regenerated mask to the
    forward's."""
    ours = _scrambled()[0] if case == "super" else _virtual(seed=6)[0]
    x, w, probe = _probe(ours, seed=7)
    probe = torch.from_numpy(probe)
    arrays = [x, *w]
    fused = [torch.from_numpy(a).requires_grad_() for a in arrays]
    z, _ = sl.fused_sage_layer(*fused, make_agg_context(ours), skip=True,
                               rate=rate, seed=SEED, deterministic=False)
    (z * probe).sum().backward()
    plain = [torch.from_numpy(a).requires_grad_() for a in arrays]
    zp = _plain_layer(*plain, ours, True, rate)
    (zp * probe).sum().backward()
    assert torch.equal(z, zp)
    if rate:
        assert 0.05 < float((zp == 0).float().mean()) < 0.6
    for a, b, name in zip(fused, plain, ("dx", "dW_l", "db_l", "dW_r")):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-6 * scale, msg=name)


def _virtual_data(seed=6):
    ds = generate_dataset(12, seed=seed, min_side=5, max_side=9,
                          use_super_node=False, use_virtual_edges=True)
    normed, nz = normalize_dataset(ds)
    graphs = [rcm_reorder(g) for g in normed]
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((n + 4 * TILE - 1) // (4 * TILE)) * 4 * TILE
    ecap = ((sum(g.n_edge for g in graphs) + 255) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE, rcm=False)
    ours = next(tb.batch_iterator(graphs, 12, ncap, ecap, device="cpu",
                                  **kw))
    ref = next(jb.batch_iterator(graphs, 12, ncap, ecap, **kw))
    assert ours.has_spill_edges and not ours.has_spill2_edges
    return graphs, nz, ours, ref


def _jax_start(graphs, ref, jcfg):
    """The JAX model, optimizer and initial params, with nonzero biases."""
    jmodel = j_build(jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1])
    opt = j_opt(jcfg)
    jstate = j_init(jmodel, opt, ref, seed=0)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p) + (
            (rng.normal(size=p.shape) * 0.05).astype(np.float32)
            if p.ndim == 1 else np.float32(0.0)),
        jstate.params)
    jstate = jstate.replace(params=params, opt_state=opt.init(params))
    return jmodel, opt, jstate


def test_virtual_eval_step_matches_jax_fp32():
    """eval_step on a virtual-edge batch: pred, loss and MAPE == the JAX
    eval step, to f32 round-off through 3 layers and the heads."""
    graphs, nz, ours, ref = _virtual_data()
    common = dict(hidden_channels=128, num_layers=3, compute_dtype="float32")
    jcfg = JConfig(segment_impl="banded_pallas", **common)
    jmodel, opt, jstate = _jax_start(graphs, ref, jcfg)
    _, j_eval = j_train_step(jmodel, opt, j_loss("relative_error"), jcfg, nz)
    jm, (jpred, _) = j_eval(jstate, ref)
    cfg = TrainConfig(segment_impl="banded_pallas", **common)
    model = build_model(cfg, graphs[0].x.shape[1],
                        graphs[0].edge_attr.shape[1], device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    sl.reset_launch_counts()
    m, (pred, _) = make_eval_step(model, get_loss_function("relative_error"),
                                  cfg, nz)(ours)
    assert set(sl.LAUNCHES.values()) == {0}  # CPU: plain versions only
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(pred.numpy()[gm], np.asarray(jpred)[gm],
                               rtol=1e-4, atol=1e-5)
    for k in ("loss", "mape"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)


def _train_both(dtype):
    graphs, nz, ours, ref = _virtual_data()
    jcfg = JConfig(hidden_channels=128, num_layers=3, compute_dtype=dtype,
                   segment_impl="banded_pallas", dropout_rate=0.0, lr=LR,
                   weight_decay=WEIGHT_DECAY)
    jmodel, opt, jstate = _jax_start(graphs, ref, jcfg)
    start = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    j_step, _ = j_train_step(jmodel, opt, j_loss("relative_error"), jcfg, nz)

    cfg = TrainConfig(hidden_channels=128, num_layers=3, compute_dtype=dtype,
                      dropout_rate=0.0, lr=LR, weight_decay=WEIGHT_DECAY,
                      segment_impl="banded_pallas")
    model = build_model(cfg, graphs[0].x.shape[1],
                        graphs[0].edge_attr.shape[1], device="cpu")
    model.load_state_dict(start)
    state = init_state(model, make_optimizer(cfg, model))
    step, _ = make_train_step(state.model, state.optimizer,
                              get_loss_function(cfg.loss_function), cfg, nz)
    gen = torch.Generator().manual_seed(0)
    losses, j_losses = [], []
    for _ in range(3):
        jstate, jm = j_step(jstate, ref, jax.random.key(1), jnp.float32(LR))
        j_losses.append(float(jm["loss"]))
        losses.append(float(step(ours, LR, gen)["loss"]))
    ended = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    return start, state.model.state_dict(), ended, losses, j_losses


def test_virtual_train_steps_match_jax_fp32():
    """fp32: three Adam steps on a virtual-edge batch from the same
    weights: each loss to 1e-5 relative. Adam divides each gradient entry
    by its own running scale, so an entry whose gradient is of the order of
    Adam's eps (1e-8) turns f32 round-off of that gradient into a visible
    share of its update. Each step moves an entry by at most about lr, so
    the parameters agree entry by entry to 3e-5 (1% of three steps' largest
    move), and within 1e-4 of each tensor's update norm in aggregate;
    every tensor moved."""
    start, got, want, losses, j_losses = _train_both("float32")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=3e-5, err_msg=k)
        upd = float((want[k] - start[k]).norm())
        assert upd > 0, k
        assert float((got[k] - want[k]).norm()) <= 1e-4 * upd, k


def test_virtual_train_steps_match_jax_bf16():
    """bf16 compute, f32 parameters and Adam state: activations differ by
    a few bf16 ulps per layer, so each loss agrees to 2e-3 relative and,
    for every parameter tensor, the two runs' updates differ by under 10%
    of the update's norm (an entry within bf16 noise of zero may take
    Adam's first step the other way)."""
    start, got, want, losses, j_losses = _train_both("bfloat16")
    np.testing.assert_allclose(losses, j_losses, rtol=2e-3)
    for k in want:
        upd = want[k] - start[k]
        diff = float((got[k] - want[k]).norm())
        assert diff <= 0.1 * float(upd.norm()), (k, diff, float(upd.norm()))


def test_supernode_spill_model_grads_match_jax():
    """A supernode batch with spill edges trains without star threading
    (as in the JAX model) and the split backward folds the own star into
    dx: the gradients of sum(pred) w.r.t. every parameter == jax.grad of
    the JAX model (tests/test_fused_layer.py:209-255), fp32, 3 layers."""
    ours, ref, graphs = _scrambled()
    kw = dict(num_node_features=graphs[0].x.shape[1], num_edge_features=5,
              hidden_channels=128, num_layers=3, dropout_rate=0.0)
    jmodel = JBuckGNN(impl="banded_pallas", pooling_layer="mean", **kw)
    variables = jmodel.init(jax.random.key(0), ref, deterministic=True)
    gmask = jnp.asarray(ref.graph_mask, jnp.float32)

    def loss(v):
        pred, _ = jmodel.apply(v, ref, deterministic=True)
        return jnp.sum(pred * gmask)

    j_grads = params_from_flax(jax.tree.map(
        np.asarray, jax.grad(loss)(variables)["params"]))
    model = BuckGNN(**kw)
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    pred, _ = model(ours, deterministic=False)
    (pred * ours.graph_mask.float()).sum().backward()
    for k, p in model.named_parameters():
        _close(p.grad.numpy(), j_grads[k].numpy(), k)


def _super_batch(windows=True):
    ds = generate_dataset(12, seed=0, min_side=5, max_side=9,
                          use_super_node=True, use_virtual_edges=False)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, 13, band_width=WIDTH, band_tile=TILE,
                       device="cpu")
    assert not b.has_spill_edges and b.gwin is not None
    return b if windows else b.replace(gwin=None, lcode=None, lacc=None)


def test_star_threading_follows_the_jax_model(monkeypatch):
    """`star_threading` is the JAX model's (thread, thread_tables): thread
    on supernode batches without spill edges, tables with local windows;
    never on a virtual-edge batch or a supernode batch with spill edges.
    The model opens `star_source` exactly when it threads, in training and
    serving alike, and trains a supernode + spill batch without raising."""
    assert star_threading(_super_batch()) == (True, True)
    assert star_threading(_super_batch(windows=False)) == (True, False)
    assert star_threading(_virtual()[0]) == (False, False)
    spill_super = _scrambled()[0]
    assert star_threading(spill_super) == (False, False)
    assert star_threading(spill_super.replace(
        has_spill_edges=False)) == (True, True)

    opened = []
    real = sl.star_source

    def counted(x, ctx):
        opened.append(ctx.batch.has_spill_edges)
        return real(x, ctx)

    monkeypatch.setattr(sl, "star_source", counted)
    for batch, want in ((spill_super, []), (_super_batch(), [False])):
        model = BuckGNN(batch.nodes.shape[1], 5, hidden_channels=H,
                        num_layers=3, dropout_rate=0.0)
        for deterministic in (False, True):
            opened.clear()
            pred, _ = model(batch, deterministic=deterministic)
            assert opened == want
        pred.sum().backward()


def test_spill_scope_guards():
    """Star threading on a spill batch raises, as in the JAX package; a
    batch with per-tile overflow edges (spill2), which the fused layer
    refuses, runs the unfused banded path (the spill list in kernel #4's
    window, spill2 scatter-added) and matches the JAX model, whose layers
    take the same path: pred and every gradient."""
    ours = _scrambled()[0]
    x = torch.zeros((ours.n_node_cap, H), requires_grad=True)
    w = [torch.zeros(s) for s in ((H, H), (H,), (H, H))]
    with pytest.raises(ValueError, match="without spill edges"):
        sl.fused_sage_layer(x, *w, make_agg_context(ours), skip=False,
                            deterministic=False,
                            star_in=torch.zeros(8, H))
    # a hub receiving 320 out-of-band edges overflows its tile's window
    # (tests/test_banded.py::test_fused_spill_with_tile_cap_overflow)
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
                      np.float32), y=np.zeros((1,), np.float32))
    batch = tb.pack_graphs([g], 1024, ((len(senders) + 127) // 128) * 128,
                           2, band_width=128, band_tile=256, device="cpu")
    ref = jb.pack_graphs([g], 1024, ((len(senders) + 127) // 128) * 128,
                         2, band_width=128, band_tile=256)
    assert batch.has_spill2_edges
    assert not sl.supports_fused_layer(make_agg_context(
        batch, use_pallas=True), x, "add", True)
    kw = dict(num_node_features=15, num_edge_features=5, hidden_channels=H,
              num_layers=2, dropout_rate=0.0)
    jmodel = JBuckGNN(impl="banded", **kw)
    params = jmodel.init(jax.random.key(2), ref,
                         deterministic=True)["params"]

    def f(p):
        pred, _ = jmodel.apply({"params": p}, ref, deterministic=True)
        return jnp.sum(jnp.where(ref.graph_mask, pred, 0.0) ** 2), pred

    (_, jpred), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    model = BuckGNN(**kw)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        params)))
    pred, _ = model(batch)
    (torch.where(batch.graph_mask, pred, 0.0) ** 2).sum().backward()
    gm = batch.graph_mask.numpy()
    _close(pred.detach().numpy()[gm], np.asarray(jpred)[gm], "pred")
    for k, v in params_from_flax(jax.tree.map(np.asarray, jgrads)).items():
        _close(model.get_parameter(k).grad.numpy(), v.numpy(), k)
