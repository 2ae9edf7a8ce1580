"""The rest of the model family in the port == the JAX package's.

Every `model_name` the port did not have (the per-layer SAGE variants with
and without `MaskedBatchNorm`, `GraphSage_MLP`, the SAG stacks, the EA
names off the fused block), every pooling and every prediction type
(with the `use_z_coord` / `use_rotations` combinations), against the JAX
`BuckGNN` with ``impl="xla"`` in float32 on the same packed batch, the
JAX variables carried over by `state_from_flax` (running statistics
included). Compared: pred in eval (running statistics, injected at random)
and, in training at dropout 0, pred, every parameter's gradient and the
updated running statistics; SAG's kept set; the windowed EA path against
JAX's windowed path; three train steps of a BN model and of a node-level
model against JAX `make_train_step`.

Small shapes: H = 32, 3 layers, panels of 5-7 nodes a side; every JAX
call on the 'xla' route (no Pallas). Float32: pred 1e-4 relative, each
gradient's max error within 1e-4 of its largest entry (1e-3 for the EA
names, as tests/test_torch_port_ea_model.py states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.config import TrainConfig as JConfig
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.models import BuckGNN as JBuckGNN
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu.train.trainer import (
    build_model as j_build, init_state as j_init, make_optimizer as j_opt,
    make_train_step as j_train_step,
)
from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import state_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.buckgnn import (
    BuckGNN, MODELS, POOLINGS, model_config_dict, output_dim_for,
)
from buckgnn_tpu_torch.ops import ea_windowed as eaw
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import (
    build_model, init_state, make_optimizer, make_train_step,
    slice_static_targets,
)

H, LAYERS, TILE, WIDTH = 32, 3, 128, 64
LR = 1e-3
PRED_RTOL, PRED_ATOL, GRAD_REL, EA_GRAD_REL = 1e-4, 1e-5, 1e-4, 1e-3


def _data(prediction_type="buckling", super_node=True, seed=3, n_graphs=5,
          side=(5, 7)):
    """Normalized panels packed on a band (tile 128, width 64) for both
    packages; node-level targets sliced as the trainer slices them (the
    node-level datasets carry no supernode: their targets cover real
    nodes only)."""
    ds = generate_dataset(n_graphs, seed=seed, min_side=side[0],
                          max_side=side[1],
                          use_super_node=super_node,
                          use_virtual_edges=not super_node,
                          prediction_type=prediction_type)
    graphs, nz = normalize_dataset(ds, prediction_type=prediction_type)
    graphs = slice_static_targets(graphs, prediction_type)
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((max(n, TILE + WIDTH) + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in graphs) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(graphs, ncap, ecap, n_graphs + 1, device="cpu",
                          **kw)
    ref = jb.pack_graphs(graphs, ncap, ecap, n_graphs + 1, **kw)
    return graphs, nz, ours, ref


def _kw(graphs, name="GraphSage_addAggr_Shared", **extra):
    return dict(dict(num_node_features=graphs[0].x.shape[1],
                     num_edge_features=graphs[0].edge_attr.shape[1],
                     hidden_channels=H, num_layers=LAYERS,
                     pooling_layer="mean", dropout_rate=0.0,
                     model_name=name), **extra)


def _variables(kw, ref, seed=1):
    """JAX variables with nonzero biases and, for the batch norms, random
    running statistics."""
    v = JBuckGNN(impl="xla", **kw).init(jax.random.key(seed), ref,
                                        deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + ((rng.normal(size=p.shape) * 0.05).astype(
            np.float32) if p.ndim == 1 else np.float32(0.0)), v["params"])
    stats = jax.tree.map(lambda s: np.asarray(s), v.get("batch_stats", {}))
    stats = {k: {"mean": (rng.normal(size=s["mean"].shape) * 0.1).astype(
        np.float32), "var": rng.uniform(0.5, 2.0, size=s["var"].shape)
        .astype(np.float32)} for k, s in stats.items()}
    return params, stats


def _jax_train(model, params, stats, batch, mask):
    """pred, gradients of sum(pred^2) over ``mask`` and the updated
    running statistics of one training forward at dropout 0."""
    def f(p):
        v = {"params": p}
        if stats:
            v["batch_stats"] = stats
        (pred, aux), mut = model.apply(v, batch, deterministic=False,
                                       mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.key(0)})
        m = mask(aux).reshape(mask(aux).shape + (1,) * (pred.ndim - 1))
        return jnp.sum(jnp.where(m, pred, 0.0) ** 2), (pred, aux, mut)

    (_, (pred, aux, mut)), g = jax.value_and_grad(f, has_aux=True)(params)
    new_stats = jax.tree.map(np.asarray, mut.get("batch_stats", {}))
    return (np.asarray(pred), jax.tree.map(np.asarray, aux),
            state_from_flax(jax.tree.map(np.asarray, g)),
            state_from_flax({}, new_stats))


def _port_train(model, batch, mask):
    model.zero_grad(set_to_none=True)
    pred, aux = model(batch, deterministic=False)
    m = mask(aux).reshape(mask(aux).shape + (1,) * (pred.ndim - 1))
    (torch.where(m, pred, 0.0) ** 2).sum().backward()
    return pred.detach().numpy(), aux, {k: p.grad for k, p in
                                        model.named_parameters()}


def _rel_close(got, want, what, tol=GRAD_REL, floor=1e-6):
    """max |got - want| within ``tol`` of max |want|, or of ``floor``: a
    gradient that is zero in exact arithmetic (a Dense bias right before a
    batch norm, whose mean removes it) is round-off on both sides, so the
    caller floors it at 1e-3 of the model's largest gradient entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) / denom < tol, what


def _hold(name_or_kw, data, impls=("xla",), tol=GRAD_REL, mask=None,
          floor_frac=1e-3):
    """Eval and training of the port's model (each impl in ``impls``)
    against JAX impl="xla"; returns the JAX and port aux of training."""
    graphs, _, ours, ref = data
    kw = name_or_kw if isinstance(name_or_kw, dict) else _kw(graphs,
                                                              name_or_kw)
    graph_level = kw.get("prediction_type", "buckling") == "buckling"
    if mask is None:
        def mask(aux):
            return (aux["graph_mask"] if graph_level
                    else aux["real_node_mask"])
    jmodel = JBuckGNN(impl="xla", **kw)
    params, stats = _variables(kw, ref)
    jv = {"params": params, **({"batch_stats": stats} if stats else {})}
    jpred_eval, _ = jmodel.apply(jv, ref, deterministic=True)

    def jmask(aux):
        return dict(aux, graph_mask=ref.graph_mask)[
            "graph_mask" if graph_level else "real_node_mask"]

    jpred, jaux, jgrads, jstats = _jax_train(jmodel, params, stats, ref,
                                             jmask)
    sel = (ours.graph_mask if graph_level
           else torch.from_numpy(np.asarray(jaux["real_node_mask"]))).numpy()
    out = None
    for impl in impls:
        port = BuckGNN(impl=impl, **kw)
        port.load_state_dict(state_from_flax(params, stats))
        with torch.no_grad():
            pred_eval, _ = port(ours)
        np.testing.assert_allclose(pred_eval.numpy()[sel],
                                   np.asarray(jpred_eval)[sel],
                                   rtol=PRED_RTOL, atol=PRED_ATOL,
                                   err_msg=f"{impl}/eval")
        pred, aux, grads = _port_train(
            port, ours, lambda a: dict(a, graph_mask=ours.graph_mask)[
                "graph_mask" if graph_level else "real_node_mask"])
        np.testing.assert_allclose(pred[sel], jpred[sel], rtol=PRED_RTOL,
                                   atol=PRED_ATOL, err_msg=f"{impl}/train")
        assert grads.keys() == jgrads.keys()
        floor = floor_frac * max(float(v.abs().max())
                                 for v in jgrads.values())
        for k in jgrads:
            _rel_close(grads[k], jgrads[k], f"{impl}/{k}", tol, floor)
        buffers = dict(port.named_buffers())
        assert buffers.keys() == jstats.keys()
        for k in jstats:
            np.testing.assert_allclose(buffers[k].numpy(), jstats[k].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{impl}/{k}")
        out = (jaux, aux)
    return out


NEW_MODELS = [m for m in MODELS if m not in ("GraphSage_addAggr_Shared",)]


@pytest.mark.parametrize("name", NEW_MODELS)
def test_converted_state_matches_jax_outputs(name):
    """Each model_name's parameter tree and running statistics through
    `state_from_flax`: eval (running statistics) and training (batch
    statistics, gradients, the updated running statistics) against JAX
    impl="xla", on the port's flat route and its banded route (the banded
    aggregation, or the unfused windowed EA blocks)."""
    data = _data()
    tol = EA_GRAD_REL if "EA" in name else GRAD_REL
    impls = ("xla", "banded") if name != "GraphSage_maxAggr" else ("xla",)
    # the SAG score's bias gradient is a sum over every kept node of O(1)
    # terms that cancel to 5e-4 of the model's largest gradient entry: the
    # port lies 6.0e-4 (relative) from a float64 run of the same weights,
    # JAX 8.2e-5, both within 3.4e-6 absolute, so it is floored at 1e-2 of
    # that entry
    floor = 1e-2 if "SAG" in name else 1e-3
    jaux, aux = _hold(name, data, impls, tol, floor_frac=floor)
    np.testing.assert_array_equal(np.asarray(jaux["node_keep"]),
                                  aux["node_keep"].numpy())


@pytest.mark.parametrize("pooling", POOLINGS)
def test_poolings_match_jax(pooling):
    """Each pooling on a supernode batch (supernodes found from the last
    input feature), with a BN model for the super-aware ones."""
    data = _data()
    name = ("GraphSage_addAggr" if "super" in pooling
            else "GraphSage_addAggr_Shared")
    jaux, aux = _hold(_kw(data[0], name, pooling_layer=pooling), data)
    want = np.asarray(jaux["real_node_mask"])
    np.testing.assert_array_equal(aux["real_node_mask"].numpy(), want)
    assert want.sum() < data[2].node_mask.sum() or "super" not in pooling


def test_pooling_ops_match_jax():
    """ops/pooling.py against buckgnn_tpu/ops/pooling.py: the add, mean
    (with and without the supernodes) and max pools, the supernode rows
    and the supernode flags."""
    from buckgnn_tpu.ops import pooling as jpool
    from buckgnn_tpu_torch.ops import pooling as tpool

    _, _, ours, ref = _data()
    x = np.random.default_rng(4).normal(size=(ours.n_node_cap, 8)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [(tpool.global_add_pool(tx, ours), jpool.global_add_pool(jx,
                                                                     ref))]
    for ex in (False, True):
        pairs.append((tpool.global_mean_pool(tx, ours, ex),
                      jpool.global_mean_pool(jx, ref, ex)))
    pairs += [(tpool.global_max_pool(tx, ours), jpool.global_max_pool(jx,
                                                                      ref)),
              (tpool.supernode_features(tx, ours),
               jpool.supernode_features(jx, ref))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    flags = tpool.is_supernode_flat(ours)
    np.testing.assert_array_equal(flags.numpy(),
                                  np.asarray(jpool.is_supernode_flat(ref)))
    assert int(flags.sum()) == 5


HEADS = [("static_disp", z, r) for z in (False, True) for r in (False, True)]
HEADS += [("static_stress", False, False), ("mode_shape", False, False),
          ("mode_shape", False, True)]


@pytest.mark.parametrize("ptype,z,rot", HEADS)
def test_node_level_heads_match_jax(ptype, z, rot):
    """The node-level heads: pred [N_cap, output_dim_for(...)] over the
    real nodes, with its use_z_coord / use_rotations widths."""
    data = _data(ptype, super_node=False, n_graphs=4)
    kw = _kw(data[0], "GraphSage_meanAggr", prediction_type=ptype,
             use_z_coord=z, use_rotations=rot, pooling_layer="hybrid")
    _hold(kw, data)
    port = BuckGNN(**kw)
    assert "hybrid_att.lin_0.weight" not in port.state_dict()
    pred, _ = port(data[2])
    assert pred.shape == (data[2].n_node_cap,
                          output_dim_for(ptype, z, rot))
    cfg = model_config_dict(port)
    assert (cfg["use_z_coord"], cfg["use_rotations"]) == (z, rot)


def test_batch_norm_follows_deterministic_not_training_mode():
    """MaskedBatchNorm normalizes by the running statistics when the model
    is called deterministic, whatever nn.Module.training says, and moves
    them only in training calls."""
    graphs, _, ours, _ = _data()
    port = BuckGNN(**_kw(graphs, "GraphSage_sumAggr"))
    before = {k: v.clone() for k, v in port.named_buffers()}
    port.train()
    with torch.no_grad():
        a, _ = port(ours)
    port.eval()
    with torch.no_grad():
        b, _ = port(ours)
    assert torch.equal(a, b)
    assert all(torch.equal(v, before[k]) for k, v in port.named_buffers())
    port(ours, deterministic=False)
    assert not any(torch.equal(v, before[k])
                   for k, v in port.named_buffers())


def test_sag_keeps_the_jax_set_on_tied_scores():
    """SAGPooling keeps ceil(ratio * n) nodes a graph, never padding: with
    the score conv's weights zeroed every score ties and the stable sort
    keeps the first nodes of each graph, as JAX's lexsort does."""
    graphs, _, ours, ref = _data()
    kw = _kw(graphs, "GraphSAGE_SAG")
    params, stats = _variables(kw, ref)
    params = dict(params, sag_score=jax.tree.map(np.zeros_like,
                                                 params["sag_score"]))
    _, jaux = JBuckGNN(impl="xla", **kw).apply(
        {"params": params, "batch_stats": stats}, ref, deterministic=True)
    port = BuckGNN(**kw)
    port.load_state_dict(state_from_flax(params, stats))
    with torch.no_grad():
        _, aux = port(ours)
    keep = aux["node_keep"]
    np.testing.assert_array_equal(keep.numpy(),
                                  np.asarray(jaux["node_keep"]))
    k = torch.ceil(0.5 * ours.n_real_node.float())
    counts = torch.zeros_like(k).index_add_(0, ours.node_graph.long(),
                                            keep.float())
    assert torch.equal(counts, k)
    assert not bool((keep & ~ours.node_mask).any())


@pytest.mark.parametrize("name", ["EA_GNN", "EA_GNN_Shared"])
def test_windowed_ea_matches_jax_windowed(name):
    """remat=True on a windowed batch with a banded impl: the unfused
    windowed blocks (one-hot products, the far senders added into the
    window buffer) under torch.utils.checkpoint, against the JAX model's
    windowed path (remat=True, impl 'banded'); and the three window ops
    against JAX's."""
    from buckgnn_tpu.ops import ea_windowed as jeaw

    graphs, _, ours, ref = _data(super_node=False, seed=5, n_graphs=3,
                                 side=(9, 11))
    assert int((ours.win_far_send != ours.n_node_cap - 1).sum()) > 0
    kw = _kw(graphs, name, remat=True)
    params, _ = _variables(kw, ref)
    jmodel = JBuckGNN(impl="banded", **kw)
    jpred, _, jgrads, _ = _jax_train(jmodel, params, {}, ref,
                                     lambda a: ref.graph_mask)
    port = BuckGNN(impl="banded", **kw)
    port.load_state_dict(state_from_flax(params))
    pred, _, grads = _port_train(port, ours, lambda a: ours.graph_mask)
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(pred[gm], jpred[gm], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    for k in jgrads:
        _rel_close(grads[k], jgrads[k], k, EA_GRAD_REL)

    geom = eaw.window_geometry(ours)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(ours.n_node_cap, 16)).astype(np.float32)
    msg = rng.normal(size=ours.win_sidx.shape + (16,)).astype(np.float32)
    deg = eaw.window_degree(ours)
    got = (eaw.gather_senders(torch.from_numpy(x), ours.win_sidx,
                              ours.win_far_pos, ours.win_far_send, geom),
           eaw.gather_receivers(torch.from_numpy(x), ours.win_ridx, geom),
           eaw.scatter_mean_messages(torch.from_numpy(msg), ours.win_ridx,
                                     deg, geom))
    want = (jeaw.gather_senders(jnp.asarray(x), ref.win_sidx,
                                ref.win_far_pos, ref.win_far_send, geom),
            jeaw.gather_receivers(jnp.asarray(x), ref.win_ridx, geom),
            jeaw.scatter_mean_messages(jnp.asarray(msg), ref.win_ridx,
                                       jeaw.window_degree(ref), geom))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _train_both(cfg_kw, data, loss_name):
    """Three Adam steps at dropout 0 from the same variables, port against
    JAX make_train_step: losses, parameters and running statistics."""
    graphs, nz, ours, ref = data
    common = dict(hidden_channels=H, num_layers=LAYERS, dropout_rate=0.0,
                  lr=LR, weight_decay=1e-2, loss_function=loss_name,
                  **cfg_kw)
    jcfg = JConfig(segment_impl="xla", **common)
    fe = graphs[0].edge_attr.shape[1]
    jmodel = j_build(jcfg, graphs[0].x.shape[1], fe)
    opt = j_opt(jcfg)
    jstate = j_init(jmodel, opt, ref, seed=0)
    jstate = jstate.replace(opt_state=opt.init(jstate.params))
    start = state_from_flax(jax.tree.map(np.asarray, jstate.params),
                            jax.tree.map(np.asarray, jstate.batch_stats))
    j_step, _ = j_train_step(jmodel, opt, j_loss(loss_name), jcfg, nz)
    cfg = TrainConfig(segment_impl="banded", **common)
    model = build_model(cfg, graphs[0].x.shape[1], fe, device="cpu")
    model.load_state_dict(start)
    state = init_state(model, make_optimizer(cfg, model))
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for p in model.parameters()}
    step, _ = make_train_step(state.model, state.optimizer,
                              get_loss_function(loss_name), cfg, nz)
    gen = torch.Generator().manual_seed(0)
    losses, j_losses = [], []
    for _ in range(3):
        jstate, jm = j_step(jstate, ref, jax.random.key(1), jnp.float32(LR))
        j_losses.append(float(jm["loss"]))
        m = step(ours, LR, gen)
        losses.append(float(m["loss"]))
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    want = state_from_flax(jax.tree.map(np.asarray, jstate.params),
                           jax.tree.map(np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
        assert not torch.equal(want[k], start[k]), k


def test_train_steps_of_a_batch_norm_model_match_jax():
    """GraphSage_meanAggr (per-layer weights, MaskedBatchNorm, mean by
    degree) on the port's banded route: parameters and batch_stats after
    three steps."""
    _train_both(dict(model_name="GraphSage_meanAggr"), _data(),
                "relative_error")


def test_train_steps_of_a_node_level_model_match_jax():
    """GraphSage_addAggr on the static stress head with a graph-family
    loss: the loss on denormalized node targets, the static/ metrics,
    parameters and batch_stats after three steps."""
    _train_both(dict(model_name="GraphSage_addAggr",
                     prediction_type="static_stress"),
                _data("static_stress", super_node=False, n_graphs=4),
                "graph_mae")
