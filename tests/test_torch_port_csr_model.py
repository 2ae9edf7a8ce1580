"""The port's unfused SAGE model on unbanded batches == the JAX package's.

The JAX `BuckGNN` with ``impl="xla"`` (gathers and segment sums) and with
``impl="pallas"`` (kernel #7 in interpret mode), and the port's `BuckGNN`
with ``impl`` 'xla' and 'pallas' (on the CPU the CSR kernel's plain
version and its transposed-CSR backward), with the JAX weights carried
over by `params_from_flax`, take the same batch of virtual-edge panels
packed without a band. Compared: the prediction and every parameter's
gradient, the bf16 eval step, three train steps at dropout rate 0, and the
route a banded impl takes on an unbanded batch. Also here: the two faults
of the port's own defaults against the JAX package, the `TrainConfig`
defaults (F2) and the Dense initializer (F1).
"""

import dataclasses

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
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.blocks import Dense
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.ops import csr_segment as cs
from buckgnn_tpu_torch.ops import epilogue as ep
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import (
    build_model, init_state, make_eval_step, make_optimizer, make_train_step,
)

H, LAYERS, LR = 128, 3, 1e-3
# fp32 against JAX: the same algorithm in float32, summed in another
# order: pred to 1e-4 relative, each gradient's max error within 1e-4 of
# its largest entry (sums of O(1000) terms of O(1))
PRED_RTOL, PRED_ATOL, GRAD_REL = 1e-4, 1e-5, 1e-4


def _data(align=None, n_graphs=12, seed=6):
    """Normalized virtual-edge panels packed without a band: the node cap
    exact (bench.py's unbanded packing) or rounded up to ``align``."""
    ds = generate_dataset(n_graphs, seed=seed, min_side=5, max_side=9,
                          use_super_node=False, use_virtual_edges=True)
    graphs, nz = normalize_dataset(ds)
    n = sum(g.n_node for g in graphs) + 1
    ncap = n if align is None else -(-n // align) * align
    ecap = ((sum(g.n_edge for g in graphs) + 255) // 128) * 128
    ours = next(tb.batch_iterator(graphs, n_graphs, ncap, ecap,
                                  device="cpu"))
    ref = next(jb.batch_iterator(graphs, n_graphs, ncap, ecap))
    assert ours.band_senders is None and ref.band_senders is None
    assert ncap % 256 != 0 if align is None else ncap % align == 0
    return graphs, nz, ours, ref


def _nonzero_biases(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + ((rng.normal(size=p.shape) * 0.05).astype(
            np.float32) if p.ndim == 1 else np.float32(0.0)), params)


def _kw(graphs, **extra):
    return dict(num_node_features=graphs[0].x.shape[1], num_edge_features=5,
                hidden_channels=H, num_layers=LAYERS, pooling_layer="mean",
                dropout_rate=0.0, model_name="GraphSage_addAggr_Shared",
                **extra)


def _jax_params(graphs, ref):
    params = JBuckGNN(impl="xla", **_kw(graphs)).init(
        jax.random.key(1), ref, deterministic=True)["params"]
    return _nonzero_biases(params)


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
    return pred.detach().numpy(), {k: p.grad for k, p in
                                   model.named_parameters()}


def _rel_close(got, want, what, tol=GRAD_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / denom < tol, what


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_model_forward_and_grads_match_jax_fp32(impl):
    """fp32, an exact node cap (not a multiple of 256): pred and every
    parameter's gradient against JAX impl="xla"; the port's 'pallas' runs
    the CSR sum forward and its transposed-CSR backward."""
    graphs, _, ours, ref = _data()
    params = _jax_params(graphs, ref)
    jpred, jgrads = _grads_jax(JBuckGNN(impl="xla", **_kw(graphs)), params,
                               ref)
    port = BuckGNN(impl=impl, **_kw(graphs))
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    pred, grads = _grads_port(port, ours)
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(pred[gm], jpred[gm], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    assert grads.keys() == jgrads.keys()
    for k in jgrads:
        _rel_close(grads[k], jgrads[k], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_eval_matches_jax_pallas(dtype):
    """The eval step with impl="pallas" against the JAX model's, whose
    kernel #7 runs in interpret mode (N a multiple of 256, H 128). bf16:
    each side rounds to bf16 after its own f32 sums (and torch's CPU linear
    adds the bias before its one rounding, flax after), a few ulps per
    layer that the mean pool averages to well under an ulp of pred; but
    pred is itself a bf16 value (|pred| ~ 0.1, ulp 2^-11 = 4.9e-4) and
    rounds to a neighbour on either side: one ulp, 8e-3 relative; the loss
    and MAPE, f32 means over the graphs, 2e-3."""
    graphs, nz, ours, ref = _data(align=256)
    jcfg = JConfig(hidden_channels=H, num_layers=LAYERS, compute_dtype=dtype,
                   segment_impl="pallas")
    jmodel = j_build(jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1])
    opt = j_opt(jcfg)
    jstate = j_init(jmodel, opt, ref, seed=0)
    params = _nonzero_biases(jstate.params)
    _, j_eval = j_train_step(jmodel, opt, j_loss("relative_error"), jcfg, nz)
    jm, (jpred, _) = j_eval(jstate.replace(params=params), ref)
    cfg = TrainConfig(hidden_channels=H, num_layers=LAYERS,
                      compute_dtype=dtype, segment_impl="pallas")
    model = build_model(cfg, graphs[0].x.shape[1], 5, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    m, (pred, _) = make_eval_step(model, get_loss_function("relative_error"),
                                  cfg, nz)(ours)
    gm = ours.graph_mask.numpy()
    tol, pred_tol = (1e-4, 1e-4) if dtype == "float32" else (2e-3, 8e-3)
    np.testing.assert_allclose(pred.float().numpy()[gm],
                               np.asarray(jpred, np.float32)[gm],
                               rtol=pred_tol, atol=1e-5)
    for k in ("loss", "mape"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_steps_match_jax_xla(impl):
    """Three Adam steps at dropout rate 0 from the same weights against
    JAX make_train_step with segment_impl="xla" (the JAX package's
    default), fp32: the losses to 1e-5 relative, the parameters after
    three steps to 1e-6 (round-off of lr-sized Adam updates)."""
    graphs, nz, ours, ref = _data(seed=8)
    common = dict(hidden_channels=H, num_layers=LAYERS, dropout_rate=0.0,
                  lr=LR, weight_decay=1e-2)
    jcfg = JConfig(segment_impl="xla", **common)
    jmodel = j_build(jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1])
    opt = j_opt(jcfg)
    jstate = j_init(jmodel, opt, ref, seed=0)
    params = _nonzero_biases(jstate.params)
    jstate = jstate.replace(params=params, opt_state=opt.init(params))
    start = params_from_flax(jax.tree.map(np.asarray, params))
    j_step, _ = j_train_step(jmodel, opt, j_loss("relative_error"), jcfg, nz)
    cfg = TrainConfig(segment_impl=impl, **common)
    model = build_model(cfg, graphs[0].x.shape[1], 5, device="cpu")
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
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        assert not torch.equal(want[k], start[k]), k


def test_training_at_rate_0_1_runs_the_epilogue(monkeypatch):
    """Dropout 0.1 on the 'pallas' route: every layer ends in the epilogue
    Function (its plain versions here) with seed words from the caller's
    generator, so the same seed gives bit-identical parameters after two
    steps and another seed other parameters; serving drops nothing."""
    graphs, nz, ours, _ = _data(n_graphs=8)
    calls = []
    real = ep._Epilogue.apply
    monkeypatch.setattr(ep._Epilogue, "apply",
                        lambda *a: calls.append(a[2]) or real(*a))

    def run(gen_seed):
        cfg = TrainConfig(hidden_channels=H, num_layers=LAYERS, lr=LR,
                          segment_impl="pallas")
        model = build_model(cfg, graphs[0].x.shape[1], 5, device="cpu")
        state = init_state(model, make_optimizer(cfg, model))
        step, evaluate = make_train_step(
            state.model, state.optimizer,
            get_loss_function(cfg.loss_function), cfg, nz)
        gen = torch.Generator().manual_seed(gen_seed)
        for _ in range(2):
            step(ours, LR, gen)
        before = len(calls)
        evaluate(ours)
        assert len(calls) == before
        return {k: v.clone() for k, v in state.model.state_dict().items()}

    a, b, c = run(3), run(3), run(4)
    assert len(calls) == 3 * 2 * LAYERS
    assert calls[:2 * LAYERS] == calls[2 * LAYERS:4 * LAYERS]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_banded_impl_on_an_unbanded_batch_takes_the_xla_route(monkeypatch):
    """A banded_pallas model on a batch without a band runs the unfused
    layers with the 'xla' aggregation, as the JAX model does (no agg
    context, so no fused layer): the port's pred equals its own 'xla'
    model's bit for bit and the JAX banded_pallas model's to round-off,
    without a fused layer or a CSR sum."""
    graphs, _, ours, ref = _data()
    params = _jax_params(graphs, ref)
    sd = params_from_flax(jax.tree.map(np.asarray, params))

    def refuse(*a, **k):
        raise AssertionError("the fused layer or the CSR sum was called")

    monkeypatch.setattr(sl, "fused_sage_layer", refuse)
    monkeypatch.setattr(cs, "csr_segment_sum", refuse)
    preds = []
    for impl in ("banded_pallas", "xla"):
        port = BuckGNN(impl=impl, **_kw(graphs))
        port.load_state_dict(sd)
        with torch.no_grad():
            preds.append(port(ours)[0].numpy())
    np.testing.assert_array_equal(preds[0], preds[1])
    jpred, _ = JBuckGNN(impl="banded_pallas", **_kw(graphs)).apply(
        {"params": params}, ref, deterministic=True)
    gm = ours.graph_mask.numpy()
    np.testing.assert_allclose(preds[0][gm], np.asarray(jpred)[gm],
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_routes_the_port_refuses():
    """'banded' and 'banded_partitioned' on a banded batch run the unfused
    banded path (the slab product; banded_partitioned without a partition
    is 'banded', as in the JAX model) and match the JAX model with the same
    impl: pred and every gradient. Only an unknown impl and a batch that
    carries a partition (item 9) still raise."""
    ds = generate_dataset(4, seed=1, min_side=6, max_side=8,
                          use_super_node=False, use_virtual_edges=False)
    pack = dict(band_width=64, band_tile=128)
    banded = tb.pack_graphs(ds, 512, 2048, 5, device="cpu", **pack)
    ref = jb.pack_graphs(ds, 512, 2048, 5, **pack)
    kw = _kw(ds)
    params = _jax_params(ds, ref)
    for impl in ("banded", "banded_partitioned"):
        jpred, jgrads = _grads_jax(JBuckGNN(impl=impl, **kw), params, ref)
        port = BuckGNN(impl=impl, **kw)
        port.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                           params)))
        pred, grads = _grads_port(port, banded)
        gm = banded.graph_mask.numpy()
        np.testing.assert_allclose(pred[gm], jpred[gm], rtol=PRED_RTOL,
                                   atol=PRED_ATOL, err_msg=impl)
        for k in jgrads:
            _rel_close(grads[k], jgrads[k], f"{impl}/{k}")
    with pytest.raises(NotImplementedError, match="item 9"):
        BuckGNN(impl="banded_partitioned", **kw)(
            banded.replace(part=object()))
    with pytest.raises(ValueError, match="impl"):
        BuckGNN(impl="csr", **kw)


def test_train_config_defaults_match_jax():
    """F2: every field the port's TrainConfig shares with the JAX package's
    has the JAX default (segment_impl 'xla' and remat None among them)."""
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert {"segment_impl", "remat"} <= ours.keys() <= theirs.keys()
    for name, default in ours.items():
        assert default == theirs[name], name
    assert TrainConfig().segment_impl == "xla"


def test_dense_init_is_lecun_normal():
    """F1: Dense weights are flax's lecun_normal: a normal truncated at
    +-2s with s = 1/sqrt(fan_in)/0.8796, so no entry lies beyond 2s and
    the std is 1/sqrt(fan_in); held to jax.nn.initializers.lecun_normal
    samples of the same shape (the stds of two samples of 65,536 draws
    agree to a few sampling errors, 0.3% each)."""
    fan_in, out = 256, 256
    s = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
    stds = []
    for seed in range(3):
        w = Dense(fan_in, out, generator=torch.Generator().manual_seed(seed)
                  ).weight.detach().numpy()
        assert float(np.abs(w).max()) <= 2 * s
        stds.append(float(w.std()))
    j = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.key(0), (fan_in, out), jnp.float32))
    assert float(np.abs(j).max()) <= 2 * s * (1 + 1e-6)
    for std in stds:
        assert abs(std / float(j.std()) - 1.0) < 0.015
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.015
