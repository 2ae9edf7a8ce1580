"""The port's loss registry and node-level metrics == the JAX package's.

Each of the 27 names of `get_loss_function`, `MAPE_error` for every
prediction type and `stress_errors` for both static types, against
buckgnn_tpu/train/{losses,metrics}.py on the same masked random inputs
(numpy, from a seed): per-graph scalars for the flat losses, [N, C] node
rows for the static and graph-family losses (8 graphs of 5-9 nodes, one
padding graph, masked rows in every graph), float32. Values to 1e-5
relative; each loss's gradient in pred to 1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.train import losses as jl
from buckgnn_tpu.train import metrics as jm
from buckgnn_tpu_torch.train import losses as tl
from buckgnn_tpu_torch.train import metrics as tm

RTOL = 1e-5
N_GRAPHS = 8  # + one padding graph


def _node_case(c, seed=0):
    """pred, target [N, C], node_graph [N], node_mask [N] (some rows of
    every graph masked, the padding graph's rows too), graph_mask [G], x
    [N, 7]."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 10, size=N_GRAPHS)
    graph = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]
                           + [np.full(4, N_GRAPHS)]).astype(np.int32)
    n = len(graph)
    mask = (rng.uniform(size=n) > 0.2) & (graph < N_GRAPHS)
    target = rng.normal(size=(n, c)).astype(np.float32)
    target += np.sign(target) * 0.05  # away from 0 (relative errors)
    pred = (target + rng.normal(size=(n, c)) * 0.3).astype(np.float32)
    gmask = np.arange(N_GRAPHS + 1) < N_GRAPHS
    x = rng.normal(size=(n, 7)).astype(np.float32)
    return pred, target, graph, mask, gmask, x


def _graph_case(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.5, 3.0, size=N_GRAPHS + 1).astype(np.float32)
    pred = (target * rng.uniform(0.7, 1.3, size=target.shape)).astype(
        np.float32)
    pred[3] = -0.2  # msle's clamp and the focal losses' out-of-range rows
    pred[5] = 9.0
    mask = np.arange(N_GRAPHS + 1) < N_GRAPHS - 1
    return pred, target, mask


def _values(seed=1):
    return np.random.default_rng(seed).uniform(0.4, 3.2, size=200).astype(
        np.float32)


FLAT = ["mse", "relative_error", "log_cosh", "eigenvalue",
        "order_preserving", "mape", "mae", "rrse", "rrse1", "msle", "rse",
        "focal", "focal_rrse", "focal_mape"]
STATIC = sorted(tl.STATIC_FAMILY)
GRAPH = sorted(tl.GRAPH_FAMILY)


def test_the_registry_has_the_27_names():
    assert len(tl.LOSS_NAMES) == len(set(tl.LOSS_NAMES)) == 27
    assert set(tl.LOSS_NAMES) == set(FLAT) | set(STATIC) | set(GRAPH)
    assert tl.GRAPH_FAMILY == jl.GRAPH_FAMILY
    assert tl.STATIC_FAMILY == jl.STATIC_FAMILY
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss_function("nope")


def _check(j_fn, t_fn, args, grad_arg=0):
    """Value and gradient in ``args[grad_arg]`` of both sides."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    want, jgrad = jax.value_and_grad(
        lambda p: j_fn(*jargs[:grad_arg], p, *jargs[grad_arg + 1:]))(
        jargs[grad_arg])
    p = targs[grad_arg].clone().requires_grad_()
    got = t_fn(*targs[:grad_arg], p, *targs[grad_arg + 1:])
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    jg = np.asarray(jgrad)
    scale = max(float(np.abs(jg).max()), 1e-12)
    assert float(np.abs(p.grad.numpy() - jg).max()) / scale < 1e-5


@pytest.mark.parametrize("name", FLAT)
def test_flat_losses_match_jax(name):
    """Per-graph scalars with a graph mask (the buckling convention)."""
    pred, target, mask = _graph_case()
    values = _values()
    _check(jl.get_loss_function(name, values),
           tl.get_loss_function(name, values), (pred, target, mask))


@pytest.mark.parametrize("name", STATIC + ["mse", "relative_error", "mae"])
def test_static_losses_match_jax(name):
    """[N, 3] node rows with a node mask."""
    pred, target, _, mask, _, _ = _node_case(3, seed=2)
    _check(jl.get_loss_function(name), tl.get_loss_function(name),
           (pred, target, mask))


@pytest.mark.parametrize("name", GRAPH)
def test_graph_family_losses_match_jax(name):
    """loss(pred, target, node_graph, node_mask, graph_mask, x) on [N, 2]
    rows (the forces in x[:, 3:5])."""
    pred, target, graph, mask, gmask, x = _node_case(2, seed=3)
    _check(jl.get_loss_function(name), tl.get_loss_function(name),
           (pred, target, graph, mask, gmask, x))


@pytest.mark.parametrize("ptype,c", [("buckling", 1), ("static_disp", 2),
                                     ("static_stress", 3),
                                     ("mode_shape", 3)])
def test_mape_error_matches_jax(ptype, c):
    if ptype == "buckling":
        pred, target, mask = _graph_case(seed=4)
        kw = dict(eigen_scale=np.float32(2.5), eigen_center=np.float32(0.7))
    else:
        pred, target, _, mask, _, _ = _node_case(c, seed=4)
        kw = dict(threshold=0.3)
    want = jm.MAPE_error(jnp.asarray(pred), jnp.asarray(target),
                         jnp.asarray(mask), ptype, **kw)
    got = tm.MAPE_error(torch.from_numpy(pred), torch.from_numpy(target),
                        torch.from_numpy(mask), ptype,
                        **{k: float(v) if k != "threshold" else v
                           for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("ptype,c,threshold", [("static_stress", 3, 0.2),
                                               ("static_disp", 2, 0.5)])
def test_stress_errors_match_jax(ptype, c, threshold):
    """Every key of `stress_errors`, with one graph whose rows all lie
    below the threshold (an empty high region) and ties at a component's
    maximum."""
    pred, target, graph, mask, gmask, _ = _node_case(c, seed=5)
    target[graph == 2] *= 1e-3
    first = np.nonzero(graph == 4)[0][:2]
    target[first] = np.abs(target[first]).max() + 1.0
    want = jm.stress_errors(*(jnp.asarray(a) for a in (
        pred, target, graph, mask, gmask)), ptype, threshold)
    got = tm.stress_errors(*(torch.from_numpy(a) for a in (
        pred, target, graph, mask, gmask)), ptype, threshold)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
