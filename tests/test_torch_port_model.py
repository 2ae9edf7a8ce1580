"""The port's flagship model eval step == the JAX package's.

JAX `BuckGNN(impl="banded_pallas")` (fused Pallas layers in interpret mode,
deterministic) and the port's `BuckGNN`, with the JAX weights carried over
by `params_from_flax`, serve the same packed batch through each package's
eval step. Compared: pred on graph_mask rows, the relative-error loss and
the MAPE.
"""

import jax
import numpy as np
import pytest
import torch

from buckgnn_tpu.config import TrainConfig as JConfig
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu.train.trainer import (
    build_model as j_build, init_state, make_optimizer, make_train_step,
)
from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.build import rcm_reorder
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import build_model, make_eval_step


def _setup(dtype: str, windows: bool = True):
    ds = generate_dataset(12, seed=6, min_side=5, max_side=9,
                          use_super_node=True, use_virtual_edges=False)
    normed, nz = normalize_dataset(ds)
    graphs = [rcm_reorder(g) for g in normed]
    tile, width = 128, 64
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((n + 4 * tile - 1) // (4 * tile)) * 4 * tile
    ecap = ((sum(g.n_edge for g in graphs) + 255) // 128) * 128
    kw = dict(band_width=width, band_tile=tile, rcm=False,
              local_star_windows=windows)
    ours = next(tb.batch_iterator(graphs, 12, ncap, ecap, device="cpu", **kw))
    ref = next(jb.batch_iterator(graphs, 12, ncap, ecap, **kw))
    assert (ours.gwin is not None) == windows
    common = dict(hidden_channels=128, num_layers=3, compute_dtype=dtype)
    jcfg = JConfig(segment_impl="banded_pallas", **common)
    jmodel = j_build(jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1])
    opt = make_optimizer(jcfg)
    state = init_state(jmodel, opt, ref, seed=0)
    # nonzero biases so the carried-over bias layout is exercised too
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p) + (
            (rng.normal(size=p.shape) * 0.05).astype(np.float32)
            if p.ndim == 1 else np.float32(0.0)),
        state.params)
    state = state.replace(params=params)
    _, j_eval = make_train_step(jmodel, opt, j_loss("relative_error"), jcfg,
                                nz)
    jm, (jpred, _) = j_eval(state, ref)

    cfg = TrainConfig(**common)
    model = build_model(cfg, graphs[0].x.shape[1],
                        graphs[0].edge_attr.shape[1], device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    m, (pred, _) = make_eval_step(model, get_loss_function("relative_error"),
                                  cfg, nz)(ours)
    gm = ours.graph_mask.numpy()
    return (pred.float().numpy()[gm], np.asarray(jpred, np.float32)[gm],
            m, jm)


@pytest.mark.parametrize("windows", [True, False])
def test_eval_step_matches_jax_fp32(windows):
    """fp32: agreement to f32 round-off through 3 layers and the heads."""
    pred, jpred, m, jm = _setup("float32", windows)
    np.testing.assert_allclose(pred, jpred, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["mape"]), float(jm["mape"]),
                               rtol=1e-4)


def test_eval_step_matches_jax_bf16():
    """bf16 compute: each side rounds to bf16 after its own f32 sums (and
    torch's CPU linear adds the bias before its single rounding, flax after),
    so activations differ by a few bf16 ulps (2^-8 relative) per layer; the
    prediction, a mean over hundreds of nodes decoded by a 3-layer MLP,
    averages them: here pred (|pred| ~ 0.1) moves by about 5e-4 and the
    loss and MAPE by about 2e-4 relative, inside 2e-3."""
    pred, jpred, m, jm = _setup("bfloat16")
    np.testing.assert_allclose(pred, jpred, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(m["mape"]), float(jm["mape"]),
                               rtol=2e-3)
