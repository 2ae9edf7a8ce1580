"""The port's train step (buckgnn_tpu_torch.train.trainer) == the JAX one.

JAX `make_train_step` (the flagship model with its fused Pallas layers in
interpret mode, forward and merged backward, at dropout rate 0) and the
port's `train_step` start from the same weights (carried over by
`params_from_flax`), train on the same packed batch with the same lr and
weight decay, and are compared step by step. Also here: the dropout
numbers and the port's hashed keep mask, the reproducibility of training
at rate 0.1 from a generator seed, and the learning-rate schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.config import TrainConfig as JConfig
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops import dropout as j_dropout
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu.train.schedule import lr_for_epoch as j_lr_for_epoch
from buckgnn_tpu.train.trainer import (
    build_model as j_build, init_state as j_init, make_optimizer as j_opt,
    make_train_step as j_train_step,
)
from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.build import rcm_reorder
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import dropout
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.schedule import lr_for_epoch
from buckgnn_tpu_torch.train.trainer import (
    build_model, init_state, make_optimizer, make_train_step,
)

LR = 1e-3
# large enough that the decay term (wd * param ~ 1e-3) moves the Adam
# moments next to gradients of ~1e-2, so its placement is checked
WEIGHT_DECAY = 1e-2
N_STEPS = 3


def _data(seed=6):
    ds = generate_dataset(12, seed=seed, min_side=5, max_side=9,
                          use_super_node=True, use_virtual_edges=False)
    normed, nz = normalize_dataset(ds)
    graphs = [rcm_reorder(g) for g in normed]
    tile, width = 128, 64
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((n + 4 * tile - 1) // (4 * tile)) * 4 * tile
    ecap = ((sum(g.n_edge for g in graphs) + 255) // 128) * 128
    kw = dict(band_width=width, band_tile=tile, rcm=False)
    return graphs, nz, ncap, ecap, kw


def _port(graphs, nz, dtype, rate, state_dict=None):
    cfg = TrainConfig(hidden_channels=128, num_layers=3, compute_dtype=dtype,
                      dropout_rate=rate, lr=LR, weight_decay=WEIGHT_DECAY,
                      segment_impl="banded_pallas")
    model = build_model(cfg, graphs[0].x.shape[1],
                        graphs[0].edge_attr.shape[1], device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    state = init_state(model, make_optimizer(cfg, model))
    train_step, _ = make_train_step(state.model, state.optimizer,
                                    get_loss_function(cfg.loss_function),
                                    cfg, nz)
    return state, train_step


def _train_both(dtype):
    graphs, nz, ncap, ecap, kw = _data()
    ref = next(jb.batch_iterator(graphs, 12, ncap, ecap, **kw))
    ours = next(tb.batch_iterator(graphs, 12, ncap, ecap, device="cpu",
                                  **kw))
    assert ours.gwin is not None and not ours.has_spill_edges
    jcfg = JConfig(hidden_channels=128, num_layers=3, compute_dtype=dtype,
                   segment_impl="banded_pallas", dropout_rate=0.0, lr=LR,
                   weight_decay=WEIGHT_DECAY)
    jmodel = j_build(jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1])
    opt = j_opt(jcfg)
    jstate = j_init(jmodel, opt, ref, seed=0)
    # nonzero biases, so the bias gradients and their decay count too
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p) + (
            (rng.normal(size=p.shape) * 0.05).astype(np.float32)
            if p.ndim == 1 else np.float32(0.0)),
        jstate.params)
    jstate = jstate.replace(params=params, opt_state=opt.init(params))
    start = params_from_flax(jax.tree.map(np.asarray, params))
    j_step, _ = j_train_step(jmodel, opt, j_loss("relative_error"), jcfg, nz)

    state, step = _port(graphs, nz, dtype, 0.0, start)
    gen = torch.Generator().manual_seed(0)
    losses, j_losses = [], []
    for _ in range(N_STEPS):
        jstate, jm = j_step(jstate, ref, jax.random.key(1), jnp.float32(LR))
        j_losses.append(float(jm["loss"]))
        losses.append(float(step(ours, LR, gen)["loss"]))
    ended = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    return start, state.model.state_dict(), ended, losses, j_losses


def test_train_steps_match_jax_fp32():
    """fp32: three Adam steps from the same weights. The loss of each step
    agrees to f32 round-off (1e-5 relative). Adam divides each gradient by
    its own running scale, so the parameters after three steps agree to
    round-off of lr-sized updates: 1e-6 absolute."""
    start, got, want, losses, j_losses = _train_both("float32")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        moved += int(not torch.equal(want[k], start[k]))
    assert moved == len(want)


def test_train_steps_match_jax_bf16():
    """bf16 compute, float32 parameters and Adam state on both sides. The
    activations differ by a few bf16 ulps per layer (see the bf16 eval
    test), so the loss of each step agrees to 2e-3 relative. Adam's first
    step moves each weight by lr * sign(grad): a gradient entry within
    bf16 noise of zero can take the other sign, so the parameters are held
    in aggregate: for every parameter tensor, the two runs' updates differ
    by under 10% of the update's norm."""
    start, got, want, losses, j_losses = _train_both("bfloat16")
    np.testing.assert_allclose(losses, j_losses, rtol=2e-3)
    for k in want:
        upd = want[k] - start[k]
        diff = float((got[k] - want[k]).norm())
        assert diff <= 0.1 * float(upd.norm()), (k, diff, float(upd.norm()))


def test_train_steps_at_rate_0_1_reproduce_from_the_generator():
    """Training with dropout 0.1 draws each layer's seed words from the
    caller's generator: the same generator seed gives bit-identical
    parameters after two steps, another seed gives other parameters."""
    graphs, nz, ncap, ecap, kw = _data(seed=8)
    batch = next(tb.batch_iterator(graphs, 12, ncap, ecap, device="cpu",
                                   **kw))

    def run(gen_seed):
        state, step = _port(graphs, nz, "float32", 0.1)
        gen = torch.Generator().manual_seed(gen_seed)
        for _ in range(2):
            m = step(batch, LR, gen)
            assert np.isfinite(float(m["loss"]))
        return state.model.state_dict()

    a, b, c = run(3), run(3), run(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_training_with_dropout_needs_a_generator():
    graphs, nz, ncap, ecap, kw = _data()
    batch = next(tb.batch_iterator(graphs, 12, ncap, ecap, device="cpu",
                                   **kw))
    state, step = _port(graphs, nz, "float32", 0.1)
    with pytest.raises(ValueError, match="Generator"):
        step(batch, LR, None)


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.25, 0.5, 0.9])
def test_dropout_numbers_match_jax(rate):
    assert dropout.dropout_threshold(rate) == j_dropout.dropout_threshold(rate)
    assert dropout.dropout_scale(rate) == j_dropout.dropout_scale(rate)


def test_keep_mask_statistics():
    """The hashed keep mask keeps 1 - rate of the elements (within 4
    sigma of a binomial), is a function of the seeds alone, and changes
    with either seed word."""
    n, h, rate = 4096, 512, 0.1
    keep = dropout.keep_mask((11, 22), n, h, rate, "cpu")
    p = 1.0 - rate
    sigma = np.sqrt(p * (1 - p) / (n * h))
    assert abs(float(keep.float().mean()) - p) < 4 * sigma
    # every row and every column keeps about the same share
    assert float(keep.float().mean(1).std()) < 4 * np.sqrt(p * (1 - p) / h)
    assert float(keep.float().mean(0).std()) < 4 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(keep, dropout.keep_mask((11, 22), n, h, rate, "cpu"))
    for other in ((12, 22), (11, 23)):
        changed = float((keep != dropout.keep_mask(other, n, h, rate,
                                                   "cpu")).float().mean())
        # independent masks differ on 2 p (1 - p) of the elements
        assert abs(changed - 2 * p * (1 - p)) < 0.01


def test_dropout_bits_use_32_bit_words():
    """The plain hash stays within 32 bits (the CUDA version's uint32
    arithmetic) and spreads over the whole range."""
    rows = torch.arange(1 << 12)[:, None]
    cols = torch.arange(256)[None, :]
    words = dropout.dropout_bits((0xFFFFFFFF, 0xFFFFFFFF), rows, cols)
    assert int(words.min()) >= 0 and int(words.max()) < 2**32
    assert float(words.double().mean()) == pytest.approx(2**31, rel=0.01)


@pytest.mark.parametrize("scheduler", ["cosine", "restart"])
def test_lr_schedule_matches_jax(scheduler):
    for use in (True, False):
        cfg = TrainConfig(scheduler=scheduler, use_lr_scheduler=use)
        jcfg = JConfig(scheduler=scheduler, use_lr_scheduler=use)
        for epoch in (0, 1, 250, 499, 500, 1499, 1500, 3499):
            assert lr_for_epoch(cfg, epoch) == j_lr_for_epoch(jcfg, epoch)
