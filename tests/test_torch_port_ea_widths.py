"""Float32 and every H % 128 == 0 for the fused EA block's kernels #5/#6.

On the card ``ops/banded_matmul.py::kernel_variant`` sends the EA block in
bf16 at H in {128, 256, 512} to the product engine's kernels
(csrc/ea_block_{fwd,bwd}.cu) and in float32 at any H % 128 == 0, and bf16
at the other widths, to ``csrc/ea_simple.cu``; anything else raises before
a launch. On the CPU the wrappers run their plain versions. Held here:
- the rule for every (dtype, H) in {float32, bf16, float16} x {128, 192,
  384, 512, 640, 1024}, as the wrappers ask it (`eb.block_variant`);
- `fused_ea_block` and its VJP against the JAX package's `fused_ea_block`
  in interpret mode at float32 H = 384, a width only the simple variants
  take on the card, in plain mode (skip on) and in encoder mode, at the
  tolerance of tests/test_torch_port_ea_block.py (``REL`` 2e-4, the same
  algorithm in float32 with sums in another order);
- the ``ea-virtual-f32`` cell against the JAX float32 EA bench
  configuration (benchmarks/bench_configs.py's EA row built by
  ``build_bench_setup(compute_dtype="float32")``);
- a float32 ``EA_GNN_Shared`` at H = 384 (2 layers) on the fused block:
  two train steps with finite, decreasing loss.

Inputs are made with numpy from a seed and given to both sides.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu import config as j_config
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.pallas_ea_block import fused_ea_block as j_block
from buckgnn_tpu_torch import bench
from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.blocks import MLP, GraphNetBlock
from buckgnn_tpu_torch.ops import ea_block as eb
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import (
    build_model, init_state, make_optimizer, make_train_step,
)

TILE, WIDTH = 128, 64
H = 384
# fp32 against JAX: the same algorithm in float32 with sums in another
# order, 2e-4 of the largest entry (tests/test_torch_port_ea_block.py, the
# JAX EA test's tolerance)
REL = 2e-4
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
WIDTHS = [128, 192, 384, 512, 640, 1024]


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_the_rule_over_dtype_and_width(dtype, h):
    """bf16 at 128, 256 and 512 takes the engine, float32 at every H % 128
    == 0 and bf16 at the other such widths the simple variant; float16
    and H = 192 raise a ValueError naming the dtype and the width."""
    x = torch.zeros((64, h), dtype=dtype)
    if dtype == torch.float16 or h % 128:
        with pytest.raises(ValueError, match=f"{dtype} at H = {h}"):
            eb.block_variant(x)
        return
    want = ("engine" if dtype == torch.bfloat16 and h in (128, 256, 512)
            else "simple")
    assert eb.block_variant(x) == want


def _batches(n_graphs=8):
    """(ours, ref) packed from the same virtual-edge panels of 8-11 nodes a
    side at tile 128, width 64: 6 node tiles with far senders."""
    ds = generate_dataset(n_graphs, seed=2, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + 2 * TILE - 1) // (2 * TILE)) * (2 * TILE)
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(ds, ncap, ecap, n_graphs + 1, device="cpu", **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, n_graphs + 1, **kw)
    assert ncap // TILE >= 4
    assert int((ours.win_far_tsend != ncap - 1).sum()) > 0, "far senders"
    return ours, ref


def _lin(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / denom < REL, what


@pytest.mark.parametrize("mode,skip", [("plain", True), ("encoder", False)])
def test_block_and_vjp_match_jax_fp32_at_h384(mode, skip):
    """zx, ze and the gradients of x, the window (plain mode) and every
    parameter (the edge encoder's too in encoder mode) == the JAX block
    and jax.vjp at rate 0, float32, H = 384."""
    ours, ref = _batches()
    enc = mode == "encoder"
    rng = np.random.default_rng(7)
    mlp = lambda i: {"lin_0": _lin(rng, i, H), "lin_1": _lin(rng, H, H)}
    params = {"edge_mlp": mlp(3 * H), "node_mlp_phi": mlp(2 * H),
              "node_mlp_gamma": mlp(2 * H), "node_mlp_beta": mlp(H)}
    enc_params = ({"lin_0": _lin(rng, 5, 64), "lin_1": _lin(rng, 64, 128),
                   "lin_2": _lin(rng, 128, H)} if enc else None)
    x = rng.normal(size=(ours.n_node_cap, H)).astype(np.float32)
    x[-1] = 0.0
    t, w = ours.win_sidx.shape
    e = (ours.win_edges.numpy() if enc
         else rng.normal(size=(t, w, H)).astype(np.float32))
    dzx = rng.normal(size=x.shape).astype(np.float32)
    dze = rng.normal(size=(t, w, H)).astype(np.float32)

    def f(x_, e_, p_, q_):
        return j_block(x_, e_, p_, ref, skip=skip, rate=0.0, seed=None,
                       deterministic=True, encoder_params=q_)

    (jzx, jze), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(e), params,
                              enc_params)
    jdx, jde, jdp, jdq = vjp((jnp.asarray(dzx), jnp.asarray(dze)))

    blk = GraphNetBlock(H)
    blk.load_state_dict(params_from_flax(params))
    encoder = None
    if enc:
        encoder = MLP(5, (64, 128, H))
        encoder.load_state_dict(params_from_flax(enc_params))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(e, requires_grad=not enc)
    zx, ze = eb.fused_ea_block(xt, et, blk, eb.make_ea_context(ours),
                               skip=skip, encoder=encoder)
    ((zx * torch.tensor(dzx)).sum()
     + (ze * torch.tensor(dze)).sum()).backward()
    valid = (ours.win_ridx < TILE).numpy()
    _close(zx.detach(), jzx, "zx")
    _close(ze.detach().numpy()[valid], np.asarray(jze)[valid], "ze")
    _close(xt.grad, jdx, "dx")
    if not enc:
        _close(et.grad.numpy()[valid], np.asarray(jde)[valid], "de_win")
    jg = params_from_flax(jax.tree.map(np.asarray, jdp))
    for k, p in blk.named_parameters():
        _close(p.grad, jg[k], k)
    if enc:
        jq = params_from_flax(jax.tree.map(np.asarray, jdq))
        for k, p in encoder.named_parameters():
            _close(p.grad, jq[k], f"edge_encoder.{k}")


def test_ea_f32_cell_is_the_jax_float32_ea_bench(monkeypatch):
    """The ea-virtual-f32 cell's TrainConfig fields == the TrainConfig that
    the repo-root bench.py's build_bench_setup makes for
    benchmarks/bench_configs.py's EA row with compute_dtype="float32"
    (captured as it is built, on a two-panel dataset), and its batch,
    tile and width are that row's."""
    import bench as root_bench

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "bench_configs.py")
    spec = importlib.util.spec_from_file_location("bench_configs", path)
    configs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(configs)
    (row,) = [kw for label, kw in configs.ROWS if label == "ea-virtual"]
    seen, real = [], j_config.TrainConfig

    class Stop(Exception):
        pass

    def capture(**kw):
        seen.append(real(**kw))
        raise Stop

    monkeypatch.setattr(j_config, "TrainConfig", capture)
    ds = generate_dataset(2, seed=0, min_side=3, max_side=4,
                          use_super_node=False, use_virtual_edges=True)
    with pytest.raises(Stop):
        root_bench.build_bench_setup(compute_dtype="float32", dataset=ds,
                                     **row)
    want = seen[0]
    got = bench.cell_config("ea-virtual-f32")
    for field in ("hidden_channels", "num_layers", "batch_size",
                  "segment_impl", "compute_dtype", "model_name",
                  "dropout_rate", "loss_function", "weight_decay"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.compute_dtype == "float32"
    assert bench.cell_config("ea-virtual").compute_dtype == "bfloat16"
    cell = bench.CELLS["ea-virtual-f32"]
    assert cell == dict(bench.CELLS["ea-virtual"], compute_dtype="float32")
    assert (cell["batch_size"], cell["band_tile"], cell["band_width"],
            cell["use_super_node"]) == (row["batch_size"], row["band_tile"],
                                        row["band_width"],
                                        row["use_super_node"])


def test_f32_ea_model_trains_at_h384_on_cpu(monkeypatch):
    """A float32 EA_GNN_Shared at H = 384, 2 layers, on the fused block
    (layer 0 with the in-kernel encoder): two Adam steps with finite,
    decreasing loss, every block call on the fused path."""
    ds = generate_dataset(8, seed=3, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    normed, nz = normalize_dataset(ds)
    n = sum(g.n_node for g in normed) + 1
    ncap = ((n + 2 * TILE - 1) // (2 * TILE)) * (2 * TILE)
    ecap = ((sum(g.n_edge for g in normed) + 127) // 128) * 128
    (batch,) = tb.batch_iterator(normed, 8, ncap, ecap, band_width=WIDTH,
                                 band_tile=TILE, rcm=True, device="cpu")
    assert eb.supports_fused_encoder(batch, H, normed[0].edge_attr.shape[1])
    calls = []
    real = eb.ea_block_fwd_plain

    def counted(*a, **kw):
        calls.append((a[0].dtype, a[0].shape[1], kw["enc"]))
        return real(*a, **kw)

    monkeypatch.setattr(eb, "ea_block_fwd_plain", counted)
    cfg = TrainConfig(hidden_channels=H, num_layers=2,
                      compute_dtype="float32", dropout_rate=0.0, lr=1e-3,
                      model_name="EA_GNN_Shared",
                      segment_impl="banded_pallas")
    model = build_model(cfg, normed[0].x.shape[1],
                        normed[0].edge_attr.shape[1], device="cpu")
    state = init_state(model, make_optimizer(cfg, model))
    step, _ = make_train_step(state.model, state.optimizer,
                              get_loss_function(cfg.loss_function), cfg, nz)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, cfg.lr, gen)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    assert calls == [(torch.float32, H, True), (torch.float32, H, False)] * 2
