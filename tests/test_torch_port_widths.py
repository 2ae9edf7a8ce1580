"""Float32 and every H % 128 == 0 for the SAGE kernels #1-#4.

On the card ``ops/banded_matmul.py::kernel_variant`` sends bf16 at H in
{128, 256, 512} to the product engine's kernels and float32 at any H % 128
== 0, and bf16 at the other widths, to ``csrc/sage_simple.cu``; H % 128 !=
0 takes the slab product, as in the JAX package. On the CPU every wrapper
runs its plain version. Held here:
- the rule over (dtype, H), and the slab route below whole 128 columns;
- in float32 at H = 384 and 640, widths only the simple variants take on
  the card: the fused layer's forward and its merged backward (a supernode
  batch), its spill forward and split backward (a virtual-edge batch) and
  the band product with spill, table and acc, against the JAX package's
  Pallas kernels in interpret mode at dropout 0;
- the ``flagship-f32`` and ``virtual-f32`` cells' TrainConfigs against the
  one the JAX ``build_bench_setup(compute_dtype="float32")`` builds, and one
  train step of the float32 flagship cell (hidden 512) on tiny panels.

Inputs are made with numpy from a seed and given to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu import config as j_config
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.banded import make_agg_context as j_ctx
from buckgnn_tpu.ops.pallas_banded import pallas_banded_matmul
from buckgnn_tpu.ops.pallas_sage_layer import fused_sage_layer as j_layer
from buckgnn_tpu_torch import bench
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import banded as bd
from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context

TILE, WIDTH = 128, 64
# fp32 against JAX: the same algorithm in float32, sums in another order:
# 1e-4 relative, with an absolute floor of 1e-5 of the largest entry
RTOL, ATOL_FRAC = 1e-4, 1e-5
WIDTHS = [384, 640]


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_variant_covers_every_width(dtype):
    """Every float32 and bf16 width with H % 128 == 0 has a kernel: the
    engine's for bf16 at 128, 256 and 512, the simple one otherwise; other
    dtypes and widths raise, and band_route takes the slab product for
    H % 128 != 0 as the JAX rule does."""
    for h in range(128, 4097, 128):
        want = ("engine" if dtype == torch.bfloat16 and h in (128, 256, 512)
                else "simple")
        assert bm.kernel_variant(dtype, h) == want
        assert bd.band_route("cuda", dtype, h, True)
    for h in (32, 96, 200, 500):
        with pytest.raises(NotImplementedError, match="H % 128 == 0"):
            bm.kernel_variant(dtype, h)
        assert not bd.band_route("cuda", dtype, h, True)
        assert not bd.band_route("cpu", dtype, h, True)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
            bm.kernel_variant(bad, 128)


def _batches(kind, seed=0):
    """(ours, ref) packed from the same graphs: "super" (supernode panels,
    local star windows, no spill) or "virtual" (virtual edges that spill
    out of the band)."""
    ds = generate_dataset(12, seed=seed, min_side=5, max_side=9,
                          use_super_node=kind == "super",
                          use_virtual_edges=kind == "virtual")
    n = sum(g.n_node for g in ds) + 1
    ncap = ((max(n, TILE + WIDTH) + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(ds, ncap, ecap, 13, device="cpu", **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, 13, **kw)
    assert ours.has_spill_edges == (kind == "virtual")
    assert ours.has_supernode_edges == (kind == "super")
    return ours, ref


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("kind", ["super", "virtual"])
def test_layer_and_grads_match_jax_fp32(h, kind):
    """z and dx, dW_l, db_l, dW_r of one fused layer (skip on) == the JAX
    layer and jax.vjp at rate 0: the merged backward on the supernode
    batch, the spill forward and split backward on the virtual-edge
    batch."""
    ours, ref = _batches(kind, seed=1)
    assert sl.supports_fused_layer(make_agg_context(ours, use_pallas=True),
                                   torch.zeros((1, h)), "add", True)
    n = ours.n_node_cap
    rng = np.random.default_rng(h)
    x = rng.normal(size=(n, h)).astype(np.float32)
    x[-1] = 0.0
    w_l, b_l, w_r = ((rng.normal(size=s) / np.sqrt(h)).astype(np.float32)
                     for s in ((h, h), (h,), (h, h)))
    probe = rng.normal(size=(n, h)).astype(np.float32)
    probe *= ours.node_mask.numpy()[:, None]

    ctx = j_ctx(ref, band_dtype=jnp.float32, use_pallas=True)
    layer = jax.jit(lambda *a: jax.vjp(
        lambda *b: j_layer(*b, ctx, skip=True, rate=0.0,
                           seed=jnp.zeros((2,), jnp.int32),
                           deterministic=False), *a[:4])[1](a[4]) + (
        j_layer(*a[:4], ctx, skip=True, rate=0.0,
                seed=jnp.zeros((2,), jnp.int32), deterministic=False),))
    *want, z_j = layer(*(jnp.asarray(a) for a in (x, w_l, b_l, w_r, probe)))

    params = [torch.from_numpy(a).requires_grad_()
              for a in (x, w_l, b_l, w_r)]
    z, _ = sl.fused_sage_layer(*params, make_agg_context(ours), skip=True,
                               deterministic=False)
    (z * torch.from_numpy(probe)).sum().backward()
    m = ours.node_mask.numpy()
    _close(z.detach().numpy()[m], np.asarray(z_j)[m], "z")
    _close(params[0].grad.numpy()[m], np.asarray(want[0])[m], "dx")
    for p, w, name in zip(params[1:], want[1:], ("dW_l", "db_l", "dW_r")):
        _close(p.grad.numpy(), w, name)


@pytest.mark.parametrize("h", WIDTHS)
def test_band_product_matches_jax_fp32(h):
    """banded_matmul (its plain version here) with the spill window, a star
    table by code and acc == JAX pallas_banded_matmul in interpret mode."""
    ours, _ = _batches("virtual", seed=2)
    n = ours.n_node_cap
    rng = np.random.default_rng(h + 1)
    x, acc = (rng.normal(size=(n, h)).astype(np.float32) for _ in range(2))
    tgr = 16
    gcode = rng.integers(0, tgr + 1, size=(n // TILE, TILE, 1)).astype(
        np.int32)
    table = rng.normal(size=(tgr, h)).astype(np.float32)
    band = ours.band.reshape(n // TILE, TILE, TILE + WIDTH)
    spill = dict(spill_offsets=ours.spill_offsets, spill_lo=ours.spill_lo,
                 spill_hi=ours.spill_hi)
    tx = torch.from_numpy(x)
    got = bm.banded_matmul(
        band, tx, tile=TILE, width=WIDTH, out_dtype=torch.float32,
        spill_messages=tx[ours.spill_senders.long()], gcode=torch.from_numpy(
            gcode), table=torch.from_numpy(table), acc=torch.from_numpy(acc),
        **spill)
    jx = jnp.asarray(x)
    want = pallas_banded_matmul(
        jnp.asarray(band.numpy()), jx, TILE, WIDTH, interpret=True,
        out_dtype=jnp.float32,
        spill_messages=jx[jnp.asarray(ours.spill_senders.numpy())],
        gcode=jnp.asarray(gcode), table=jnp.asarray(table),
        acc=jnp.asarray(acc),
        **{k: jnp.asarray(v.numpy()) for k, v in spill.items()})
    _close(got.numpy(), np.asarray(want), "band product")


@pytest.mark.parametrize("cell,super_node", [("flagship-f32", True),
                                             ("virtual-f32", False)])
def test_f32_cells_are_the_jax_float32_bench(cell, super_node, monkeypatch):
    """The float32 cells' TrainConfig fields == the TrainConfig that the
    repo-root bench.py's build_bench_setup(compute_dtype="float32") makes
    for the same cell (captured as it is built, on a two-panel dataset)."""
    import bench as root_bench

    seen, real = [], j_config.TrainConfig

    class Stop(Exception):
        pass

    def capture(**kw):
        seen.append(real(**kw))
        raise Stop

    monkeypatch.setattr(j_config, "TrainConfig", capture)
    ds = generate_dataset(2, seed=0, min_side=3, max_side=4,
                          use_super_node=super_node,
                          use_virtual_edges=not super_node)
    with pytest.raises(Stop):
        root_bench.build_bench_setup(compute_dtype="float32", dataset=ds,
                                     use_super_node=super_node)
    want = seen[0]
    got = bench.cell_config(cell)
    for field in ("hidden_channels", "num_layers", "batch_size",
                  "segment_impl", "compute_dtype", "model_name",
                  "dropout_rate", "loss_function", "weight_decay"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.compute_dtype == "float32"
    base = bench.cell_config(cell[:-4])
    assert base.compute_dtype == "bfloat16"
    assert bench.CELLS[cell] == dict(bench.CELLS[cell[:-4]],
                                     compute_dtype="float32")


def test_f32_flagship_trains_on_cpu():
    """The flagship-f32 cell at its own width (hidden 512) on tiny panels:
    a float32 model whose fused layers take the batch, and two finite
    train steps."""
    data = normalize_dataset(generate_dataset(
        128, seed=0, min_side=3, max_side=4, use_super_node=True,
        use_virtual_edges=False))
    setup = bench.build_train_setup(device="cpu", config="flagship-f32",
                                    data=data)
    model = setup["state"].model
    assert setup["cfg"].compute_dtype == "float32"
    assert model.shared_graphsage_block.lin_l.weight.shape == (512, 512)
    res = bench.run_train_bench(setup, n_warmup=1, n_steps=1)
    assert all(np.isfinite(v) for v in res["metrics"].values())
