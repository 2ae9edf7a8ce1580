"""The port's mesh, data parallelism, dry run and scaling harness
(buckgnn_tpu_torch.parallel) against the JAX package's.

In this process: `make_mesh`, `initialize_distributed` (a world of one on
gloo; the card by default) and `host_shard`; the shards `train_gnn`
attaches for ``segment_impl="banded_partitioned"`` at two ``model`` shards
(``part`` for SAGE, ``ea_part`` for EA, with the run's caps) equal to the
JAX trainer's under a 2-device mesh, bit for bit.

In one gloo world of 4 processes (tests/torch_port_worlds.py::
parallel_world): `edge_partitioned_aggregate` against the JAX package's
`sage_aggregate`; the DP step on 2 ranks against the JAX package's
`make_parallel_train_step` on 2 virtual devices (loss, MAPE, the updated
parameters) and the sequential oracle (the graph-weighted mean of the
per-batch losses), as tests/test_parallel.py holds the JAX step; the dry
run at a 2 x 2 mesh (its own loss and update parities, both families);
`scaling_bench` and ``cli scale --device cpu`` at 2 ranks (the keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_port_worlds as worlds
from buckgnn_tpu import config as jconfig
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.graph import normalizer as jnorm
from buckgnn_tpu.graph.synthetic import generate_dataset as j_generate
from buckgnn_tpu.ops.sage import sage_aggregate as j_sage_aggregate
from buckgnn_tpu.parallel import dp as jdp
from buckgnn_tpu.parallel import mesh as jmesh
from buckgnn_tpu.train import trainer as jtr
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu_torch import config
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.parallel import mesh as tmesh
from buckgnn_tpu_torch.parallel.scaling import run_world
from buckgnn_tpu_torch.train import trainer
from torch_port_compare import same

# the DP step against JAX's: one Adam step from the same weights in
# float32 (test_torch_port_run.py's tolerances: losses to f32 round-off,
# parameters to round-off of lr-sized updates)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def test_mesh_initialize_and_host_shard(monkeypatch):
    """A world of one on gloo when nothing names a world; the call is
    idempotent; the card by default (no card: it raises); make_mesh's
    shape rule and error as the JAX package's; host_shard round-robin."""
    items = list(range(10))
    assert tmesh.host_shard(items, 1, 3) == jmesh.host_shard(items, 1, 3)
    assert tmesh.host_shard(items) == items
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.initialize_distributed()
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    try:
        topo = tmesh.initialize_distributed(device="cpu")
        assert topo == dict(process_index=0, process_count=1,
                            local_devices=1, global_devices=1)
        assert dist.get_backend() == "gloo"
        assert tmesh.initialize_distributed(device="cpu") == topo
        mesh = tmesh.make_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert tmesh.model_dim() == (None, 1, 0)
        with tmesh.set_mesh(mesh):
            assert tmesh.model_dim()[1:] == (1, 0)
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tmesh.make_mesh(n_data=2)
        assert tmesh.host_shard(items) == jmesh.host_shard(items, 0, 1)
    finally:
        dist.destroy_process_group()


class _Packed(Exception):
    pass


class _TwoShards:
    """A mesh's 'model' dim of two shards, for packing alone (no world)."""

    mesh_dim_names = ("data", "model")

    def size(self, i):
        return (1, 2)[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


def _host(s) -> dict:
    return {f.name: (v.numpy() if isinstance(v, torch.Tensor) else
                     np.asarray(v) if hasattr(v, "dtype") else v)
            for f in dataclasses.fields(s) for v in [getattr(s, f.name)]}


@pytest.mark.parametrize("model_name", ["GraphSage_addAggr_Shared",
                                        "EA_GNN_Shared"])
def test_packed_shards_match_jax_at_two_shards(tmp_path, monkeypatch,
                                               model_name):
    """train_gnn's first train batch at two 'model' shards carries the JAX
    trainer's part / ea_part: the 2-shard node alignment, the run's caps
    and flags. Each trainer stops at its first batch."""
    kw = dict(seed=7, min_side=8, max_side=10, use_virtual_edges=True)
    jds, jnz = jnorm.normalize_dataset(j_generate(12, **kw))
    ds, nz = normalize_dataset(generate_dataset(12, **kw))
    base = dict(hidden_channels=128, num_layers=2, num_epochs=1,
                batch_size=4, lr=1e-3, dropout_rate=0.0,
                segment_impl="banded_partitioned", model_name=model_name)
    jcfg, cfg = jconfig.TrainConfig(**base), config.TrainConfig(**base)
    seen = {}

    def jax_first(model, opt, batch, seed=0):
        seen["jax"] = batch
        raise _Packed

    real = trainer.attach_shards

    def port_first(*a, **k):
        seen["port"] = real(*a, **k)[0]
        raise _Packed

    monkeypatch.setattr(jtr, "init_state", jax_first)
    monkeypatch.setattr(trainer, "attach_shards", port_first)
    with jax.set_mesh(Mesh(np.array(jax.devices()[:2]), ("model",))):
        with pytest.raises(_Packed):
            jtr.train_gnn(jcfg, jds[:8], jds[8:], jnz, str(tmp_path / "j"),
                          verbose=False)
    with tmesh.set_mesh(_TwoShards()), pytest.raises(_Packed):
        trainer.train_gnn(cfg, ds[:8], ds[8:], nz, str(tmp_path / "p"),
                          verbose=False, device="cpu")
    field = "ea_part" if model_name.startswith("EA_") else "part"
    got, want = getattr(seen["port"], field), getattr(seen["jax"], field)
    assert got.n_shards == 2 and seen["port"].n_node_cap == \
        seen["jax"].n_node_cap
    same(_host(want), _host(got), field)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, then one gloo world of 4 processes running
    `worlds.parallel_world`."""
    ref, want = {}, {}
    rng = np.random.default_rng(0)
    n, e = 32, 256
    ref["ep_x"] = rng.normal(size=(n, 16)).astype(np.float32)
    ref["ep_s"] = rng.integers(0, n, size=e).astype(np.int32)
    ref["ep_r"] = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    ref["ep_probe"] = rng.normal(size=(n, 16)).astype(np.float32)
    for aggr in ("add", "mean", "max"):
        def f(v, aggr=aggr):
            return j_sage_aggregate(v, jnp.asarray(ref["ep_s"]),
                                    jnp.asarray(ref["ep_r"]), n, aggr=aggr,
                                    indices_are_sorted=False)
        want[f"ep_{aggr}"] = np.asarray(f(jnp.asarray(ref["ep_x"])))
        if aggr != "max":
            want[f"ep_grad_{aggr}"] = np.asarray(jax.grad(lambda v: jnp.sum(
                f(v) * ref["ep_probe"]))(jnp.asarray(ref["ep_x"])))

    jds, jnz = jnorm.normalize_dataset(j_generate(32, seed=0, min_side=3,
                                                  max_side=5))
    cfg = jconfig.TrainConfig(**worlds.DP_KW)
    ncap, ecap = jb.suggest_capacities(jds, 4)
    ecap = ((ecap + 255) // 256) * 256
    batches = list(jb.batch_iterator(jds, 4, ncap, ecap))[:2]
    model = jtr.build_model(cfg, jds[0].x.shape[1], jds[0].edge_attr.shape[1])
    opt = jtr.make_optimizer(cfg)
    state = jtr.init_state(model, opt, batches[0])
    criterion = j_loss(cfg.loss_function)
    mesh = jmesh.make_mesh(n_data=2, n_model=1)
    step = jdp.make_parallel_train_step(model, opt, criterion, cfg, jnz, mesh)
    new_state, metrics = step(
        state, jdp.shard_stacked_batch(jdp.stack_batches(batches), mesh),
        jax.random.key(0), jnp.float32(cfg.lr))
    want["dp_metrics"] = {k: float(v) for k, v in metrics.items()}
    _, estep = jtr.make_train_step(model, opt, criterion, cfg, jnz)
    losses = [float(estep(state, b)[0]["loss"]) for b in batches]
    weights = [float(np.sum(np.asarray(b.graph_mask))) for b in batches]
    want["sequential_loss"] = float(np.dot(losses, weights) / sum(weights))
    want["dp_params"] = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, new_state.params)).items()}
    ref.update({f"model.{k}": v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, state.params)).items()})
    path = tmp_path_factory.mktemp("parallel") / "ref.npz"
    np.savez(path, **ref)
    got = run_world(worlds.parallel_world, 4, args=(str(path),),
                    device="cpu", timeout=worlds.WORLD_TIMEOUT_S)[0]
    return got, want


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_edge_partitioned_aggregate_on_gloo_matches_jax(world, aggr):
    got, want = world
    np.testing.assert_allclose(got[f"ep_{aggr}"], want[f"ep_{aggr}"],
                               rtol=1e-5, atol=1e-5)
    if aggr != "max":
        np.testing.assert_allclose(got[f"ep_grad_{aggr}"],
                                   want[f"ep_grad_{aggr}"], rtol=1e-5,
                                   atol=1e-5)


def test_dp_step_on_gloo_matches_jax_and_the_sequential_loss(world):
    got, want = world
    m, jm = got["dp_metrics"], want["dp_metrics"]
    assert m.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(m["loss"], want["sequential_loss"],
                               rtol=LOSS_RTOL)


def test_dp_step_on_gloo_updates_as_jax(world):
    got, want = world
    assert got["dp_params"].keys() == want["dp_params"].keys()
    moved = 0
    for k, v in want["dp_params"].items():
        np.testing.assert_allclose(got["dp_params"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        moved += int(np.any(got["dp_params"][k] != 0))
    assert moved


@pytest.mark.parametrize("family", ["sage", "ea"])
def test_dryrun_on_a_two_by_two_mesh(world, family):
    """The dry run's loss and update parities held (it raises otherwise):
    here its numbers at a 2 x 2 mesh, the float32 gates."""
    got, _ = world
    r = got["dryrun"]
    assert r["mesh"] == [2, 2]
    f = r[family]
    loss = f["partitioned_loss" if family == "sage" else "loss"]
    np.testing.assert_allclose(loss, f["oracle_loss"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(f["update_l2"], f["oracle_update_l2"],
                               rtol=1e-4)
    assert f["cos"] > 1 - 1e-5 and np.isfinite(f.get("loss", loss))


@pytest.mark.parametrize("how", ["scaling_bench", "cli_scale"])
def test_scaling_harness_keys_at_two_ranks(world, how):
    got, _ = world
    if how == "cli_scale":
        rc, out = got["cli_scale"]
        assert rc == 0
        counts = {int(k) for k in out["per_count"]}
    else:
        out = got["scaling"]
        counts = set(out["per_count"])
    assert set(out) == {"n_devices", "per_count", "scaling_efficiency",
                        "edges_per_batch", "backend"}
    assert out["n_devices"] == 2 and out["backend"] == "cpu"
    assert counts == {1, 2}
    for c in out["per_count"].values():
        assert set(c) == {"steps_per_s", "graphs_per_s", "edges_per_s"}
        assert c["steps_per_s"] > 0
    assert out["scaling_efficiency"] > 0 and out["edges_per_batch"] > 0
