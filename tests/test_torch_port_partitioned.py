"""The port's edge-partitioned SAGE aggregation
(buckgnn_tpu_torch.parallel.partitioned) == the JAX package's.

- `partition_batch` and `pad_partitioned` equal the JAX package's bit for
  bit at D = 1, 2 and 4, on supernode panels and on virtual-edge panels
  (which carry spill edges across shard boundaries);
- `partitioned_sage_aggregate` at D = 1 in this process, and at D = 2 and
  4 in one gloo world of 4 processes, against the JAX `shard_map` operator
  on the virtual CPU devices: forward and the gradient of <agg, probe> on
  real rows (tests/test_partitioned.py's tolerances: rtol 1e-5 / atol 1e-5
  forward, rtol 1e-4 gradients);
- `BuckGNN(impl="banded_partitioned")` at D = 4 against the JAX model under
  a 4-device mesh: pred and every parameter's gradient, with and without
  supernodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_port_worlds as worlds
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.models.buckgnn import BuckGNN as JBuckGNN
from buckgnn_tpu.parallel import partitioned as jpt
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.parallel import partitioned as tpt
from buckgnn_tpu_torch.parallel.scaling import run_world
from torch_port_compare import same

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
# the model's pred and gradients: f32 sums in another order through three
# layers (tests/test_partitioned.py's model tolerances)
MODEL = dict(rtol=1e-4, atol=1e-5)


def _ref_batch(n_graphs, seed, supernode, n_shards=4):
    """The JAX package's packing of `worlds.packed`'s graphs."""
    ds = generate_dataset(n_graphs, seed=seed, min_side=5, max_side=9,
                          use_super_node=supernode,
                          use_virtual_edges=not supernode)
    _, ours = worlds.packed(n_graphs, seed, supernode, n_shards)
    return ours, jb.pack_graphs(ds, ours.n_node_cap, ours.n_edge_cap,
                                n_graphs + 1, band_width=worlds.WIDTH,
                                band_tile=worlds.TILE)


def _host(pb) -> dict:
    return {f.name: (v.numpy() if isinstance(v, torch.Tensor) else
                     np.asarray(v) if hasattr(v, "dtype") else v)
            for f in dataclasses.fields(pb)
            for v in [getattr(pb, f.name)]}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("model",))


def _x(n, seed, h=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    x[-1] = 0.0
    return x, rng.normal(size=(n, h)).astype(np.float32)


def _jax_agg(ref, d, x, probe):
    pb = jpt.partition_batch(ref, d)
    mesh = _mesh(d)
    mask = jnp.asarray(ref.node_mask, jnp.float32)[:, None]
    agg = jax.jit(lambda v: jpt.partitioned_sage_aggregate(
        v, pb, mesh=mesh))(jnp.asarray(x))
    grad = jax.jit(jax.grad(lambda v: jnp.sum(
        jpt.partitioned_sage_aggregate(v, pb, mesh=mesh)
        * jnp.asarray(probe) * mask)))(jnp.asarray(x))
    return np.asarray(agg), np.asarray(grad)


@pytest.mark.parametrize("supernode", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_partition_batch_matches_jax_bit_for_bit(supernode, d):
    ours, ref = _ref_batch(8, 0, supernode)
    got, want = tpt.partition_batch(ours, d), jpt.partition_batch(ref, d)
    same(_host(want), _host(got), "partition_batch")
    assert got.has_spill == (not supernode)
    s_cap = int(got.send_idx.shape[-1]) + 16
    e_cap = int(got.recv_perm.shape[-1]) + 8
    same(_host(jpt.pad_partitioned(want, s_cap, e_cap, True)),
         _host(tpt.pad_partitioned(got, s_cap, e_cap, True)),
         "pad_partitioned")


@pytest.mark.parametrize("supernode", [False, True])
def test_partitioned_aggregate_one_shard_matches_jax(supernode):
    """D = 1 in this process: no exchange, the JAX package's n_shards == 1
    branches."""
    ours, ref = _ref_batch(8, 0, supernode)
    x, probe = _x(ours.n_node_cap, 1)
    want_agg, want_grad = _jax_agg(ref, 1, x, probe)
    pb = tpt.partition_batch(ours, 1)
    tx = torch.from_numpy(x).requires_grad_()
    agg = tpt.partitioned_sage_aggregate(tx, pb)
    mask = ours.node_mask.float()[:, None]
    (agg * torch.from_numpy(probe) * mask).sum().backward()
    m = ours.node_mask.numpy()
    np.testing.assert_allclose(agg.detach().numpy()[m], want_agg[m], **FWD)
    np.testing.assert_allclose(tx.grad.numpy()[m], want_grad[m], **GRAD)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, then one gloo world of 4 processes that runs
    every case of `worlds.partitioned_world`."""
    ref = {}
    want = {}
    for d, sup in worlds.AGG_CASES:
        ours, rb = _ref_batch(8, 0 if d == 4 else 3, sup)
        x, probe = _x(ours.n_node_cap, 2)
        ref[f"x_{d}_{sup}"], ref[f"probe_{d}_{sup}"] = x, probe
        want[f"agg_{d}_{sup}"], want[f"grad_{d}_{sup}"] = _jax_agg(
            rb, d, x, probe)
        want[f"mask_{d}_{sup}"] = ours.node_mask.numpy()
    for sup in (False, True):
        ours, rb = _ref_batch(8, 7, sup)
        kw = dict(num_node_features=ours.nodes.shape[1],
                  pooling_layer="supernode_with_pooling" if sup else "mean",
                  **worlds.MODEL_KW)
        m_ref = JBuckGNN(impl="banded", **kw)
        m_part = JBuckGNN(impl="banded_partitioned", **kw)
        params = m_ref.init(jax.random.key(0), rb,
                            deterministic=True)["params"]
        pbatch = rb.replace(part=jpt.partition_batch(rb, 4))

        def loss(p, m=m_part):
            pred, _ = m.apply({"params": p}, pbatch, deterministic=True)
            return jnp.sum(jnp.where(rb.graph_mask, pred, 0.0) ** 2), pred

        with jax.set_mesh(_mesh(4)):
            (_, pred), g = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
        want[f"pred_{sup}"] = np.asarray(pred)
        want[f"gm_{sup}"] = ours.graph_mask.numpy()
        want.update({f"g_{sup}.{k}": v.numpy() for k, v in params_from_flax(
            jax.tree.map(np.asarray, g)).items()})
        ref.update({f"model_{sup}.{k}": v.numpy() for k, v in
                    params_from_flax(jax.tree.map(np.asarray,
                                                  params)).items()})
    path = tmp_path_factory.mktemp("partitioned") / "ref.npz"
    np.savez(path, **ref)
    got = run_world(worlds.partitioned_world, 4, args=(str(path),),
                    device="cpu", timeout=worlds.WORLD_TIMEOUT_S)[0]
    return got, want


@pytest.mark.parametrize("d,supernode", worlds.AGG_CASES)
def test_partitioned_aggregate_on_gloo_matches_jax(world, d, supernode):
    got, want = world
    m = want[f"mask_{d}_{supernode}"]
    np.testing.assert_allclose(got[f"agg_{d}_{supernode}"][m],
                               want[f"agg_{d}_{supernode}"][m], **FWD)
    np.testing.assert_allclose(got[f"grad_{d}_{supernode}"][m],
                               want[f"grad_{d}_{supernode}"][m], **GRAD)


@pytest.mark.parametrize("supernode", [False, True])
def test_partitioned_model_on_gloo_matches_jax(world, supernode):
    got, want = world
    gm = want[f"gm_{supernode}"]
    np.testing.assert_allclose(got[f"pred_{supernode}"][gm],
                               want[f"pred_{supernode}"][gm], **MODEL)
    keys = sorted(k for k in want if k.startswith(f"g_{supernode}."))
    assert keys == sorted(k for k in got if k.startswith(f"g_{supernode}."))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MODEL)
