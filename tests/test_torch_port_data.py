"""The port's host pipeline (buckgnn_tpu_torch.graph) == the JAX package's.

Data generation, normalization and packing are NumPy on both sides, so
every comparison here is exact. The JAX side may order nodes with the C++
RCM kernel, so the packing comparisons hand both sides graphs already in
one order (the port's RCM) and pack with ``rcm=False``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.graph.normalizer import normalize_dataset as j_normalize
from buckgnn_tpu.graph.synthetic import generate_dataset as j_generate
from buckgnn_tpu.utils.native import _rcm_order_numpy
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.build import rcm_reorder
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.utils.native import rcm_order

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_FIELDS = ("x", "senders", "receivers", "edge_attr", "y", "supernode",
                "eigenvalue", "mode_shapes")


def _assert_graphs_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in GRAPH_FIELDS:
            va, vb = getattr(ga, f), getattr(gb, f)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f)
                assert va.dtype == vb.dtype, f
            else:
                assert va == vb, f


@pytest.mark.parametrize("supernode,virtual,stiff", [
    (True, False, False), (False, True, True), (False, False, False),
])
def test_generate_and_normalize_match(supernode, virtual, stiff):
    kw = dict(seed=3, min_side=4, max_side=8, use_super_node=supernode,
              use_virtual_edges=virtual, with_stiffeners=stiff)
    ours = generate_dataset(5, **kw)
    ref = j_generate(5, **kw)
    _assert_graphs_equal(ours, ref)
    _assert_graphs_equal(normalize_dataset(ours)[0], j_normalize(ref)[0])


def test_rcm_order_matches_numpy_reference():
    for g in generate_dataset(4, seed=1, min_side=5, max_side=9,
                              use_super_node=False, use_virtual_edges=True):
        np.testing.assert_array_equal(
            rcm_order(g.n_node, g.senders, g.receivers),
            _rcm_order_numpy(g.n_node, g.senders, g.receivers))


def _ordered(n_graphs, seed, supernode, virtual=False, side=(5, 9)):
    ds = generate_dataset(n_graphs, seed=seed, min_side=side[0],
                          max_side=side[1],
                          use_super_node=supernode,
                          use_virtual_edges=virtual)
    return [rcm_reorder(g) for g in normalize_dataset(ds)[0]]


def _assert_batches_equal(ours, ref):
    for f in tb._TENSOR_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(b)
        a = a.numpy()
        assert a.shape == b.shape, f
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("band_tile", "band_width", "has_supernode_edges",
              "has_spill_edges", "has_spill2_edges", "n_node_cap",
              "n_edge_cap", "n_graph_cap"):
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("supernode,virtual,side", [
    (True, False, (5, 9)), (False, True, (14, 18)),
])
def test_pack_graphs_fields_match(supernode, virtual, side):
    graphs = _ordered(6, 2, supernode, virtual, side)
    tile, width = 128, 64
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((max(n, tile + width) + tile - 1) // tile) * tile
    ecap = ((sum(g.n_edge for g in graphs) + 127) // 128) * 128
    kw = dict(band_width=width, band_tile=tile)
    ours = tb.pack_graphs(graphs, ncap, ecap, 7, device="cpu", **kw)
    ref = jb.pack_graphs(graphs, ncap, ecap, 7, **kw)
    assert ours.has_supernode_edges == supernode
    if supernode:
        assert ours.gwin is not None
    else:
        assert ours.has_spill_edges
    _assert_batches_equal(ours, ref)


@pytest.mark.parametrize("local_star_windows", [True, False])
def test_batch_iterator_fields_match(local_star_windows):
    """Several batches: run-uniform spill caps and flags, and the
    all-or-nothing local star windows."""
    graphs = _ordered(12, 5, supernode=True)
    kw = dict(band_width=64, band_tile=128, rcm=False,
              local_star_windows=local_star_windows)
    ncap, ecap = 512, 4096
    ours = list(tb.batch_iterator(graphs, 5, ncap, ecap, device="cpu", **kw))
    ref = list(jb.batch_iterator(graphs, 5, ncap, ecap, **kw))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert (o.gwin is not None) == local_star_windows
        _assert_batches_equal(o, r)


@pytest.mark.parametrize("supernode,virtual", [(True, False), (False, True)])
def test_select_band_geometry_matches(supernode, virtual):
    ds = normalize_dataset(generate_dataset(
        6, seed=4, min_side=6, max_side=12, use_super_node=supernode,
        use_virtual_edges=virtual))[0]
    for tile in (128, 256):
        assert (tb.select_band_geometry(ds, tile=tile, rcm=False)
                == jb.select_band_geometry(ds, tile=tile, rcm=False))
    assert tb.suggest_capacities(ds, 4) == jb.suggest_capacities(ds, 4)
    assert tb.capacity_for(ds) == jb.capacity_for(ds)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No card and no explicit device="cpu": the entry points raise."""
    from buckgnn_tpu_torch.bench import build_serve_setup
    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.train.trainer import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graphs = _ordered(2, 0, supernode=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.pack_graphs(graphs, 512, 2048, 3, band_width=64, band_tile=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(TrainConfig(), 16, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_setup()


# the command line and the modules it brought (ROADMAP items 8b-8c, 10a)
CLI_MODULES = tuple(f"buckgnn_tpu_torch.{m}" for m in (
    "__main__", "cli", "graph.mesh", "graph.op2", "graph.io", "graph.folder",
    "graph.split", "graph.flatten", "graph.materialize", "datagen",
    "datagen.shapes", "datagen.loadcases", "datagen.runner", "eval.timer",
    "train.tune", "parallel", "parallel.mesh", "parallel.edge_partition",
    "parallel.partitioned", "parallel.ea_shard", "parallel.dp",
    "parallel.scaling", "parallel.dryrun"))


def test_port_imports_no_jax():
    """Importing every module of the port, the command line, the
    folder-dataset, datagen, tuning and timer modules and the multi-device
    ones (parallel/*) among them, leaves
    jax, flax and buckgnn_tpu out of sys.modules (checked in a fresh
    interpreter: this test process has imported jax already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import buckgnn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {CLI_MODULES!r} if m not in sys.modules]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'buckgnn_tpu'))\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
