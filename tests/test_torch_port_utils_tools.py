"""The port's experiment harvesting (utils/harvest.py) and visual-validation
tooling (utils/visualization.py): the tests of tests/test_utils_tools.py on
the port, each held to the JAX module on the same inputs (the harvest's
index and arrays, the feature names, the table, the connectivity
reports)."""

import itertools
import json
import os
import sys

import numpy as np
import pytest

import buckgnn_tpu.graph.build as jbuild
import buckgnn_tpu.graph.synthetic as jsyn
import buckgnn_tpu.utils.harvest as jharvest
import buckgnn_tpu.utils.visualization as jvis
from buckgnn_tpu_torch.graph.build import build_graph
from buckgnn_tpu_torch.graph.synthetic import (
    fake_fea, generate_dataset, generate_mesh,
)
from buckgnn_tpu_torch.utils.harvest import (
    MetricPlotter,
    extract_scalars,
    find_runs,
    harvest,
    load_run_index,
)
from buckgnn_tpu_torch.utils.logging import MetricsWriter
from buckgnn_tpu_torch.utils.visualization import (
    connectivity_stats,
    feature_table,
    get_edge_feature_names,
    get_feature_names,
    plot_graph,
    plot_transform_check,
    virtual_edge_report,
)
from tests.torch_port_compare import same


def _fake_run(root, run_id, lr):
    d = os.path.join(root, run_id)
    w = MetricsWriter(d)
    for epoch in range(5):
        w.add_scalar("Loss/train", 1.0 / (epoch + 1), epoch)
        w.add_scalar("MAPE/val", 10.0 - epoch, epoch)
    w.close()
    ckpt = os.path.join(d, "weights", "best")
    os.makedirs(ckpt, exist_ok=True)
    with open(os.path.join(ckpt, "train_config.json"), "w") as f:
        json.dump({"lr": lr, "hidden_channels": 16}, f)
    return d


def _two_runs(tmp_path):
    root = str(tmp_path / "results")
    _fake_run(root, "run_a", 1e-2)
    _fake_run(root, "run_b", 1e-3)
    return root


def test_harvest_runs(tmp_path):
    root = _two_runs(tmp_path)
    runs = find_runs(root)
    assert len(runs) == 2
    assert all(r["config"] is not None for r in runs)

    scalars = extract_scalars(runs[0]["run_dir"])
    assert set(scalars) == {"Loss/train", "MAPE/val"}
    assert scalars["Loss/train"].shape == (5, 2)

    out = str(tmp_path / "harvested")
    index = harvest(root, out)
    assert set(index) == {"run_a", "run_b"}
    assert os.path.exists(os.path.join(out, "metric_Loss_train.npz"))
    assert index["run_a"]["config"]["lr"] == 1e-2
    assert load_run_index(out) == index


@pytest.mark.parametrize("source", ["tfevents", "csv"])
def test_harvest_matches_jax(tmp_path, monkeypatch, source):
    """One folder of runs written by the port's MetricsWriter (tfevents,
    or metrics.csv where tensorboard does not import): the same runs,
    scalars, index and metric arrays from both packages."""
    if source == "csv":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = _two_runs(tmp_path)
    assert {r["source"] for r in find_runs(root)} == {source}
    same(sorted(find_runs(root), key=lambda r: r["run_id"]),
         sorted(jharvest.find_runs(root), key=lambda r: r["run_id"]))
    run_dir = os.path.join(root, "run_a")
    same(extract_scalars(run_dir), jharvest.extract_scalars(run_dir))
    outs = [str(tmp_path / name) for name in ("port", "jax")]
    same(harvest(root, outs[0]), jharvest.harvest(root, outs[1]))
    same(load_run_index(outs[0]), jharvest.load_run_index(outs[1]))
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(outs[0], name)) as a, \
                    np.load(os.path.join(outs[1], name)) as b:
                same(dict(a), dict(b), name)


def test_metric_plotter(tmp_path):
    root = _two_runs(tmp_path)
    out = str(tmp_path / "harvested")
    harvest(root, out)
    p = MetricPlotter(out)
    same(p.metric("Loss/train"), jharvest.MetricPlotter(out).metric(
        "Loss/train"))
    curves = p.plot_curves("Loss/train", str(tmp_path / "curves.png"))
    box = p.plot_final_comparison("MAPE/val", str(tmp_path / "box.png"),
                                  last_k=3)
    assert os.path.getsize(curves) > 1000
    assert os.path.getsize(box) > 1000


FLAGS = ("use_z_coord", "use_rotations", "use_gp_forces",
         "use_mode_shapes_as_features", "use_super_node")


def test_feature_names_match_build_graph_width_and_jax():
    mesh = generate_mesh(seed=0, min_side=4, max_side=4,
                         with_stiffeners=True)
    res = fake_fea(mesh, seed=0)
    for kw in (
        dict(),
        dict(use_super_node=True, use_virtual_edges=False),
        dict(use_gp_forces=True),
        dict(use_rotations=True),
    ):
        g = build_graph(mesh, res, **kw)
        names = get_feature_names(
            "buckling",
            use_rotations=kw.get("use_rotations", False),
            use_gp_forces=kw.get("use_gp_forces", False),
            use_super_node=kw.get("use_super_node", False),
        )
        assert len(names) == g.x.shape[1], (kw, names)
    assert len(get_edge_feature_names()) == 5
    assert len(get_edge_feature_names(use_axial_stress=True)) == 6
    for ptype in ("buckling", "static"):
        for bits in itertools.product((False, True), repeat=len(FLAGS)):
            kw = dict(zip(FLAGS, bits))
            same(get_feature_names(ptype, **kw),
                 jvis.get_feature_names(ptype, **kw))
    for axial in (False, True):
        same(get_edge_feature_names(axial), jvis.get_edge_feature_names(axial))


def test_feature_table_and_plots(tmp_path):
    mesh = generate_mesh(seed=1, min_side=5, max_side=5)
    res = fake_fea(mesh, seed=1)
    g_orig = build_graph(mesh, res, transform=False, seed=1)
    g_trans = build_graph(mesh, res, transform=True, seed=1)
    table = feature_table(g_orig, g_trans, get_feature_names("buckling"))
    assert "X coord" in table and "Max |diff|" in table
    jmesh = jsyn.generate_mesh(seed=1, min_side=5, max_side=5)
    jres = jsyn.fake_fea(jmesh, seed=1)
    jgraphs = [jbuild.build_graph(jmesh, jres, transform=t, seed=1)
               for t in (False, True)]
    assert table == jvis.feature_table(*jgraphs,
                                       jvis.get_feature_names("buckling"))
    assert feature_table(g_orig, g_trans, max_rows=3) == \
        jvis.feature_table(*jgraphs, max_rows=3)
    p1 = plot_graph(g_trans, str(tmp_path / "g.png"), color_feature=2)
    p2 = plot_transform_check(g_orig, g_trans, str(tmp_path / "cmp.png"))
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


@pytest.mark.parametrize("supernode", [False, True])
def test_virtual_edges_shrink_graph_distances(supernode):
    kw = dict(seed=5, min_side=10, max_side=10, use_virtual_edges=True,
              use_super_node=supernode)
    (g,) = generate_dataset(1, **kw)
    report = virtual_edge_report(g)
    assert report["path_reduction"] > 0
    assert report["with_virtual"]["avg_shortest_path"] < \
        report["without_virtual"]["avg_shortest_path"]
    (jg,) = jsyn.generate_dataset(1, **kw)
    same(report, jvis.virtual_edge_report(jg))


def test_connectivity_stats_grid():
    kw = dict(seed=0, min_side=4, max_side=4, use_virtual_edges=False,
              use_super_node=False)
    (g,) = generate_dataset(1, **kw)
    stats = connectivity_stats(g)
    assert stats["diameter"] >= 2
    assert stats["avg_shortest_path"] > 1
    (jg,) = jsyn.generate_dataset(1, **kw)
    same(stats, jvis.connectivity_stats(jg))
    same(connectivity_stats(g, exclude_virtual=True),
         jvis.connectivity_stats(jg, exclude_virtual=True))
