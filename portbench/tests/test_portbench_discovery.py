"""A cell, a configuration, a traffic mix and a per-layer metric that a
later change adds as files and entries are found without an edit."""

import json
import os
import shutil
from types import SimpleNamespace

from conftest import ROOT


def copy_tree(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def test_new_files_are_found(tmp_path):
    from portbench import run

    root = copy_tree(tmp_path)
    with open(root / "portbench/configs/sage-f32.json") as f:
        cfg = json.load(f)
    cfg["batch_size"] = 64
    (root / "portbench/configs/sage-f32-b64.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/train-long.json").write_text(json.dumps(
        {"mode": "train", "batches": 1, "min_side": 40, "max_side": 48,
         "panel_seed": 3}))
    (root / "portbench/limits/sage-f32-b64.train-long.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0, "grad_gap": 1.0,
                               "change_gap": 1.0}}))
    (root / "portbench/metrics/panels.train.py").write_text(
        "MOVES = 'train_panels_per_s'\n\n\ndef read(ctx):\n"
        "    return sum(s['graphs'] for s in ctx.shapes)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sage-f32-b64", "source": "x",
                            "file": "portbench/configs/sage-f32-b64.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "sage-f32-b64.train-long",
                              "config": "sage-f32-b64",
                              "traffic": "train-long", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("sage-f32-b64.train-long")
    spec["per_layer"].append({"name": "panels.train", "unit": "panels",
                              "better": "higher", "source": "host_clock",
                              "layer": "train step",
                              "moves": "train_panels_per_s",
                              "workloads": ["sage-f32-b64.train-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = run.resolve(str(root), "sage-f32-b64.train-long")
    assert c.cfg["batch_size"] == 64 and c.traffic["min_side"] == 40
    assert [m["name"] for m in c.e2e] == ["train_panels_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["panels.train"]
    ctx = SimpleNamespace(shapes=[{"graphs": 64}])
    assert run.read_per_layer(c, ctx) == {
        "panels.train": {"value": 64.0, "unit": "panels"}}
    # the traffic file alone sets the panels
    from portbench.traffic.generator import make_panels

    panels = make_panels(dict(c.traffic, batches=1), 3, seed=5)[0]
    assert all(40 * 40 <= len(p["coords"]) <= 48 * 48 for p in panels)


def test_metric_that_finds_nothing_is_left_out(tmp_path):
    from portbench import run

    root = copy_tree(tmp_path)
    c = run.resolve(str(root), "sage-f32.serve")
    trace = SimpleNamespace(kernels=[], busy_us=0.0)
    ctx = SimpleNamespace(cfg=c.cfg, ref=c.ref, passes="serve", trace=trace,
                          shapes=[dict(nodes=10, edges=20, graphs=2,
                                       node_features=16, edge_features=5)],
                          calls={0: 1}, window_s=1.0, setup_data_s=0.5)
    got = run.read_per_layer(c, ctx)
    # no kernel in the trace: the roofline and idle share read nothing
    assert set(got) == {"setup_data_s", "mfu.serve"}


STUB_REFERENCE = '''
from portbench.metrics import counts
from portbench.reference import common, sage

EDGE_SLOTS = False
spec = sage.spec
forward = sage.forward


def layer_calls(cfg, shape):
    n, e, h = shape["nodes"], shape["edges"], cfg["hidden_channels"]
    return [dict(counts.sage_layer(n, e, h), kind="stub")
            for _ in range(cfg["num_layers"])]
'''


def test_new_model_is_found(tmp_path):
    """A configuration of a model the benchmark has not seen brings its
    reference module; the counts, the per-layer readers and the batch
    layout take what they need from it, with no edit elsewhere."""
    from portbench import run

    root = copy_tree(tmp_path)
    (root / "portbench/reference/stub.py").write_text(STUB_REFERENCE)
    with open(root / "portbench/configs/sage-f32.json") as f:
        cfg = json.load(f)
    cfg.update(model_name="GraphSage_meanAggr_Shared", reference="stub")
    (root / "portbench/configs/stub-f32.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub-f32", "source": "x",
                            "file": "portbench/configs/stub-f32.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "stub-f32.train", "config": "stub-f32",
                              "traffic": "train", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sage-f32.train" in m.get("workloads", []):
            m["workloads"].append("stub-f32.train")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = run.resolve(str(root), "stub-f32.train")
    assert c.ref.EDGE_SLOTS is False and c.ref.__file__.startswith(
        str(root))
    shape = dict(nodes=100, edges=400, graphs=4, node_features=16,
                 edge_features=5)
    trace = SimpleNamespace(kernels=[("wtile_kernel", 0.0, 1e6)],
                            busy_us=1e6)
    ctx = SimpleNamespace(cfg=c.cfg, ref=c.ref, passes="train", trace=trace,
                          shapes=[shape], calls={0: 2}, window_s=1.0,
                          setup_data_s=0.5)
    got = run.read_per_layer(c, ctx)
    # the model is counted from its own reference; the SAGE roofline finds
    # no call of its kind, so it reads nothing
    assert got["mfu.train"]["value"] > 0.0
    assert "sage_roofline.train" not in got
    assert "idle_share.train" in got and "setup_data_s" in got
