"""BENCHMARK.json against the rules a benchmark file keeps, and the
files each of its names points to."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and len(spec["command"]) <= 32
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    cells = len(spec["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(spec["configs"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16
    assert 1 <= len(spec["per_layer"]) <= 128
    # a full check of 24 cells fits: 2 + 14 runs a cell, run_seconds + 60
    # each, 2 x 90 s of compile a cell, 1200 s spare
    assert ((2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(n for _, n in names)) == len(names)


def test_text_fields(spec):
    texts = [w["why"] for w in spec["workloads"]]
    texts += [c["source"] for c in spec["configs"]]
    texts += [c["why"] for c in spec["configs"]]
    texts += [m["layer"] for m in spec["per_layer"]]
    texts += spec["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_entry_keys(spec):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for e in spec[group]:
            assert set(e) <= keys, (group, set(e) - keys)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_cells(spec):
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(spec["workloads"]) // 4)
    used = {w["config"] for w in spec["workloads"]}
    assert used == configs


def test_paths_and_files(spec):
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    inside = tuple(p.rstrip("/") + "/" for p in spec["paths"])
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(inside) and os.path.exists(os.path.join(ROOT, f))
    for w in spec["workloads"]:
        for rel in (f"portbench/traffic/{w['traffic']}.json",
                    f"portbench/limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(ROOT, rel)), rel
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "metrics", f"{m['name']}.py"))


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in spec["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per = [m for m in spec["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert per, w["name"]


def test_moves_is_reported_where_the_metric_is(spec):
    """Every per-layer metric's ``moves`` is an end-to-end metric that each
    cell reporting the per-layer metric reports."""
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", cells), (m["name"], cell)


def test_layers_name_one_thing(spec):
    for m in spec["per_layer"]:
        assert m["layer"] == m["layer"].strip()


def test_metric_files_move_what_the_spec_says(spec):
    from portbench import run

    for m in spec["per_layer"]:
        mod = run.load_file_module(os.path.join(
            ROOT, "portbench", "metrics", f"{m['name']}.py"), "m")
        assert mod.MOVES == m["moves"], m["name"]
        assert callable(mod.read)


def test_configs_state_what_the_cells_run(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["compute_dtype"] == "float32"
        assert cfg["hidden_channels"] == 512 and cfg["num_layers"] == 6
        assert cfg["kernel_variant"] == "simple"
