"""The port's command line (`python -m buckgnn_tpu_torch`) on the CPU.

The parser holds every option of the JAX package's eight workflow
subcommands (and ``scale``'s) with the same option strings, defaults,
choices and dests, apart from the port's ``--device``; the same argv
gives equal data and train configs. Then the README's order end to end
with ``--device cpu`` at H 16, 2 layers, 2 epochs: datagen, split,
flatten, train, infer, timer; tune on synthetic data with two concurrent
trials; ``scale``'s refusal. Beside them: `expand_grid` and
`ASHAStopper` against the JAX package's, and the kernel build's lock.
"""

import argparse
import dataclasses
import json
import os
import stat
import subprocess
import sys
import threading

import pytest

import buckgnn_tpu.cli as jcli
import buckgnn_tpu.train.tune as jtune
import buckgnn_tpu_torch.cli as tcli
import buckgnn_tpu_torch.train.tune as ttune
from buckgnn_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("datagen", "train", "tune", "infer", "timer", "split",
            "flatten", "bench", "scale")
SMALL = ["--hidden-channels", "16", "--num-layers", "2", "--num-epochs", "2",
         "--batch-size", "8"]


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    """Each option's strings, dest, default, choices, type, nargs, action
    class and whether it is required."""
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices,
                 getattr(a.type, "__name__", a.type), a.nargs,
                 type(a).__name__, a.required)
        for a in sub._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax():
    jsubs, tsubs = _subparsers(jcli.build_parser()), _subparsers(
        tcli.build_parser())
    assert tuple(jsubs) == tuple(tsubs) == COMMANDS
    for name in COMMANDS:
        got = _options(tsubs[name])
        device = got.pop("device", None)
        assert got == _options(jsubs[name]), name
        if name in ("train", "tune", "infer", "timer", "scale"):
            assert device[:2] == (("--device",), None), name
        else:
            assert device is None, name


@pytest.mark.parametrize("argv", [
    [],
    ["--use-super-node", "--model-name", "GraphSage_addAggr_Shared",
     "--hidden-channels", "512", "--num-layers", "6", "--compute-dtype",
     "bfloat16", "--segment-impl", "banded_pallas", "--batch-size", "128",
     "--lr", "1e-3", "--num-epochs", "3"],
    ["--prediction-type", "static_stress", "--use-z-coord", "--use-rotations",
     "--no-virtual-edges", "--no-transform", "--scheduler", "none",
     "--min-lr", "1e-5", "--remat", "--no-materialize-band",
     "--virtual-edge-percentage", "0.2", "--loss-function", "graph_mae"],
    ["--scheduler", "restart", "--t-0", "7", "--t-mult", "3",
     "--dropout-rate", "0", "--pooling-layer", "supernode_only",
     "--weight-decay", "0.1", "--seed", "9", "--no-remat"],
])
def test_configs_from_argv_match_jax(argv):
    """`_data_cfg` and `_train_cfg` build equal configs from the same
    train argv (the port's TrainConfig has no ``rng_impl``)."""
    base = ["train", "--synthetic", "4"] + argv
    jargs = jcli.build_parser().parse_args(base)
    targs = tcli.build_parser().parse_args(base + ["--device", "cpu"])
    jd, td = jcli._data_cfg(jargs), tcli._data_cfg(targs)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    jt = dataclasses.asdict(jcli._train_cfg(jargs, jd))
    jt.pop("rng_impl")
    assert jt == dataclasses.asdict(tcli._train_cfg(targs, td))


def test_expand_grid_and_asha_match_jax():
    """The grid's trials, and ASHA's stop decisions on one fixed sequence
    of (epoch, metric) reports over its rungs."""
    grid = {"lr": [1e-2, 1e-3], "hidden_channels": [16, 32, 64], "seed": 3}
    jgrid = {k: jtune.GridSearch(v) if isinstance(v, list) else v
             for k, v in grid.items()}
    tgrid = {k: ttune.GridSearch(v) if isinstance(v, list) else v
             for k, v in grid.items()}
    assert jtune.expand_grid(jgrid) == ttune.expand_grid(tgrid)
    assert len(ttune.expand_grid(tgrid)) == 6
    reports = [(e, 10.0 / (1 + t) + 0.3 * ((7 * t + e) % 5))
               for t in range(12) for e in range(40)]
    for mode in ("min", "max"):
        kw = dict(mode=mode, grace_period=2, reduction_factor=3, max_t=40)
        js, ts = jtune.ASHAStopper(**kw), ttune.ASHAStopper(**kw)
        got = [ts.should_stop(e, v) for e, v in reports]
        assert got == [js.should_stop(e, v) for e, v in reports]
        assert any(got) and not all(got)
        assert js.rungs == ts.rungs


# --------------------------- end to end, CPU --------------------------- #

@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """datagen (3 models x 2 loadcases into Train/, 2 x 2 into
    Validation/), split, then train --data-dir on the pair."""
    root = tmp_path_factory.mktemp("cli")
    d = root / "D"
    assert tcli.main(["datagen", "--out-dir", str(d / "Train"), "--n-models",
                      "3", "--loadcases-per-model", "2", "--stiffeners",
                      "--seed", "0"]) == 0
    assert tcli.main(["datagen", "--out-dir", str(d / "Validation"),
                      "--n-models", "2", "--loadcases-per-model", "2",
                      "--seed", "100"]) == 0
    assert tcli.main(["split", "--data-dir", str(d / "Train"), "--out-dir",
                      str(root / "S"), "--lengths", "0.5", "0.5",
                      "--n-bins", "3"]) == 0
    return root


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_flow_on_the_cpu(flow, capsys, tmp_path):
    """train on the datagen folders, then infer and timer on its
    weights/best: finite results, the served MAPE the best epoch's, and
    the timer's nastran null without a solver command and with a missing
    one. The split wrote its manifest and the folder's cache."""
    d = flow / "D"
    capsys.readouterr()
    manifest = json.loads((flow / "S" / "split_manifest.json").read_text())
    assert sum(manifest["sizes"]) == 6
    assert (d / "Train" / "dataset_cache_buckling.npz").exists()
    assert tcli.main(["train", "--data-dir", str(d), "--output-dir",
                      str(tmp_path / "runs"), "--device", "cpu",
                      "--dropout-rate", "0"] + SMALL) == 0
    run = _last_json(capsys)
    best = os.path.join(run["log_dir"], "weights", "best")
    assert os.path.exists(os.path.join(best, "state.pt"))
    assert tcli.main(["infer", "--model-path", best, "--data-dir",
                      str(d / "Validation"), "--output-dir",
                      str(tmp_path / "inf"), "--batch-size", "8",
                      "--device", "cpu"]) == 0
    served = _last_json(capsys)
    assert served["MAPE"] == pytest.approx(run["best_val_mape"], rel=1e-5)
    for extra in ([], ["--nastran-cmd", str(tmp_path / "no-such-solver")]):
        assert tcli.main(["timer", "--model-path", best, "--data-dir",
                          str(d / "Validation"), "--batch-size", "4",
                          "--output-path", str(tmp_path / "timer.txt"),
                          "--device", "cpu"] + extra) == 0
        timed = _last_json(capsys)
        assert timed["samples_per_s"] > 0 and timed["nastran"] is None
    assert "GNN-only" in (tmp_path / "timer.txt").read_text()


def test_cli_flatten(flow, capsys, tmp_path):
    capsys.readouterr()
    assert tcli.main(["flatten", "--data-dir", str(flow / "D" / "Train"),
                      "--out-dir", str(tmp_path / "flat"),
                      "--samples-per-bin", "2"]) == 0
    out = _last_json(capsys)
    assert 0 < out["selected"] <= out["total"] == 6
    assert (tmp_path / "flat" / "dataset_flattened.npz").exists()


def test_cli_tune_runs_two_trials_at_once(tmp_path, capsys, monkeypatch):
    """tune --synthetic with two grid points and --max-concurrent 2 on the
    CPU: both trials finish, on the CPU, in overlapping intervals."""
    seen = []
    real = ttune.hyperparameter_optimization

    def recording(*a, **kw):
        best, results = real(*a, **kw)
        seen.append((kw, results))
        return best, results

    monkeypatch.setattr(ttune, "hyperparameter_optimization", recording)
    capsys.readouterr()
    assert tcli.main(["tune", "--synthetic", "8", "--output-dir",
                      str(tmp_path), "--grid", '{"lr": [1e-2, 1e-3]}',
                      "--grace-period", "1", "--max-concurrent", "2",
                      "--device", "cpu"] + SMALL) == 0
    assert _last_json(capsys)["n_trials"] == 2
    (kw, results), = seen
    assert kw["device"] == "cpu" and kw["max_concurrent"] == 2
    a, b = (r["schedule"] for r in results)
    assert a["device"] == b["device"] == "cpu"
    assert a["start"] < b["end"] and b["start"] < a["end"]
    assert [r["config"]["lr"] for r in results] == [1e-2, 1e-3]


def test_cli_scale_refuses_and_device_defaults_to_the_card(monkeypatch):
    """scale, train and tune run on the card unless told --device cpu:
    without a card they raise (scale runs on gloo in
    test_torch_port_parallel.py)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["scale"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["train", "--synthetic", "4"] + SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttune.hyperparameter_optimization({"num_epochs": 1}, [], [], None,
                                          "unused", max_concurrent=2)


def test_python_m_help_lists_the_commands():
    res = subprocess.run([sys.executable, "-m", "buckgnn_tpu_torch",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "{" + ",".join(COMMANDS) + "}" in res.stdout


# ------------------------------ the build ------------------------------ #

def test_build_runs_one_compile_for_two_threads(tmp_path, monkeypatch):
    """Two threads that ask for one kernel at once start one compiler (a
    stub that counts its runs and writes its -o file after a pause) and
    leave the library in place."""
    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi\n'
        "  shift\n"
        "done\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(stub))
    built, barrier = [], threading.Barrier(2)

    def ask():
        barrier.wait()
        built.append(cuda_build.build_all(["epilogue"]))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls.read_text().splitlines() == ["run"]
    assert sorted(len(b) for b in built) == [0, 1]
    lib = cuda_build.lib_path("epilogue")
    assert lib.startswith(str(tmp_path)) and os.path.exists(lib)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(lib), os.path.basename(lib)[:-3] + ".log"])


def test_launch_counts_add_up_across_threads():
    counts = {"k": 0}

    def add():
        for _ in range(20000):
            cuda_build.count_launch(counts, "k")

    threads = [threading.Thread(target=add) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts == {"k": 80000}
