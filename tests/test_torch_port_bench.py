"""The port's bench (buckgnn_tpu_torch/bench.py) on the CPU: the flagship
train setup on tiny panels runs `run_train_bench` to finite numbers, and
`main()` prints the repo-root bench.py's JSON line."""

import importlib
import json
import math

import numpy as np
import pytest

from buckgnn_tpu_torch import bench
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset


@pytest.fixture(scope="module")
def setup():
    """The flagship cell's model (6 layers, H 512, bf16, banded_pallas) and
    training config on 128 supernode panels of 3-4 nodes a side, on the
    CPU (each kernel's plain version)."""
    data = normalize_dataset(generate_dataset(
        128, seed=0, min_side=3, max_side=4, use_super_node=True,
        use_virtual_edges=False))
    return bench.build_train_setup(device="cpu", data=data)


def test_train_bench_runs_on_cpu(setup):
    cfg = setup["cfg"]
    assert (cfg.hidden_channels, cfg.num_layers, cfg.compute_dtype,
            cfg.segment_impl) == (512, 6, "bfloat16", "banded_pallas")
    assert setup["n_graphs"] == 128 and setup["lr"] == bench.TRAIN_LR
    res = bench.run_train_bench(setup, n_warmup=1, n_steps=2)
    assert res["n_edges"] == setup["n_edges"] > 0
    for k in ("train_step_ms", "train_edges_per_s"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert all(math.isfinite(v) for v in res["metrics"].values())
    assert set(res["metrics"]) == {"loss", "mape"}


def test_main_prints_the_jax_bench_line(setup, monkeypatch, capsys):
    """main() prints one JSON line with the keys, metric name and unit of
    the repo-root bench.py's line, against the same V100 estimate: both
    mains run here on stand-in setups of a known throughput."""
    root = importlib.import_module("bench")
    assert bench.V100_TRAIN_EDGES_PER_S_EST == root.V100_TRAIN_EDGES_PER_S_EST
    edges_per_s = 1.25e7
    monkeypatch.setattr(root, "build_bench_setup", lambda **kw: None)
    monkeypatch.setattr(root, "run_bench",
                        lambda s: {"train_edges_per_s": edges_per_s})
    root.main()
    want = json.loads(capsys.readouterr().out.strip())

    monkeypatch.setattr(bench, "build_train_setup", lambda: setup)
    runs = []

    def run_train_bench(s):
        runs.append(s)
        return {"train_edges_per_s": edges_per_s}

    monkeypatch.setattr(bench, "run_train_bench", run_train_bench)
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and runs == [setup]
    got = json.loads(lines[0])
    assert list(got) == list(want)
    assert got == want
    assert np.isclose(got["vs_baseline"], 2.5)
