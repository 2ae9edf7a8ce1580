"""Latency benchmark — GNN surrogate vs FEA solver wall-clock, on the card.

The port of buckgnn_tpu/eval/timer.py (INFERENCE_TIMER.py:151-270): one
sample replicated to a full batch, warm-up, then a timed forward loop
reporting samples/s and per-sample latency; optionally the external
Nastran solver (single + parallel) for the speedup comparison when a
solver command is available, otherwise the GNN-only path (the
reference's NASTRAN=False switch, INFERENCE_TIMER.py:298). The host clock
spans work that ends in a device synchronize.
"""

from __future__ import annotations

import copy
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from buckgnn_tpu_torch.graph.batch import (
    GraphData, batch_iterator, select_band_geometry, suggest_capacities,
)
from buckgnn_tpu_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_gnn_forward(eval_step, sample: GraphData, batch_size: int = 128,
                     n_warmup: int = 3, n_timed: int = 20,
                     band_kw: dict | None = None, device=None):
    """Replicate one graph to a full batch (INFERENCE_TIMER.py:194-214) and
    time ``eval_step`` over it (:226-238). Returns the timings and the
    last step's metrics."""
    device = resolve_device(device)
    graphs = [copy.deepcopy(sample) for _ in range(batch_size)]
    ncap, ecap = suggest_capacities(graphs, batch_size, slack=1.1)
    if band_kw:
        tile = band_kw.get("band_tile", 256)
        align = 4 * tile  # the JAX package's 4-tile alignment
        ncap = ((max(ncap, tile + band_kw.get("band_width", 128)) + align - 1)
                // align) * align
    batch = next(iter(batch_iterator(graphs, batch_size, ncap, ecap,
                                     device=device, **(band_kw or {}))))
    for _ in range(n_warmup):
        m, _ = eval_step(batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        m, _ = eval_step(batch)
    _sync(device)
    dt = (time.perf_counter() - t0) / n_timed
    return dict(
        batch_time_s=dt,
        samples_per_s=batch_size / dt,
        latency_per_sample_ms=dt / batch_size * 1e3,
        metrics={k: float(v) for k, v in m.items()},
        n_node_cap=batch.n_node_cap,
    )


def time_nastran(
    bdf_paths: Sequence[str],
    nastran_cmd: str = "nastran",
    parallel: int = 1,
    timeout: float = 600.0,
):
    """Solver wall-clock, single + thread-parallel batches
    (INFERENCE_TIMER.py:48-149). Returns None when the solver binary is
    unavailable (hermetic environments)."""
    from shutil import which

    if which(nastran_cmd) is None:
        return None

    def run_one(path):
        t0 = time.perf_counter()
        subprocess.run(
            [nastran_cmd, path, "scr=yes", "bat=no", "news=no"],
            cwd=os.path.dirname(path) or ".",
            timeout=timeout,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            check=False,
        )
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    singles = [run_one(p) for p in bdf_paths[:1]]
    single_time = singles[0] if singles else None
    if parallel > 1:
        with ThreadPoolExecutor(max_workers=parallel) as ex:
            list(ex.map(run_one, bdf_paths))
        parallel_time = (time.perf_counter() - t0) / max(len(bdf_paths), 1)
    else:
        parallel_time = single_time
    return dict(single_time_s=single_time, parallel_per_sample_s=parallel_time)


def run_time_analysis(
    model_path: str,
    sample: GraphData,
    output_path: str | None = None,
    batch_size: int = 128,
    bdf_paths: Sequence[str] = (),
    nastran_cmd: str = "nastran",
    device=None,
):
    """Full comparison report (run_time_analysis, INFERENCE_TIMER.py:151-270)
    for a checkpoint of either package, timed on ``device`` (the CUDA card
    unless ``device="cpu"``). ``report["gnn"]`` holds the JAX package's
    three timings and the port's ``metrics`` and ``n_node_cap``."""
    from buckgnn_tpu_torch.eval.inference import load_model_from_checkpoint
    from buckgnn_tpu_torch.train import checkpoint as ckpt
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import make_eval_step

    device = resolve_device(device)
    model, train_cfg, config, normalizer = load_model_from_checkpoint(
        model_path, device)
    band_kw: dict = {}
    if train_cfg.segment_impl.startswith("banded"):
        # EA checkpoints: tile 128 for the fused block kernel (the
        # trainer's geometry, train/trainer.py::train_gnn)
        ea = str(config.get("model_name", "")).startswith("EA_")
        tile, width = select_band_geometry(
            [sample], **(dict(tile=128, widths=(64, 128)) if ea else {}),
        )
        band_kw = dict(band_width=width, band_tile=tile, rcm=True)
    ckpt.load_checkpoint(model_path, model)
    criterion = get_loss_function(train_cfg.loss_function)
    eval_step = make_eval_step(model, criterion, train_cfg, normalizer)

    gnn = time_gnn_forward(eval_step, sample, batch_size, band_kw=band_kw,
                           device=device)
    solver = time_nastran(bdf_paths, nastran_cmd) if bdf_paths else None

    report = {"gnn": gnn, "nastran": solver}
    if solver and solver.get("single_time_s"):
        report["speedup_vs_single"] = (
            solver["single_time_s"] / (gnn["latency_per_sample_ms"] / 1e3)
        )
    if output_path:
        with open(output_path, "w") as f:
            f.write(f"GNN batch={batch_size}: "
                    f"{gnn['samples_per_s']:.1f} samples/s, "
                    f"{gnn['latency_per_sample_ms']:.3f} ms/sample\n")
            if solver:
                f.write(f"Nastran single: {solver['single_time_s']:.2f} s\n")
                f.write(
                    f"Nastran parallel/sample: "
                    f"{solver['parallel_per_sample_s']:.2f} s\n"
                )
                if "speedup_vs_single" in report:
                    f.write(f"Speedup: {report['speedup_vs_single']:.0f}x\n")
            else:
                f.write("Nastran: unavailable (GNN-only mode)\n")
    return report
