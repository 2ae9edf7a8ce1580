"""Post-hoc experiment harvesting + metric plotting.

Re-implements the reference's TensorBoard-mining tools
(Utils/search_tensorboard_logs.py, Utils/plot_metrics.py): walk a results
tree for event files paired with checkpoints (:7-27), extract every scalar
series via EventAccumulator (:29-60), join each run with its checkpoint's
config (:85-147), write per-metric shards + a run index (:149-240), and
render smoothed training curves / run-comparison box plots
(plot_metrics.py:103-250).

The port of buckgnn_tpu/utils/harvest.py. It reads what the port's
training run writes: utils/logging.py::MetricsWriter's tfevents, or its
``metrics.csv`` when tensorboard does not import, and the
``weights/{best,last}/train_config.json`` of train/checkpoint.py. tensorboard
and matplotlib are imported only by the functions that need them.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

__all__ = ["find_runs", "extract_scalars", "harvest", "MetricPlotter",
           "load_run_index"]


def find_runs(results_root: str) -> list[dict]:
    """Locate run directories: any dir holding tfevents or metrics.csv,
    with its sibling checkpoint config when present
    (search_tensorboard_logs.py:7-27)."""
    runs = []
    for root, dirs, files in os.walk(results_root):
        has_events = any(f.startswith("events.out.tfevents") for f in files)
        has_csv = "metrics.csv" in files
        if not (has_events or has_csv):
            continue
        config = None
        for cand in (
            os.path.join(root, "weights", "best", "train_config.json"),
            os.path.join(root, "weights", "last", "train_config.json"),
        ):
            if os.path.exists(cand):
                with open(cand) as f:
                    config = json.load(f)
                break
        runs.append({"run_dir": root, "run_id": os.path.basename(root),
                     "config": config,
                     "source": "tfevents" if has_events else "csv"})
    return runs


def extract_scalars(run_dir: str) -> dict[str, np.ndarray]:
    """tag -> [steps, values] array from tfevents or metrics.csv
    (search_tensorboard_logs.py:29-60)."""
    csv_path = os.path.join(run_dir, "metrics.csv")
    series: dict[str, list] = defaultdict(list)
    if any(f.startswith("events.out.tfevents") for f in os.listdir(run_dir)):
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )

        acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            for ev in acc.Scalars(tag):
                series[tag].append((ev.step, ev.value))
    elif os.path.exists(csv_path):
        import csv as _csv

        with open(csv_path) as f:
            for row in _csv.reader(f):
                if len(row) == 3 and row[0] != "tag":
                    try:
                        series[row[0]].append((int(row[2]), float(row[1])))
                    except ValueError:
                        continue
    return {
        tag: np.asarray(sorted(vals), dtype=np.float64).reshape(-1, 2)
        for tag, vals in series.items()
    }


def harvest(results_root: str, out_dir: str) -> dict:
    """Re-shard all runs per metric + write run_index.json
    (search_tensorboard_logs.py:149-240). Returns the index dict."""
    os.makedirs(out_dir, exist_ok=True)
    runs = find_runs(results_root)
    per_metric: dict[str, dict[str, np.ndarray]] = defaultdict(dict)
    index = {}
    for run in runs:
        scalars = extract_scalars(run["run_dir"])
        index[run["run_id"]] = {
            "run_dir": run["run_dir"],
            "config": run["config"],
            "metrics": sorted(scalars),
            "n_points": {t: int(len(v)) for t, v in scalars.items()},
        }
        for tag, arr in scalars.items():
            per_metric[tag][run["run_id"]] = arr
    for tag, by_run in per_metric.items():
        safe = tag.replace("/", "_")
        np.savez_compressed(
            os.path.join(out_dir, f"metric_{safe}.npz"),
            **{rid: arr for rid, arr in by_run.items()},
        )
    with open(os.path.join(out_dir, "run_index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return index


def load_run_index(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "run_index.json")) as f:
        return json.load(f)


def _smooth(values: np.ndarray, weight: float) -> np.ndarray:
    """TensorBoard-style exponential smoothing (plot_metrics.py:118-126)."""
    out = np.empty_like(values)
    last = values[0]
    for i, v in enumerate(values):
        last = last * weight + (1 - weight) * v
        out[i] = last
    return out


class MetricPlotter:
    """Smoothed curves and run-comparison box plots
    (plot_metrics.py:103-250). Lazy-imports matplotlib so headless
    pipelines never pay for it."""

    def __init__(self, harvest_dir: str):
        self.harvest_dir = harvest_dir
        self.index = load_run_index(harvest_dir)

    def metric(self, tag: str) -> dict[str, np.ndarray]:
        safe = tag.replace("/", "_")
        path = os.path.join(self.harvest_dir, f"metric_{safe}.npz")
        with np.load(path) as z:
            return {rid: z[rid] for rid in z.files}

    def plot_curves(self, tag: str, out_path: str, smoothing: float = 0.6,
                    logy: bool = False) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        for rid, arr in sorted(self.metric(tag).items()):
            ax.plot(arr[:, 0], _smooth(arr[:, 1], smoothing), label=rid)
        ax.set_xlabel("epoch")
        ax.set_ylabel(tag)
        if logy:
            ax.set_yscale("log")
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path

    def plot_final_comparison(self, tag: str, out_path: str,
                              last_k: int = 10) -> str:
        """Box plot of each run's last-k values (plot_metrics.py:200-250)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        data = sorted(self.metric(tag).items())
        fig, ax = plt.subplots(figsize=(max(6, len(data)), 5))
        ax.boxplot([arr[-last_k:, 1] for _, arr in data],
                   tick_labels=[rid for rid, _ in data])
        ax.set_ylabel(tag)
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right", fontsize=7)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
