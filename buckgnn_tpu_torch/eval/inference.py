"""Inference / evaluation — checkpoint-driven, INFERENCE.py parity.

The port of buckgnn_tpu/eval/inference.py: restores the model, normalizer
and hyperparameters purely from a checkpoint directory of either package
(INFERENCE.py:65-87; train/checkpoint.py reads a JAX ``state.msgpack``
too), evaluates a dataset, and writes the same report surface: per-run
scalars, ``inference_results.txt``, and a row appended to a cumulative
report CSV (the reference appends to a global Excel file,
INFERENCE.py:24-51), mirrored to ``.xlsx`` when pandas and an Excel writer
import.
"""

from __future__ import annotations

import csv
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from buckgnn_tpu_torch.graph.batch import (
    GraphData, batch_iterator, select_band_geometry, suggest_capacities,
)
from buckgnn_tpu_torch.train import checkpoint as ckpt
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.metrics import stress_errors
from buckgnn_tpu_torch.train.trainer import (
    build_model, make_eval_step, slice_static_targets,
)
from buckgnn_tpu_torch.utils.device import resolve_device
from buckgnn_tpu_torch.utils.logging import MetricsWriter

CONFIG_KEYS = [
    "num_node_features", "num_edge_features", "hidden_channels", "num_layers",
    "use_edge_attr", "use_z_coord", "use_rotations", "prediction_type",
    "pooling_layer", "dropout_rate", "model_name",
]  # (INFERENCE.py:20)
BUCKLING_METRICS = ["MAPE", "MIN MAPE", "MAX MAPE"]  # (INFERENCE.py:19)
STATIC_METRICS = ["re", "max_disp_rel", "max_disp_mae"]  # (INFERENCE.py:18)


def load_model_from_checkpoint(model_path: str, device=None):
    """``(model, train_config, checkpoint_config, normalizer)``: the model
    built from the stored configs on ``device`` (the CUDA card unless
    ``device="cpu"``), its weights still those of ``train_config.seed``
    (`run_inference` loads the stored ones)."""
    train_cfg, ckpt_cfg, normalizer = ckpt.load_checkpoint_configs(model_path)
    model = build_model(train_cfg, ckpt_cfg["num_node_features"],
                        ckpt_cfg["num_edge_features"], device=device)
    return model, train_cfg, ckpt_cfg, normalizer


def update_report(report_path: str, results: dict, model_path: str,
                  data_dir: str, config: dict) -> None:
    """Append a row to the cumulative report (update_excel_report,
    INFERENCE.py:24-51)."""
    columns = ["Weight Dir", "Data Dir"] + CONFIG_KEYS + BUCKLING_METRICS + (
        STATIC_METRICS
    )
    row = {"Weight Dir": os.path.dirname(model_path), "Data Dir": data_dir}
    for k in CONFIG_KEYS:
        row[k] = config.get(k)
    for m in BUCKLING_METRICS + STATIC_METRICS:
        row[m] = results.get(m)
    new_file = not os.path.exists(report_path)
    with open(report_path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=columns)
        if new_file:
            w.writeheader()
        w.writerow(row)
    try:  # optional Excel mirror
        import pandas as pd
    except ImportError:
        return
    xlsx = os.path.splitext(report_path)[0] + ".xlsx"
    try:
        pd.read_csv(report_path).to_excel(xlsx, index=False)
    except ImportError:  # no Excel writer (openpyxl) installed
        pass


def run_inference(
    model_path: str,
    test_data: Sequence[GraphData],
    output_dir: str,
    batch_size: int = 128,
    report_path: str | None = None,
    data_dir: str = "",
    device=None,
):
    """Evaluate a normalized dataset against a checkpoint (run_inference,
    INFERENCE.py:53-208) on ``device`` (the CUDA card unless
    ``device="cpu"``). ``test_data`` must already be normalized with the
    checkpoint's normalizer (`load_model_from_checkpoint` gives it)."""
    device = resolve_device(device)
    model, train_cfg, config, normalizer = load_model_from_checkpoint(
        model_path, device)
    prediction_type = config["prediction_type"]

    test_data = slice_static_targets(test_data, prediction_type)

    ncap, ecap = suggest_capacities(test_data, batch_size)
    if train_cfg.segment_impl.startswith("banded"):
        # the trainer's geometry (train_gnn): EA checkpoints on tile 128,
        # node capacity aligned to 4 tiles
        ea = str(config.get("model_name", "")).startswith("EA_")
        tile, width = select_band_geometry(
            test_data, **(dict(tile=128, widths=(64, 128)) if ea else {}),
        )
        align = 4 * tile
        ncap = ((max(ncap, tile + width) + align - 1) // align) * align
        band_kw = dict(band_width=width, band_tile=tile, rcm=True)
    else:
        band_kw = {}
    batches = list(batch_iterator(test_data, batch_size, ncap, ecap,
                                  device=device, **band_kw))
    ckpt.load_checkpoint(model_path, model)

    criterion = get_loss_function(train_cfg.loss_function)
    eval_step = make_eval_step(model, criterion, train_cfg, normalizer)

    results_dir = Path(output_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    timestamp = time.strftime("%Y%m%d-%H%M%S")
    writer = MetricsWriter(str(results_dir / f"inference_{timestamp}"))
    results_file = results_dir / "inference_results.txt"

    stats = normalizer.device_stats()
    if prediction_type == "buckling":
        scale, center = stats["eigenvalue_scale"], stats["eigenvalue_center"]
        total_mape, n_graphs = 0.0, 0
        min_mape, max_mape = np.inf, -np.inf
        for b in batches:
            _, (pred, _) = eval_step(b)
            gm = b.graph_mask.cpu().numpy()
            p = pred.float().cpu().numpy()[gm] * scale + center
            t = b.y[:, 0].cpu().numpy()[gm] * scale + center
            mapes = np.abs((t - p) / t)
            total_mape += float(np.sum(mapes)) * 100
            n_graphs += int(gm.sum())
            min_mape = min(min_mape, float(mapes.min()) * 100)
            max_mape = max(max_mape, float(mapes.max()) * 100)
        avg = total_mape / n_graphs
        writer.add_scalar("MAPE/test", avg, 0)
        writer.add_scalar("MAPE-min/test", min_mape, 0)
        writer.add_scalar("MAPE-max/test", max_mape, 0)
        with results_file.open("w") as f:
            f.write(f"Final Test MAPE: {avg:.2f}%\n")
            f.write(f"Final Test Min MAPE: {min_mape:.2f}%\n")
            f.write(f"Final Test Max MAPE: {max_mape:.2f}%\n")
        results = {"MAPE": avg, "MIN MAPE": min_mape, "MAX MAPE": max_mape}
    else:
        key, threshold = (("displacement", 0.0001)
                          if prediction_type == "static_disp"
                          else ("gp_stress", 0.2))
        scale = torch.as_tensor(stats[f"{key}_scale"], device=device)
        center = torch.as_tensor(stats[f"{key}_center"], device=device)
        agg: dict = {}
        n_graphs = 0
        for b in batches:
            _, (pred, aux) = eval_step(b)
            d = stress_errors(
                pred.float() * scale + center, b.y * scale + center,
                b.node_graph, aux["real_node_mask"], b.graph_mask,
                prediction_type, threshold,
            )
            for k, v in d.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n_graphs += int(b.graph_mask.sum())
        # stress_errors returns per-graph sums; the reference averages per
        # sample (INFERENCE.py:153-172), so divide by the graph count
        res = {k: agg.get(k, 0.0) / max(n_graphs, 1)
               for k in STATIC_METRICS}
        for k, v in res.items():
            writer.add_scalar(f"{k}/test", v, 0)
        with results_file.open("w") as f:
            f.write("Final Test Metrics:\n")
            for k, v in res.items():
                f.write(f"{k}: {v:.4f}\n")
        results = res

    if report_path is not None:
        update_report(report_path, results, model_path, data_dir, config)
    writer.close()
    return results
