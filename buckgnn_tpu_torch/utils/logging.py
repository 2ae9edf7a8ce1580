"""Metric writing: TensorBoard scalars + plain-text results files.

The port of buckgnn_tpu/utils/logging.py, the reference's observability
surface (SURVEY §5): TensorBoard scalars Loss/{train,train_batch,
validation}, MAPE/{train,val}, Learning_Rate (TRAIN_FINAL.py:307-389) and a
per-epoch `results.txt` (:234-238,443-445). Falls back to ``metrics.csv``
when tensorboard does not import.
"""

from __future__ import annotations

import csv
import os


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._csv_file = open(os.path.join(log_dir, "metrics.csv"), "a",
                                  newline="")
            self._csv = csv.writer(self._csv_file)
            self._csv.writerow(["tag", "value", "step"])
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._csv.writerow([tag, float(value), step])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._csv_file.close()


class ResultsFile:
    """results.txt in the reference's format (TRAIN_FINAL.py:234-238)."""

    def __init__(self, path: str, header: dict | None = None):
        self.path = path
        if header is not None:
            with open(path, "w") as f:
                for k, v in header.items():
                    f.write(f"{k} : {v}\n\n")

    def append(self, line: str) -> None:
        with open(self.path, "a") as f:
            f.write(line + "\n")
