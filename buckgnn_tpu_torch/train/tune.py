"""Hyperparameter search — grid expansion + ASHA-style early stopping.

The reference drives Ray Tune with an ASHAScheduler over grid_search specs
(hyperparameter_optimization, TRAIN_FINAL.py:99-147: metric Val_MAPE min for
buckling / Validation_Loss for static, grace period, reduction factor). This
is a dependency-free equivalent: trials run sequentially on the chip (the
reference also ran 1 trial per GPU), each with an ASHA rung-based stopping
hook plugged into `train_gnn`'s report_fn.

The port of buckgnn_tpu/train/tune.py. Concurrent trials run in threads,
as there, each on a device of a round-robin pool: the CUDA cards
(``torch.cuda.device_count()``), or the CPU when the caller passes
``device="cpu"``; each trial's `train_gnn` launches on its device's
current stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.train.trainer import train_gnn
from buckgnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GridSearch:
    """Marker for grid-searched values (tune.grid_search parity,
    TRAIN_FINAL.py:59)."""

    values: Sequence


def expand_grid(config: dict) -> list[dict]:
    """Expand every GridSearch field into the cross-product of configs."""
    grid_keys = [k for k, v in config.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [dict(config)]
    combos = itertools.product(*(config[k].values for k in grid_keys))
    out = []
    for combo in combos:
        c = dict(config)
        for k, v in zip(grid_keys, combo):
            c[k] = v
        out.append(c)
    return out


def _device_pool(device) -> list:
    """The devices concurrent trials take turns on: ``device`` when given,
    else every CUDA card (none raises, as `resolve_device` does)."""
    if device is not None:
        return [torch.device(device)]
    resolve_device(None)
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


class ASHAStopper:
    """Asynchronous-successive-halving rungs for a single metric.

    Promotion rule: at each rung (grace_period * reduction_factor^k epochs)
    a trial continues only if its metric is in the top 1/reduction_factor of
    completed observations at that rung.
    """

    def __init__(self, metric="val_mape", mode="min", grace_period=1,
                 reduction_factor=4, max_t=1000):
        self.metric = metric
        self.sign = 1.0 if mode == "min" else -1.0
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.rungs: dict[int, list[float]] = {}
        # concurrent trials (max_concurrent > 1) report to shared rungs
        # from worker threads — exactly Ray's ASYNC successive halving,
        # where each arrival compares against the observations so far
        self._lock = threading.Lock()
        r = grace_period
        while r < max_t:
            self.rungs[r] = []
            r *= reduction_factor

    def should_stop(self, epoch: int, value: float) -> bool:
        rung = epoch + 1
        if rung not in self.rungs:
            return False
        with self._lock:
            scores = self.rungs[rung]
            scores.append(self.sign * value)
            k = max(1, math.ceil(len(scores) / self.rf))
            cutoff = sorted(scores)[k - 1]
            return self.sign * value > cutoff


def hyperparameter_optimization(
    base_config: dict,
    train_data,
    val_data,
    normalizer,
    output_dir: str,
    prediction_type: str = "buckling",
    grace_period: int | None = None,
    reduction_factor: int = 4,
    verbose: bool = False,
    max_concurrent: int = 1,
    device=None,
):
    """Run all grid trials with ASHA early stopping; returns
    (best_config_dict, results list) — TRAIN_FINAL.py:99-147 parity.

    ``grace_period=None`` defaults to num_epochs // 10 (the reference's ASHA
    used grace windows far below max_t, TRAIN_FINAL.py:122-134); a grace
    period >= num_epochs would make early stopping inert.

    ``max_concurrent > 1`` schedules trials asynchronously across devices
    (the role of Ray Tune's trial executor, TRAIN_FINAL.py:122-134): a
    thread pool runs up to that many trials at once, each on a device
    from a round-robin pool (the CUDA cards, or the CPU when ``device`` is
    ``"cpu"``), and ASHA rungs fill from whichever trials arrive first —
    true ASYNC successive halving instead of the sequential
    approximation. ``device=None`` means the cards, as everywhere in the
    port; a sequential search runs on ``device``."""
    metric = "val_mape" if prediction_type == "buckling" else "val_loss"
    trials = expand_grid(base_config)
    max_t = int(base_config.get("num_epochs", 1000))
    if grace_period is None:
        grace_period = max(1, max_t // 10)
    stopper = ASHAStopper(
        metric=metric, mode="min", grace_period=grace_period,
        reduction_factor=reduction_factor, max_t=max_t,
    )
    field_names = {f.name for f in dataclasses.fields(TrainConfig)}

    def run_trial(i, cdict, device):
        cfg = TrainConfig(**{
            k: v for k, v in cdict.items() if k in field_names
        })

        def report(h, _stop=stopper, _m=metric):
            return not _stop.should_stop(h["epoch"], h[_m])

        # the trial's thread makes its card current, so the kernels launch
        # on that card's current stream
        on_card = device is not None and torch.device(device).type == "cuda"
        ctx = (torch.cuda.device(device) if on_card
               else contextlib.nullcontext())
        t_start = time.perf_counter()
        with ctx:
            res = train_gnn(
                cfg, train_data, val_data, normalizer, output_dir,
                trial_id=f"trial_{i:05d}", report_fn=report,
                verbose=verbose, device=device,
            )
        t_end = time.perf_counter()
        final = res.history[-1]
        # schedule record: (start, end) wall interval + device the trial ran
        # on — lets callers/tests assert OBSERVED concurrency structurally
        # (overlapping intervals, distinct devices) instead of relying on a
        # load-sensitive wall-clock speedup comparison
        return dict(config=cdict, best_val_mape=res.best_val_mape,
                    final=final, log_dir=res.log_dir,
                    schedule=dict(start=t_start, end=t_end,
                                  device=str(device)))

    if max_concurrent <= 1:
        results = [run_trial(i, c, device) for i, c in enumerate(trials)]
    else:
        # round-robin device pool: concurrent trials land on distinct
        # cards while there are more cards than trials at once, else share
        devs = _device_pool(device)
        slots: queue.Queue = queue.Queue()
        for k in range(max_concurrent):
            slots.put(devs[k % len(devs)])

        def worker(i, cdict):
            dev = slots.get()
            try:
                return run_trial(i, cdict, dev)
            finally:
                slots.put(dev)

        with ThreadPoolExecutor(max_workers=max_concurrent) as ex:
            results = list(ex.map(worker, range(len(trials)), trials))

    key = (
        (lambda r: r["best_val_mape"])
        if prediction_type == "buckling"
        else (lambda r: r["final"]["val_loss"])
    )
    best = min(results, key=key)
    return best["config"], results
