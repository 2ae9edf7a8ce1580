"""Serving latency: the INFERENCE_TIMER protocol on the card.

The port of buckgnn_tpu/eval/timer.py::time_gnn_forward
(INFERENCE_TIMER.py:151-270): one sample replicated to a full batch,
warm-up, then a timed forward loop reporting samples/s and per-sample
latency. The host clock spans work that ends in a device synchronize.
The solver comparison (time_nastran) comes with the eval slice.
"""

from __future__ import annotations

import copy
import time

import torch

from buckgnn_tpu_torch.graph.batch import (
    GraphData, batch_iterator, suggest_capacities,
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
