"""Profiling + step timing.

The port of buckgnn_tpu/utils/profiling.py:

- ``trace(log_dir)``: context manager around ``torch.profiler`` writing a
  trace of everything inside to ``log_dir`` (a ``*.pt.trace.json`` that
  TensorBoard's profiler plugin and Perfetto load), with the card's
  kernels when a CUDA device is present,
- ``StepTimer``: low-overhead wall-clock accumulator that converts step
  counts + edge counts into steps/s and edges/s — the trainer's per-epoch
  Perf/* scalars.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the CPU ops, and of the CUDA kernels when a
    card is present, written to ``log_dir`` when the context exits."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock over groups of steps. ``start()``/``stop(n_steps,
    n_edges)`` around each timed region; read ``steps_per_s`` /
    ``edges_per_s``. ``stop`` must follow a device synchronize for honest
    numbers: CUDA work is queued, and the host clock runs ahead of it (the
    trainer's once-per-epoch host fetch of the metrics is that
    synchronize)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.elapsed_s = 0.0
        self.n_steps = 0
        self.n_edges = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, n_edges: int = 0) -> None:
        if self._t0 is None:
            return
        self.elapsed_s += time.perf_counter() - self._t0
        self._t0 = None
        self.n_steps += n_steps
        self.n_edges += n_edges

    @property
    def steps_per_s(self) -> float:
        return self.n_steps / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.n_edges / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def step_ms(self) -> float:
        return (self.elapsed_s / self.n_steps * 1e3) if self.n_steps else 0.0
