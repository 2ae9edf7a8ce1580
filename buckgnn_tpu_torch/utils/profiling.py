"""Profiling: the port's spans, the torch.profiler trace and step timing.

The port of buckgnn_tpu/utils/profiling.py:

- ``span(name)`` / ``traced(name)``: the port's own spans, at the
  boundaries of its layers (below). Off by default: each site then
  checks one module-level flag and enters a shared no-op context (no
  allocation, no string formatting, no ``record_function``). Inside
  `spans_enabled` (and so inside `trace`) they are on: a span enters
  ``torch.profiler.record_function("buckgnn.<name>")``, so it lands in
  the trace on the profiler's clock, beside the kernels it launched, and
  nested per thread as the profiler nests its events (the CUDA backward's
  spans on autograd's device thread). No span reads or synchronizes the
  device. The flag is the process's: while one thread traces (one
  `train/tune.py` trial's ``profile_epochs``), every thread's spans are
  on and cost their ``record_function``. The port's launch counts stay
  in the ``LAUNCHES`` dicts that ``utils/cuda_build.py::count_launch``
  fills.
- ``trace(log_dir)``: context manager around ``torch.profiler`` writing a
  trace of everything inside to ``log_dir`` (a ``*.pt.trace.json`` that
  TensorBoard's profiler plugin and Perfetto load), with the card's
  kernels when a CUDA device is present, and the spans on,
- ``StepTimer``: low-overhead wall-clock accumulator that converts step
  counts + edge counts into ms per step and edges/s — the trainer's
  per-epoch Perf/* scalars.

The spans, outermost first (``buckgnn.`` before each in a trace):

- ``data.pack``: each graph/batch.py::pack_graphs call (the copy to the
  device included), and in batch_iterator the RCM relabelling and the
  run-uniform padding, each closed before a batch is yielded (in
  ``train_gnn``'s profiled epochs with ``repack_every_epoch``);
- ``train.step``, holding ``train.forward``, ``train.loss``,
  ``train.backward``, ``train.optimizer`` and ``train.metrics``:
  train/trainer.py::make_train_step; ``eval.step``, holding
  ``eval.forward`` and ``eval.loss`` (loss and metrics): make_eval_step;
- ``model.encoder``, ``model.stack`` (every model_name's stack),
  ``model.pool``, ``model.decoder``: models/buckgnn.py::BuckGNN.forward;
- ``sage.fwd`` (the whole ops/sage_layer.py::fused_sage_layer call) and
  ``sage.bwd`` (_FusedLayer.backward); ``ea.fwd``
  (ops/ea_block.py::fused_ea_block) and ``ea.bwd``
  (_FusedBlock.backward).
"""

from __future__ import annotations

import contextlib
import functools
import time

from torch.profiler import record_function

__all__ = ["span", "traced", "spans_enabled", "trace", "StepTimer"]

PREFIX = "buckgnn."

_on = False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """Context manager: the span ``name`` when spans are on, else a shared
    no-op."""
    if not _on:
        return _NO_SPAN
    return record_function(PREFIX + name)


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    full = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with record_function(full):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def spans_enabled():
    """The port's spans on inside the context, for a profiler run by the
    caller; as they were after it."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the CPU ops and the port's spans, and of the
    CUDA kernels when a card is present, written to ``log_dir`` when the
    context exits."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with spans_enabled(), \
            profile(activities=activities,
                    on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock over groups of steps. ``start()``/``stop(n_steps,
    n_edges)`` around each timed region; read ``step_ms`` /
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
    def edges_per_s(self) -> float:
        return self.n_edges / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def step_ms(self) -> float:
        return (self.elapsed_s / self.n_steps * 1e3) if self.n_steps else 0.0
