"""The port's spans (buckgnn_tpu_torch/utils/profiling.py) on the CPU.

A tiny weight-tied SAGE model on supernode panels and a tiny EA model on
virtual-edge panels (H 128, the fused layer's and block's least width; 2
layers, 3 panels), each through one train step and one eval step: off,
the spans never enter ``record_function`` and leave no ``buckgnn.*``
event in a profiler trace; on, they land in a ``torch.profiler`` trace as
the tree of the port's layers, and change no bit of what the steps
compute. ``spans_enabled`` and ``trace`` turn them on for their duration
only.
"""

import contextlib
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.train.losses import get_loss_function
from buckgnn_tpu_torch.train.trainer import (
    build_model, make_optimizer, make_train_step,
)
from buckgnn_tpu_torch.utils import profiling

MODELS = {"sage": ("GraphSage_addAggr_Shared", True, "sage"),
          "ea": ("EA_GNN_Shared", False, "ea")}
# a train step's and an eval step's spans, (name, parent), in the order
# they open; L = 2 layers
TRAIN_TREE = [("train.step", None), ("train.forward", "train.step"),
              ("model.encoder", "train.forward"),
              ("model.stack", "train.forward"),
              ("{k}.fwd", "model.stack"), ("{k}.fwd", "model.stack"),
              ("model.pool", "train.forward"),
              ("model.decoder", "train.forward"),
              ("train.loss", "train.step"), ("train.backward", "train.step"),
              ("{k}.bwd", "train.backward"), ("{k}.bwd", "train.backward"),
              ("train.optimizer", "train.step"),
              ("train.metrics", "train.step")]
EVAL_TREE = [("eval.step", None), ("eval.forward", "eval.step"),
             ("model.encoder", "eval.forward"),
             ("model.stack", "eval.forward"),
             ("{k}.fwd", "model.stack"), ("{k}.fwd", "model.stack"),
             ("model.pool", "eval.forward"),
             ("model.decoder", "eval.forward"), ("eval.loss", "eval.step")]


@pytest.fixture
def spans_on():
    with profiling.spans_enabled():
        yield


@pytest.fixture(scope="module", params=sorted(MODELS))
def tiny(request):
    """(kind, the packed batch, a function giving fresh steps) of one tiny
    model: the same weights each call (``TrainConfig.seed``)."""
    model_name, super_node, kind = MODELS[request.param]
    ds = generate_dataset(3, seed=1, min_side=4, max_side=5,
                          use_super_node=super_node,
                          use_virtual_edges=not super_node)
    normed, nz = normalize_dataset(ds)
    geo = dict(tile=128, widths=(64, 128)) if kind == "ea" else {}
    tile, width = tb.select_band_geometry(normed, **geo)
    align = 4 * tile
    n = sum(g.n_node for g in normed) + 1
    ncap = ((max(n, tile + width) + align - 1) // align) * align
    ecap = ((sum(g.n_edge for g in normed) + 255) // 128) * 128
    batch = next(iter(tb.batch_iterator(normed, 3, ncap, ecap,
                                        band_width=width, band_tile=tile,
                                        rcm=True, device="cpu")))
    cfg = TrainConfig(hidden_channels=128, num_layers=2,
                      model_name=model_name, segment_impl="banded_pallas",
                      dropout_rate=0.1, batch_size=3)

    def steps():
        model = build_model(cfg, normed[0].x.shape[1],
                            normed[0].edge_attr.shape[1], device="cpu")
        opt = make_optimizer(cfg, model)
        train_step, eval_step = make_train_step(
            model, opt, get_loss_function(cfg.loss_function), cfg, nz)
        return model, train_step, eval_step

    return kind, batch, steps


def _run(batch, steps):
    model, train_step, eval_step = steps()
    metrics = train_step(batch, 1e-3, torch.Generator().manual_seed(7))
    _, (pred, _) = eval_step(batch)
    return model, metrics, pred


def _tree(prof, thread=None):
    """The trace's ``buckgnn.*`` events as (name, nearest ``buckgnn.*``
    parent), in the order they open."""
    out = []
    events = sorted((e for e in prof.events()
                     if e.name.startswith(profiling.PREFIX)
                     and (thread is None or e.thread == thread)),
                    key=lambda e: e.time_range.start)
    for e in events:
        up = e.cpu_parent
        while up is not None and not up.name.startswith(profiling.PREFIX):
            up = up.cpu_parent
        out.append((e.name[len(profiling.PREFIX):],
                    up.name[len(profiling.PREFIX):] if up else None))
    return out


def test_spans_off_enter_nothing(tiny, monkeypatch):
    _, batch, steps = tiny

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(batch, steps)
    assert _tree(prof) == []
    assert profiling.span("x") is profiling.span("y")
    with profiling.span("x") as s:
        assert s is None


def test_spans_on_give_the_layer_tree(tiny, spans_on):
    kind, batch, steps = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(batch, steps)
    assert _tree(prof) == [(n.format(k=kind), p)
                           for n, p in TRAIN_TREE + EVAL_TREE]
    # each span closes inside its parent
    events = [e for e in prof.events()
              if e.name.startswith(profiling.PREFIX)]
    for e in events:
        up = e.cpu_parent
        if up is not None:
            assert up.time_range.start <= e.time_range.start
            assert e.time_range.end <= up.time_range.end


def test_spans_change_no_bit(tiny):
    _, batch, steps = tiny
    off = _run(batch, steps)
    with profiling.spans_enabled(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _run(batch, steps)
    assert _tree(prof)
    (m_off, met_off, pred_off), (m_on, met_on, pred_on) = off, on
    assert torch.equal(met_off["loss"], met_on["loss"])
    assert torch.equal(pred_off, pred_on)
    for (name, p), q in zip(m_off.named_parameters(), m_on.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name


def test_another_threads_spans_leave_the_tree_whole(spans_on):
    """Spans opened and closed on a second thread while the traced thread
    is inside its own leave the traced thread's nesting as it was."""
    both = threading.Barrier(2, timeout=30)
    errors = []

    def work():
        try:
            with profiling.span("b.outer"):
                both.wait()
                with profiling.span("b.inner"):
                    both.wait()
                both.wait()
        except Exception as exc:  # reported on the main thread
            errors.append(exc)
            both.abort()

    other = threading.Thread(target=work)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        other.start()
        with profiling.span("a.outer"):
            both.wait()
            with profiling.span("a.inner"):
                both.wait()
            both.wait()
        other.join(timeout=30)
    assert not other.is_alive() and not errors
    mine = [e for e in prof.events()
            if e.name.startswith(profiling.PREFIX + "a.")]
    assert mine
    assert _tree(prof, mine[0].thread) == [("a.outer", None),
                                           ("a.inner", "a.outer")]


@pytest.mark.parametrize("nested", [False, True])
def test_trace_turns_the_spans_on_for_its_duration(tmp_path, nested):
    outer = profiling.spans_enabled() if nested else contextlib.nullcontext()
    with outer:
        with profiling.trace(str(tmp_path)):
            assert profiling._on

            @profiling.traced("eval.step")
            def step(x):
                with profiling.span("eval.forward"):
                    return x + 1

            assert step(torch.ones(2)).tolist() == [2.0, 2.0]
            assert step.__name__ == "step"
        assert profiling._on is nested
    assert profiling._on is False
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(os.path.join(tmp_path, name)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert "buckgnn.eval.step" in names and "buckgnn.eval.forward" in names
