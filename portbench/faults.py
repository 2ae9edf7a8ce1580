"""Faults planted in the timed path, to show that the comparison that
decides ``correct`` catches them. The benchmark's runs never plant one:
the tests (portbench/tests/) and the calibration (portbench/calibrate.py)
do, through ``run_cell(..., fault=name)``.

Train: ``unchanged`` (a step that leaves the model and Adam's state as
they were), ``half_batch`` (half of the panels left out of the loss, its
mean taken over the rest), ``altered`` (one leaf's gradient altered where
the backward produces it). Serve: ``half_batch`` (half of each answer's
panels left out), ``altered`` (one panel's prediction altered). One card,
so no exchange between chips can be left out.
"""

from __future__ import annotations

import torch

TRAIN = ("unchanged", "half_batch", "altered")
SERVE = ("half_batch", "altered")


def plant_train(name: str, step, model, opt):
    if name == "unchanged":
        def frozen_step(batch, lr, gen):
            saved = opt.step
            opt.step = lambda *a, **k: None
            try:
                return step(batch, lr, gen)
            finally:
                opt.step = saved
        return frozen_step
    if name == "half_batch":
        def half_step(batch, lr, gen):
            mask = batch.graph_mask.clone()
            real = torch.nonzero(mask).reshape(-1)
            mask[real[len(real) // 2:]] = False
            return step(batch.replace(graph_mask=mask), lr, gen)
        return half_step
    if name == "altered":
        leaf = dict(model.named_parameters())["decoder.lin_0.weight"]
        leaf.register_hook(lambda g: g * 1.5)
        return step
    raise ValueError(f"no train fault {name!r}: one of {TRAIN}")


def plant_serve(name: str, step):
    if name == "half_batch":
        def half_step(batch):
            m, (pred, aux) = step(batch)
            real = int(batch.graph_mask.sum())
            pred = pred.clone()
            pred[real // 2:real] = 0.0
            return m, (pred, aux)
        return half_step
    if name == "altered":
        def altered_step(batch):
            m, (pred, aux) = step(batch)
            pred = pred.clone()
            pred[0] += 1.0
            return m, (pred, aux)
        return altered_step
    raise ValueError(f"no serve fault {name!r}: one of {SERVE}")
