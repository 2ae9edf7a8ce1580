"""The comparison that decides ``correct``, driven on the CPU through the
rest of a run (set-up, window, the port's state freed, the reference):
the port's CPU path agrees with the plain reference for both models, with
dropout and Adam steps; the control (the reference in TF32 in the port's
place) and every fault planted in the timed path come out not correct."""

import json
import os

import pytest

from conftest import ROOT
from portbench import calibrate, faults, run

TRAIN = ("sage-f32.train", "ea-f32.train", "sage-f32.train-virtual")
CELLS = TRAIN + ("sage-f32.serve",)


def limits(workload):
    with open(os.path.join(ROOT, "portbench", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_reference(small, workload):
    """At a small size on the CPU (the port's plain kernels), dropout 0.1
    and three Adam steps: every reading is within float32 rounding."""
    out = run.run_cell(small(workload), 2**31 + 11, 0.3, False,
                       device="cpu")
    assert out["correct"], out["checks"]
    for chk in out["checks"].values():
        assert chk["value"] < 1e-5
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in (faults.TRAIN if w in TRAIN else faults.SERVE)])
def test_fault_is_not_correct(small, workload, fault):
    out = run.run_cell(small(workload), 2**31 + 12, 0.2, False,
                       device="cpu", fault=fault)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small, workload):
    """The control at the configuration's widths (hidden 512, 6 layers) on
    four panels: the reference in TF32 in the port's place reads beyond a
    limit, the port does not."""
    c = small(workload, hidden=512, layers=6, panels=4, sides=(24, 32))
    got = calibrate.readings_of(c, 2**31 + 13, 0.2, control=True)
    lim = limits(workload)
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got
