"""Shared helpers of the benchmark's CPU tests: the cells at a size a CPU
test run holds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(workload: str, *, hidden: int = 128, layers: int = 3,
               panels: int = 4, sides=(5, 8)):
    """The cell ``workload`` with a small model and few small panels."""
    from portbench import run

    c = run.resolve(ROOT, workload)
    c.cfg.update(hidden_channels=hidden, num_layers=layers,
                 batch_size=panels)
    c.traffic.update(min_side=sides[0], max_side=sides[1])
    return c


@pytest.fixture
def small():
    return small_cell


def cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()
