"""What a run loads and where it runs: no JAX and no JAX package, a
reference that takes nothing of the port, no fall back to the CPU."""

import os
import subprocess
import sys

import pytest

from conftest import ROOT, cuda_available

FORBIDDEN = ("jax", "jaxlib", "flax", "buckgnn_tpu")


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, every module of the benchmark
    imported: the top-level names, compared whole, hold neither JAX nor
    the JAX package (buckgnn_tpu_torch is not buckgnn_tpu)."""
    code = (
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import small_cell\n"
        "from portbench import run, calibrate, faults, program\n"
        "from portbench.modes import train, serve\n"
        "out = run.run_cell(small_cell('sage-f32.train'), 7, 0.2, True,"
        " device='cpu')\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n")
    top = _modules_after(code)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "buckgnn_tpu_torch" in top


def test_the_reference_takes_nothing_of_the_port():
    code = ("from portbench.reference import common, graphs, layout, sage, ea\n"
            "from portbench.traffic import generator\n"
            "from portbench.metrics import counts, peaks, roofline\n")
    top = _modules_after(code)
    assert not top & {"buckgnn_tpu_torch", *FORBIDDEN}


def test_forbidden_is_matched_by_whole_name():
    from portbench import run

    sys.modules.setdefault("buckgnn_tpu_torch", sys.modules[__name__])
    assert "buckgnn_tpu_torch" not in run.forbidden_modules()


def test_no_card_no_result():
    """Without a card the command fails and prints no result line."""
    if cuda_available():
        pytest.skip("a CUDA card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sage-f32.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_one_cell_on_the_card():
    """A short run of the serve cell on the card, where there is one."""
    if not cuda_available():
        pytest.skip("needs a CUDA card")
    import json

    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sage-f32.serve", "--seed", "3", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
