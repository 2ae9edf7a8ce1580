"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``buckgnn_tpu_torch/csrc/`` has a plain C interface and
is compiled at first use for ``sm_90a`` into ``buckgnn_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the source. Nothing here runs at
import time; a machine without nvcc only fails when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {
    "sage_layer_fwd": os.path.join(_PKG, "csrc", "sage_layer_fwd.cu"),
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all(names=None) -> dict[str, float]:
    """Compile every named kernel not yet built, one nvcc per source, all
    started together. Returns seconds per built kernel; raises with the
    compiler's output when a build fails. The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names or SOURCES:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.tmp{os.getpid()}"
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds = {}
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(lib_path(name))
    return _LIBS[name]
