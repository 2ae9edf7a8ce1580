"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``buckgnn_tpu_torch/csrc/`` has a plain C interface and
is compiled at first use for ``sm_90a`` into ``buckgnn_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the source and the shared
headers (``csrc/*.cuh``). Nothing here runs at
import time; a machine without nvcc only fails when a kernel is asked for.
Building and loading hold one lock, so threads that ask for the same
kernel at once (concurrent tuning trials) start one nvcc, and a temporary
output is named by process and thread. `count_launch` adds to a wrapper's
launch count under a lock of its own, for the same threads.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {
    "sage_layer_fwd": os.path.join(_PKG, "csrc", "sage_layer_fwd.cu"),
    "sage_layer_bwd": os.path.join(_PKG, "csrc", "sage_layer_bwd.cu"),
    "banded_matmul": os.path.join(_PKG, "csrc", "banded_matmul.cu"),
    "ea_block_fwd": os.path.join(_PKG, "csrc", "ea_block_fwd.cu"),
    "ea_block_bwd": os.path.join(_PKG, "csrc", "ea_block_bwd.cu"),
    "csr_segment": os.path.join(_PKG, "csrc", "csr_segment.cu"),
    "epilogue": os.path.join(_PKG, "csrc", "epilogue.cu"),
    "sage_simple": os.path.join(_PKG, "csrc", "sage_simple.cu"),
    "ea_simple": os.path.join(_PKG, "csrc", "ea_simple.cu"),
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    for path in [SOURCES[name], *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all(names=None) -> dict[str, float]:
    """Compile every named kernel not yet built, one nvcc per source, all
    started together. Returns seconds per built kernel; raises with the
    compiler's output when a build fails. The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``.log``."""
    with _BUILD_LOCK:
        return _build_all(names)


def _build_all(names) -> dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names or SOURCES:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.tmp{os.getpid()}_{threading.get_ident()}"
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
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if name not in _LIBS:
            _build_all([name])
            _LIBS[name] = ctypes.CDLL(lib_path(name))
        return _LIBS[name]


def count_launch(counts: dict, name: str) -> None:
    """One more launch of kernel ``name`` in a wrapper's ``counts``."""
    with _COUNT_LOCK:
        counts[name] += 1
