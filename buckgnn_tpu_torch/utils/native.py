"""ctypes bindings for the C++ host-ETL kernels (csrc/native.cpp).

The port of buckgnn_tpu/utils/native.py. The library is host C++: it is
compiled at first use with g++ (not nvcc) into ``buckgnn_tpu_torch/_build/``
beside the CUDA kernels, keyed by a hash of the source, and loaded with
ctypes. Building and loading hold utils/cuda_build.py's build lock, and the
compiler writes a temporary file named by process and thread that
``os.replace`` moves into place, so concurrent threads start one g++ and
concurrent processes never load a half-written library. Every entry point
has a pure-NumPy fallback, taken when there is no toolchain or when
``BUCKGNN_DISABLE_NATIVE`` is set; `build` alone raises instead.

Public API:
    shell_edges_native(quads, trias) -> (pairs [U,2], counts [U]) | None
    rcm_order(n_nodes, senders, receivers) -> perm  (perm[new] = old)
    band_fraction(senders, receivers, pos, n_nodes, tile, width) -> float
    available() -> bool
    build() -> path of the built library (raises if g++ fails)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from buckgnn_tpu_torch.utils import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "native.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    return gxx


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(cuda_build.BUILD_DIR, f"libnative_{tag}.so")


def _build() -> str:
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}_{threading.get_ident()}"
    res = subprocess.run([_gxx(), *GXX_FLAGS, SOURCE, "-o", tmp],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for native.cpp:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def build() -> str:
    """Compile the library if it is not built yet; its path. Raises with
    the compiler's output when g++ is missing or fails."""
    with cuda_build._BUILD_LOCK:
        return _build()


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bg_shell_edges.restype = ctypes.c_int64
    lib.bg_shell_edges.argtypes = [i64p, ctypes.c_int64, i64p,
                                   ctypes.c_int64, i64p, i64p]
    lib.bg_rcm_order.restype = None
    lib.bg_rcm_order.argtypes = [ctypes.c_int64, i64p, i64p,
                                 ctypes.c_int64, i64p]
    lib.bg_band_count.restype = ctypes.c_int64
    lib.bg_band_count.argtypes = [i64p, i64p, ctypes.c_int64, i64p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64]
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with cuda_build._BUILD_LOCK:
        if not _TRIED:
            if not os.environ.get("BUCKGNN_DISABLE_NATIVE"):
                try:
                    _LIB = _bind(_build())
                except (OSError, RuntimeError, subprocess.SubprocessError):
                    _LIB = None
            _TRIED = True
        return _LIB


def available() -> bool:
    return _load() is not None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _same_length(s: np.ndarray, r: np.ndarray) -> None:
    if len(s) != len(r):
        raise ValueError(f"{len(s)} senders but {len(r)} receivers")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def shell_edges_native(quads, trias):
    """Unique sorted element-perimeter edge pairs + occurrence counts, or
    None when the native library is unavailable (caller falls back to the
    NumPy path in graph/build.py::shell_edges)."""
    lib = _load()
    if lib is None:
        return None
    q, t = _i64(quads).reshape(-1, 4) if len(quads) else _i64([]).reshape(0, 4), \
        _i64(trias).reshape(-1, 3) if len(trias) else _i64([]).reshape(0, 3)
    max_e = 4 * len(q) + 3 * len(t)
    pairs = np.empty((max(max_e, 1), 2), dtype=np.int64)
    counts = np.empty(max(max_e, 1), dtype=np.int64)
    n = lib.bg_shell_edges(_ptr(q), len(q), _ptr(t), len(t),
                           _ptr(pairs), _ptr(counts))
    return pairs[:n].copy(), counts[:n].copy()


def _rcm_order_numpy(n_nodes: int, senders, receivers) -> np.ndarray:
    """BFS-by-ascending-degree Cuthill-McKee, reversed. Pure-NumPy fallback
    mirroring csrc/native.cpp::bg_rcm_order."""
    s, r = _i64(senders), _i64(receivers)
    ok = (s >= 0) & (r >= 0) & (s < n_nodes) & (r < n_nodes) & (s != r)
    s, r = s[ok], r[ok]
    ss = np.concatenate([s, r])
    rr = np.concatenate([r, s])
    order_idx = np.lexsort((rr, ss))
    ss, rr = ss[order_idx], rr[order_idx]
    keep = np.ones(len(ss), dtype=bool)
    if len(ss):
        keep[1:] = (ss[1:] != ss[:-1]) | (rr[1:] != rr[:-1])
    ss, rr = ss[keep], rr[keep]
    deg = np.bincount(ss, minlength=n_nodes)
    offs = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    visited = np.zeros(n_nodes, dtype=bool)
    order: list[int] = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            order.append(v)
            nb = rr[offs[v]:offs[v + 1]]
            nb = nb[~visited[nb]]
            visited[nb] = True
            nb = nb[np.argsort(deg[nb], kind="stable")]
            queue.extend(int(w) for w in nb)
    return np.asarray(order[::-1], dtype=np.int64)


def rcm_order(n_nodes: int, senders, receivers) -> np.ndarray:
    """Reverse Cuthill-McKee permutation; perm[new_index] = old_index."""
    lib = _load()
    if lib is None:
        return _rcm_order_numpy(n_nodes, senders, receivers)
    s, r = _i64(senders), _i64(receivers)
    _same_length(s, r)
    perm = np.empty(n_nodes, dtype=np.int64)
    lib.bg_rcm_order(n_nodes, _ptr(s), _ptr(r), len(s), _ptr(perm))
    return perm


def _band_fraction_numpy(s, r, p, n_nodes: int, tile: int,
                         width: int) -> float:
    """The NumPy fallback of `band_fraction` (ids in range, edges given)."""
    slab = tile + width
    t = p[r] // tile
    start = np.clip(t * tile - width // 2, 0, max(n_nodes - slab, 0))
    k = p[s] - start
    return float(np.mean((k >= 0) & (k < slab)))


def band_fraction(senders, receivers, pos, n_nodes: int,
                  tile: int, width: int) -> float:
    """Fraction of edges landing in the banded slab under ordering `pos`
    (pos[old_index] = new position)."""
    s, r, p = _i64(senders), _i64(receivers), _i64(pos)
    if len(s) == 0:
        return 1.0
    _same_length(s, r)
    if len(p) < n_nodes:
        raise ValueError(f"pos holds {len(p)} positions for {n_nodes} nodes")
    lib = _load()
    if lib is not None:
        n = lib.bg_band_count(_ptr(s), _ptr(r), len(s), _ptr(p),
                              n_nodes, tile, width)
        return float(n) / float(len(s))
    return _band_fraction_numpy(s, r, p, n_nodes, tile, width)
