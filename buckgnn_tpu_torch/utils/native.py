"""Host graph-ordering helpers, NumPy only.

Copies of the NumPy fallbacks of buckgnn_tpu/utils/native.py
(``_rcm_order_numpy`` and the fallback branch of ``band_fraction``). The
C++ library (cpp/native.cpp, loaded with ctypes) comes with the
host-pipeline slice of the port.
"""

from __future__ import annotations

import numpy as np


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def rcm_order(n_nodes: int, senders, receivers) -> np.ndarray:
    """Reverse Cuthill-McKee permutation; perm[new_index] = old_index.
    BFS by ascending degree, reversed (cpp/native.cpp::bg_rcm_order)."""
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


def band_fraction(senders, receivers, pos, n_nodes: int,
                  tile: int, width: int) -> float:
    """Fraction of edges landing in the banded slab under ordering `pos`
    (pos[old_index] = new position)."""
    s, r, p = _i64(senders), _i64(receivers), _i64(pos)
    if len(s) == 0:
        return 1.0
    slab = tile + width
    t = p[r] // tile
    start = np.clip(t * tile - width // 2, 0, max(n_nodes - slab, 0))
    k = p[s] - start
    return float(np.mean((k >= 0) & (k < slab)))
