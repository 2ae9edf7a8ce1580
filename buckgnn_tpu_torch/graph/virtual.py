"""Virtual edges and super node — global message-passing shortcuts.

Re-implements Dataset_Preparation/VirtualEdgeCreate.py with one deliberate
upgrade: the random generator is seeded deterministically (e.g. by a graph
hash) so multi-host data pipelines produce identical graphs — the reference
uses the global numpy RNG (VirtualEdgeCreate.py:39), which is irreproducible
across processes.

Also provides the richer *hybrid* strategy that exists in the reference only
as a demo (Utils/Virtual_Edge_Creation_Demo.py:83-235): radial spokes from
the centroid region plus distance-constrained random edges.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "create_random_virtual_edges",
    "virtual_edge_features",
    "create_super_node_edges",
    "SUPER_NODE_FLAG_DIM",
]

# One extra trailing node-feature dimension flags the super node
# (VirtualEdgeCreate.py:93-103).
SUPER_NODE_FLAG_DIM = 1


def create_random_virtual_edges(
    n_nodes: int,
    existing_edges: set[tuple[int, int]],
    percentage: float = 0.1333,
    seed: int = 0,
) -> list[tuple[int, int]]:
    """Uniform random non-duplicate node pairs, 13.33% of real edge count
    (VirtualEdgeCreate.py:21-49). ``existing_edges`` holds sorted undirected
    pairs."""
    rng = np.random.default_rng(seed)
    total_allowed = int(len(existing_edges) * percentage)
    virtual: list[tuple[int, int]] = []
    chosen: set[tuple[int, int]] = set()
    while len(virtual) < total_allowed:
        a, b = rng.choice(n_nodes, size=2, replace=False)
        edge = (int(min(a, b)), int(max(a, b)))
        if edge not in existing_edges and edge not in chosen:
            chosen.add(edge)
            virtual.append(edge)
    return virtual


def virtual_edge_features(
    pos1: np.ndarray, pos2: np.ndarray, use_axial_stress: bool = False
) -> list[float]:
    """[stiffener=0, length/1000, dir_x, dir_y, (axial=0,) virtual=1]
    (VirtualEdgeCreate.py:62-77). Real edges get virtual_flag 0 appended
    by the graph builder (:55-59)."""
    dx = float(pos2[0] - pos1[0])
    dy = float(pos2[1] - pos1[1])
    distance = float(np.sqrt(dx * dx + dy * dy))
    dirx, diry = dx / distance, dy / distance
    if use_axial_stress:
        return [0.0, distance / 1000.0, dirx, diry, 0.0, 1.0]
    return [0.0, distance / 1000.0, dirx, diry, 1.0]


def create_super_node_edges(n_nodes: int) -> list[tuple[int, int]]:
    """Edges (super_idx, i) for all real nodes; super node index == n_nodes
    (VirtualEdgeCreate.py:105-113)."""
    super_idx = n_nodes
    return [(super_idx, i) for i in range(n_nodes)]


def create_hybrid_virtual_edges(
    coords: np.ndarray,
    existing_edges: set[tuple[int, int]],
    percentage: float = 0.1333,
    radial_fraction: float = 0.5,
    max_dist_fraction: float = 0.75,
    seed: int = 0,
) -> list[tuple[int, int]]:
    """Hybrid strategy (demo parity, Virtual_Edge_Creation_Demo.py:83-235):

    - *radial*: connect the node nearest the centroid to evenly-spread far
      nodes (spokes that cut graph diameter),
    - *random distance-constrained*: random pairs whose Euclidean distance is
      below ``max_dist_fraction`` of the bounding-box diagonal.
    """
    rng = np.random.default_rng(seed)
    n = len(coords)
    budget = int(len(existing_edges) * percentage)
    if budget <= 0 or n < 3:
        return []
    chosen: set[tuple[int, int]] = set()
    out: list[tuple[int, int]] = []

    centroid = coords.mean(axis=0)
    center_node = int(np.argmin(np.linalg.norm(coords - centroid, axis=1)))
    d_from_center = np.linalg.norm(coords - coords[center_node], axis=1)
    n_radial = int(budget * radial_fraction)
    far_order = np.argsort(-d_from_center)
    step = max(1, len(far_order) // max(n_radial, 1))
    for i in far_order[::step][:n_radial]:
        e = (min(center_node, int(i)), max(center_node, int(i)))
        if e[0] != e[1] and e not in existing_edges and e not in chosen:
            chosen.add(e)
            out.append(e)

    diag = float(np.linalg.norm(coords.max(axis=0) - coords.min(axis=0)))
    max_d = max_dist_fraction * diag
    attempts = 0
    while len(out) < budget and attempts < 100 * budget:
        attempts += 1
        a, b = rng.choice(n, size=2, replace=False)
        e = (int(min(a, b)), int(max(a, b)))
        if e in existing_edges or e in chosen:
            continue
        if np.linalg.norm(coords[e[0]] - coords[e[1]]) > max_d:
            continue
        chosen.add(e)
        out.append(e)
    return out
