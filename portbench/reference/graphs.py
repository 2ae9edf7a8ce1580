"""Plain graph construction and normalization of the benchmark's panels.

The reference works the program's host stage out again from the raw
panels (portbench/traffic/generator.py): the node and edge features of
each panel's graph (Dataset_Preparation/GraphCreate.py:143-432 for a 2D
buckling panel without stiffeners, z, rotations, grid-point forces or mode
features), its supernode star or random virtual edges
(VirtualEdgeCreate.py:21-113), and the dataset normalization
(GraphCreate.py:675-789, Normalizer.py:43-202) of exactly those columns.

The canonical-frame transforms are frozen copies of the port's
``graph/transform.py`` (is_symmetric, the diagonal alignment, the PCA
with third-moment flips, the Mohr rotation), and the random virtual edges
a frozen copy of ``graph/virtual.py::create_random_virtual_edges``: the
same draws from the same seed. Nothing here imports the program.

A graph is a dict of NumPy arrays: ``x`` [n, F] float32, ``senders`` /
``receivers`` [e] int64 (both directions of each edge), ``edge_attr``
[e, 5] float32, ``eigenvalue`` (float) and, once normalized, ``y`` (the
normalized eigenvalue, float32).
"""

from __future__ import annotations

import numpy as np


class TransformInfo(dict):
    """rotation_angle, flip_x, flip_y (Transformation.py:188-192)."""


def is_symmetric(points: np.ndarray, tolerance: float = 1e-6) -> bool:
    """Covariance-eigenvalue ratio symmetry test (Transformation.py:88-95)."""
    centered = points - np.mean(points, axis=0)
    cov = np.cov(centered.T)
    eigenvalues = np.linalg.eigvalsh(cov)
    ratio = abs(eigenvalues[0] - eigenvalues[1]) / (eigenvalues[0] + eigenvalues[1])
    return bool(ratio < tolerance)


def transform_diagonal_alignment(points: np.ndarray):
    """Align the longest point-pair diagonal with the x-axis
    (Transformation.py:97-147). Returns (transformed, centroid, rotation,
    None) like the reference; the O(n^2) pair search is vectorized.

    Deliberate fix vs the reference: Transformation.py:134-140 builds the
    rotation from ``-angle`` but applies it with row-vector convention
    (``centered @ rotation``), which rotates by *+angle* and sends a diagonal
    at angle t to angle 2t — i.e. it never actually aligns anything. We use
    the correct sign so the selected diagonal really lands on the x-axis
    (what the surrounding code and prints intend).
    """
    centroid = np.mean(points, axis=0)
    centered = points - centroid
    # Pairwise squared distances. Ties broken like the reference's
    # ``sorted(..., reverse=True)`` over (dist, i, j) tuples: the
    # lexicographically largest (dist, i, j) wins (Transformation.py:112).
    d2 = np.sum(
        (centered[:, None, :] - centered[None, :, :]) ** 2, axis=-1
    )
    iu = np.triu_indices(len(points), k=1)
    flat = d2[iu]
    order = np.lexsort((iu[1], iu[0], flat))
    k = int(order[-1])
    p1_idx, p2_idx = iu[0][k], iu[1][k]

    p1 = centered[p1_idx]
    p2 = centered[p2_idx]
    diagonal = p2 - p1
    angle = np.arctan2(diagonal[1], diagonal[0])
    cos_t, sin_t = np.cos(angle), np.sin(angle)
    # Row-vector rotation by -angle: v @ R has components
    # (|v| cos(phi-angle), |v| sin(phi-angle)).
    rotation = np.array([[cos_t, -sin_t], [sin_t, cos_t]])
    return centered @ rotation, centroid, rotation, None


def transform_pca(points: np.ndarray):
    """PCA canonicalization with third-moment flips (Transformation.py:149-198).

    Returns (transformed_points, centroid, rotation, transform_info).
    """
    centroid = np.mean(points, axis=0)
    centered = points - centroid

    cov = np.cov(centered.T)
    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    idx = eigenvalues.argsort()[::-1]
    eigenvectors = eigenvectors[:, idx]

    transformed = centered @ eigenvectors
    moments3 = np.mean(transformed**3, axis=0)

    flip_x = False
    flip_y = False
    for i in range(2):
        if abs(moments3[i]) > 1e-10 and moments3[i] < 0:
            eigenvectors[:, i] *= -1
            if i == 0:
                flip_x = True
            else:
                flip_y = True

    angle = np.arctan2(eigenvectors[1, 0], eigenvectors[0, 0])
    rotation = eigenvectors
    transformed_points = centered @ rotation

    info = TransformInfo(rotation_angle=float(angle), flip_x=flip_x, flip_y=flip_y)
    return transformed_points, centroid, rotation, info


def transform_to_simulation_coordinates(points: np.ndarray):
    """Dispatch: diagonal alignment for symmetric shapes, else PCA
    (Transformation.py:78-86)."""
    if is_symmetric(points):
        return transform_diagonal_alignment(points)
    return transform_pca(points)


def mohr_transform(
    sigma: np.ndarray,
    transformation_matrix: np.ndarray,
    transform_info: TransformInfo | None,
    transform: bool = True,
) -> np.ndarray:
    """Rotate plane-stress tensors into the canonical frame.

    ``sigma``: [..., 3] arrays of (sx, sy, txy). Angle convention and the
    single-flip sign correction on tau_xy follow GraphCreate.py:259-289.
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    sx, sy, txy = sigma[..., 0], sigma[..., 1], sigma[..., 2]
    if transform:
        if transform_info is None:
            theta = -np.arctan2(
                transformation_matrix[1, 0], transformation_matrix[0, 0]
            )
        else:
            theta = -transform_info["rotation_angle"]
    else:
        theta = np.arctan2(transformation_matrix[1, 0], transformation_matrix[0, 0])

    c2, s2 = np.cos(2 * theta), np.sin(2 * theta)
    sx_new = (sx + sy) / 2 + (sx - sy) / 2 * c2 + txy * s2
    sy_new = (sx + sy) / 2 - (sx - sy) / 2 * c2 - txy * s2
    txy_new = -(sx - sy) / 2 * s2 + txy * c2

    if transform and transform_info is not None:
        if transform_info["flip_x"] != transform_info["flip_y"]:
            txy_new = -txy_new
    return np.stack([sx_new, sy_new, txy_new], axis=-1)


_BIN_CENTERS = np.array([0.0, 45.0, 90.0, 135.0])



def _edge_feature(p1, p2, flag: float, virtual: float) -> list[float]:
    """[stiffener flag, length / 1000, dir_x, dir_y, virtual flag] of the
    edge from p1 to p2."""
    d = p2 - p1
    dist = float(np.sqrt(d[0] * d[0] + d[1] * d[1]))
    return [flag, dist / 1000.0, float(d[0] / dist), float(d[1] / dist),
            virtual]


def random_virtual_edges(n_nodes: int, existing: set, percentage: float,
                         seed: int) -> list[tuple[int, int]]:
    """Uniform random non-duplicate node pairs, ``percentage`` of the mesh
    edge count (frozen copy of create_random_virtual_edges)."""
    rng = np.random.default_rng(seed)
    total_allowed = int(len(existing) * percentage)
    virtual: list[tuple[int, int]] = []
    chosen: set = set()
    while len(virtual) < total_allowed:
        a, b = rng.choice(n_nodes, size=2, replace=False)
        edge = (int(min(a, b)), int(max(a, b)))
        if edge not in existing and edge not in chosen:
            chosen.add(edge)
            virtual.append(edge)
    return virtual


def build(panel: dict, graph: str, virtual_percentage: float) -> dict:
    """One panel's graph, ``graph`` "supernode" (a node joined to every
    mesh node, a trailing flag column) or "virtual" (random virtual edges
    seeded by the panel's seed)."""
    coords2d = panel["coords"][:, :2]
    n = coords2d.shape[0]
    pts, _, tmat, tinfo = transform_to_simulation_coordinates(coords2d)

    quads = panel["quads"]
    pairs = np.concatenate([np.stack([np.minimum(quads[:, i],
                                                 quads[:, (i + 1) % 4]),
                                      np.maximum(quads[:, i],
                                                 quads[:, (i + 1) % 4])], 1)
                            for i in range(4)])
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    boundary = np.zeros(n)
    boundary[np.unique(uniq[counts == 1].reshape(-1))] = 1.0

    spc = np.zeros((n, 1))
    spc[panel["spc_nodes"], 0] = 1.0  # every clamped node is '123456'
    force = np.zeros((n, 2))
    force[panel["force_nodes"]] = panel["force"][:2] @ tmat
    x = np.concatenate([
        pts, spc, force, boundary[:, None], np.zeros((n, 4)),
        panel["disp"][:, :2] @ tmat,
        mohr_transform(panel["gp"][:, :3], tmat, tinfo, True)], axis=1)

    edges = {}
    for a, b in uniq:
        edges[(int(a), int(b))] = _edge_feature(pts[a], pts[b], 0.01, 0.0)
    if graph == "supernode":
        x = np.concatenate([x, np.zeros((n, 1))], axis=1)
        super_row = np.zeros((1, x.shape[1]))
        super_row[0, -1] = 1.0
        x = np.concatenate([x, super_row])
        pts = np.vstack([pts, np.zeros((1, 2))])
        for i in range(n):
            edges[(n, i)] = _edge_feature(pts[n], pts[i], 0.0, 1.0)
    elif graph == "virtual":
        for a, b in random_virtual_edges(n, set(edges), virtual_percentage,
                                         panel["seed"]):
            edges[(a, b)] = _edge_feature(pts[a], pts[b], 0.0, 1.0)
    else:
        raise ValueError(f"graph {graph!r}: supernode or virtual")
    ends = np.array(list(edges), dtype=np.int64).reshape(-1, 2)
    feats = np.array(list(edges.values()), dtype=np.float32)
    return dict(x=x.astype(np.float32),
                senders=np.concatenate([ends[:, 0], ends[:, 1]]),
                receivers=np.concatenate([ends[:, 1], ends[:, 0]]),
                edge_attr=np.concatenate([feats, feats]),
                eigenvalue=float(panel["eigenvalue"]))


def _robust(v: np.ndarray):
    """(center, scale) of a robust scaler: median and the 25-75 range, a
    zero range taken as 1."""
    center = np.nanmedian(v, axis=0)
    q = np.nanpercentile(v, [25.0, 75.0], axis=0)
    scale = np.atleast_1d(q[1] - q[0]).astype(np.float64)
    scale[scale == 0.0] = 1.0
    return center, scale


def normalize(graphs: list[dict]) -> tuple[list[dict], dict]:
    """Graphs with normalized node features and targets, and the
    eigenvalue's (scale, center) as float32: coordinates and forces
    divided by half their range over every row, displacements, stresses
    and eigenvalues by robust scalers, a supernode row zero but for its
    flag."""
    xs = [g["x"].astype(np.float64) for g in graphs]
    allx = np.concatenate(xs)
    all32 = np.concatenate([g["x"] for g in graphs])
    ev_c, ev_s = _robust(np.array([g["eigenvalue"] for g in graphs])[:, None])

    def half_range(c):  # in float32, as the features are stored
        return np.maximum(all32[:, c].max(0) - all32[:, c].min(0), 1e-8) / 2

    coord_d, force_d = half_range(slice(0, 2)), half_range(slice(3, 5))
    disp_c, disp_s = _robust(allx[:, 10:12])
    gp_c, gp_s = _robust(allx[:, 12:15])
    out = []
    for g, x in zip(graphs, xs):
        nx = x.copy()
        nx[:, 0:2] = x[:, 0:2] / coord_d
        nx[:, 3:5] = x[:, 3:5] / force_d
        nx[:, 10:12] = (x[:, 10:12] - disp_c) / disp_s
        nx[:, 12:15] = (x[:, 12:15] - gp_c) / gp_s
        is_super = x[:, -1] == 1
        if x.shape[1] > 15:
            nx[is_super] = 0.0
            nx[is_super, -1] = 1.0
        ev = float(np.float32(g["eigenvalue"]))  # the stored target
        y = np.asarray((ev - ev_c) / ev_s,
                       dtype=np.float32).reshape(1)
        out.append(dict(g, x=nx.astype(np.float32), y=y))
    stats = (np.float32(ev_s[0]), np.float32(ev_c[0]))
    return out, stats
