"""Coordinate-invariance canonicalization and stress/stiffener transforms.

Host-side NumPy, bit-compatible with the reference pipeline:

- `transform_to_simulation_coordinates`: symmetric shapes align their longest
  diagonal with the x-axis; non-symmetric shapes use PCA with third-moment
  sign fixes (Dataset_Preparation/Transformation.py:78-198).
- `mohr_transform`: Mohr's-circle plane-stress rotation with the reference's
  flip-sign correction on tau_xy (Dataset_Preparation/GraphCreate.py:254-289;
  standalone oracle Utils/Stress_Transformation.py:3-16).
- `stiffener_bins`: 4-direction angle-weighted binning of active stiffeners
  (Dataset_Preparation/Transformation.py:5-76), vectorized.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "TransformInfo",
    "is_symmetric",
    "transform_diagonal_alignment",
    "transform_pca",
    "transform_to_simulation_coordinates",
    "mohr_transform",
    "stiffener_bins",
]


class TransformInfo(dict):
    """transform_info dict: rotation_angle, flip_x, flip_y
    (Transformation.py:188-192)."""


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


def stiffener_bins(
    node_coords: np.ndarray,
    neighbor_coords: np.ndarray,
    transformation_matrix: np.ndarray,
    angle_tolerance: float = 1.0,
) -> np.ndarray:
    """Bin active-stiffener directions at one node into 4 orientation bins.

    ``neighbor_coords``: [k, 2] other-end coordinates of CBARs with pid==900
    at this node. Angle-weighted split between the two nearest of
    {0, 45, 90, 135} deg with a 1-degree snap tolerance
    (Transformation.py:23-74). Returns the raw bins (callers divide by 3,
    GraphCreate.py:228).
    """
    bins = np.zeros(4)
    if len(neighbor_coords) == 0:
        return bins
    direction = np.asarray(neighbor_coords, dtype=np.float64) - node_coords
    direction = direction / (
        np.linalg.norm(direction, axis=-1, keepdims=True) + 1e-8
    )
    transformed = direction @ transformation_matrix
    angle = np.degrees(np.arctan2(transformed[:, 1], transformed[:, 0])) % 360
    angle = np.where(angle > 180, angle - 180, angle)

    distances = np.abs(angle[:, None] - _BIN_CENTERS[None, :])
    distances = np.minimum(distances, 180 - distances)
    for d in distances:
        min_d = np.min(d)
        if min_d <= angle_tolerance:
            bins[int(np.argmin(d))] += 1.0
        else:
            nearest = np.argsort(d)[:2]
            d1, d2 = d[nearest]
            total = d1 + d2
            bins[nearest[0]] += d2 / total
            bins[nearest[1]] += d1 / total
    return bins
