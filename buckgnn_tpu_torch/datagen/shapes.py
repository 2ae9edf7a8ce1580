"""Organic 2D shape generation + hermetic quad meshing.

Re-creates the reference's shape generator
(Data_Generation/Shape_Generation.py) without its OpenCASCADE/HyperMesh
dependency chain: the same *statistical family* of shapes — random polar
boundary points with radius variation, sinusoidal frequency modulation and
inward-curve dips (Shape_Generation.py:23-64), smoothed into a closed cubic
Bezier chain with shared tangent directions at the joints (:66-119), scaled
to a 700-1000 mm envelope with aspect-ratio acceptance (:120-162), circular/
elliptical cutouts placed in the safe interior (:233-318) — but meshed
directly into a ``MeshModel`` by a masked-grid quad mesher with boundary
snapping, replacing STEP export + HyperMesh batch meshing
(BDF_Extract.py:12-119, NastranExport.tcl). Material/thickness constants
match NastranExport.tcl:46-60 (Al E=76 GPa nu=0.3, PSHELL t=1.5 mm) via
mesh.py's writer.

Everything is driven by a ``numpy.random.Generator`` so datasets are
reproducible; nothing here touches JAX (host-side L1 of the stack).

A copy of buckgnn_tpu/datagen/shapes.py, kept here so the port needs no
JAX: the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from buckgnn_tpu_torch.graph.mesh import MeshModel

__all__ = ["ShapeConfig", "generate_boundary", "bezier_chain",
           "place_cutouts", "polygon_contains", "mesh_polygon",
           "generate_shape_mesh"]


@dataclasses.dataclass
class ShapeConfig:
    """Knobs mirroring the reference's config dict
    (Shape_Generation.py:386-430)."""

    # boundary (polar) sampling
    min_points: int = 4
    max_points: int = 8
    min_radius: float = 300.0
    max_radius: float = 500.0
    angle_variation: float = 0.2           # rad jitter per vertex
    min_radius_variation: float = -0.3
    max_radius_variation: float = 0.4
    frequency_multiplier: float = 3.0
    frequency_magnitude: float = 0.15
    inward_curve_probability: float = 0.2
    min_inward_scale: float = 0.5
    max_inward_scale: float = 0.8
    # bezier smoothing
    min_radius_factor: float = 0.25
    length_variation: float = 0.3
    max_variation_scale: float = 0.2
    samples_per_edge: int = 24
    # envelope + acceptance
    min_size: float = 700.0
    max_size: float = 1000.0
    aspect_ratio_min: float = 0.5
    aspect_ratio_max: float = 2.0
    # cutouts
    with_cutouts: bool = False
    max_cutouts: int = 3
    cutout_min_size: float = 60.0
    cutout_max_size: float = 140.0
    cutout_min_distance_factor: float = 0.6
    ellipse_probability: float = 0.4
    max_attempts: int = 40
    # meshing
    target_elem_size: float = 35.0
    max_generation_attempts: int = 50


def generate_boundary(rng: np.random.Generator, cfg: ShapeConfig) -> np.ndarray:
    """Random polar boundary vertices (Shape_Generation.py:23-64)."""
    num = int(rng.integers(cfg.min_points, cfg.max_points + 1))
    base_radius = float(rng.uniform(cfg.min_radius, cfg.max_radius))
    pts = []
    for i in range(num):
        ang = 2 * np.pi * i / num
        ang += float(rng.uniform(-cfg.angle_variation, cfg.angle_variation))
        radius = base_radius * (
            1 + float(rng.uniform(cfg.min_radius_variation,
                                  cfg.max_radius_variation))
        )
        radius *= 1 + cfg.frequency_magnitude * np.sin(
            cfg.frequency_multiplier * ang + float(rng.uniform(-np.pi, np.pi))
        )
        if rng.random() < cfg.inward_curve_probability:
            radius *= float(rng.uniform(cfg.min_inward_scale,
                                        cfg.max_inward_scale))
        pts.append([np.cos(ang) * radius, np.sin(ang) * radius])
    return np.asarray(pts)


def _cubic_bezier(p0, c1, c2, p1, ts):
    u = 1 - ts
    return (
        (u ** 3)[:, None] * p0
        + 3 * (u ** 2 * ts)[:, None] * c1
        + 3 * (u * ts ** 2)[:, None] * c2
        + (ts ** 3)[:, None] * p1
    )


def bezier_chain(points: np.ndarray, rng: np.random.Generator,
                 cfg: ShapeConfig) -> np.ndarray:
    """Closed cubic-Bezier chain through the boundary vertices with smooth
    joints (Shape_Generation.py:66-119), densely sampled to a polygon."""
    n = len(points)
    ts = np.linspace(0.0, 1.0, cfg.samples_per_edge, endpoint=False)
    samples = []
    for i in range(n):
        p1 = points[i]
        p2 = points[(i + 1) % n]
        prev_pt = points[(i - 1) % n]
        next_pt = points[(i + 2) % n]
        base = p2 - p1
        length = float(np.linalg.norm(base))
        min_radius = length * cfg.min_radius_factor

        prev_dir = p1 - prev_pt
        next_dir = next_pt - p2
        prev_n = prev_dir / np.linalg.norm(prev_dir)
        next_n = next_dir / np.linalg.norm(next_dir)
        base_n = base / length

        def ctrl_len():
            return min_radius * (4.0 / 3.0) * float(
                rng.uniform(1.0, 1.0 + cfg.length_variation)
            )

        entry = prev_n + base_n
        exitd = base_n + next_n
        entry = entry / np.linalg.norm(entry) * ctrl_len()
        exitd = exitd / np.linalg.norm(exitd) * ctrl_len()
        perp = np.array([-base[1], base[0]]) / length
        var = float(rng.uniform(-1, 1)) * min_radius * cfg.max_variation_scale
        entry = entry + perp * var
        exitd = exitd + perp * var
        samples.append(_cubic_bezier(p1, p1 + entry, p2 - exitd, p2, ts))
    return np.concatenate(samples, axis=0)


def scale_to_bounds(poly: np.ndarray, rng: np.random.Generator,
                    cfg: ShapeConfig) -> np.ndarray:
    """Scale the polygon so max(width,height) hits a random target in
    [min_size, max_size], centered at origin (Shape_Generation.py:120-148)."""
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    target = float(rng.uniform(cfg.min_size, cfg.max_size))
    poly = poly * (target / max(hi[0] - lo[0], hi[1] - lo[1]))
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    return poly - (lo + hi) / 2.0


def aspect_ok(poly: np.ndarray, cfg: ShapeConfig) -> bool:
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    ar = (hi[0] - lo[0]) / max(hi[1] - lo[1], 1e-12)
    return cfg.aspect_ratio_min <= ar <= cfg.aspect_ratio_max


def polygon_contains(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon (the reference's per-point
    loop, Shape_Generation.py:179-193)."""
    x, y = points[:, 0][:, None], points[:, 1][:, None]
    x1, y1 = poly[:, 0][None, :], poly[:, 1][None, :]
    x2 = np.roll(poly[:, 0], -1)[None, :]
    y2 = np.roll(poly[:, 1], -1)[None, :]
    cond = (y1 > y) != (y2 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
    crossing = cond & (x < xin)
    return (np.sum(crossing, axis=1) % 2).astype(bool)


def _dist_to_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Min distance from each point to the polygon outline (vectorized
    point-segment distance, Shape_Generation.py:163-177)."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a                                            # [S,2]
    denom = np.maximum(np.einsum("sd,sd->s", ab, ab), 1e-12)
    ap = points[:, None, :] - a[None, :, :]               # [P,S,2]
    t = np.clip(np.einsum("psd,sd->ps", ap, ab) / denom, 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    return np.min(np.linalg.norm(points[:, None, :] - proj, axis=2), axis=1)


@dataclasses.dataclass
class Cutout:
    center: np.ndarray
    rx: float
    ry: float
    angle: float

    def contains(self, points: np.ndarray, margin: float = 0.0) -> np.ndarray:
        rel = points - self.center
        c, s = np.cos(-self.angle), np.sin(-self.angle)
        u = rel[:, 0] * c - rel[:, 1] * s
        v = rel[:, 0] * s + rel[:, 1] * c
        return (u / (self.rx + margin)) ** 2 + (v / (self.ry + margin)) ** 2 <= 1.0


def place_cutouts(poly: np.ndarray, rng: np.random.Generator,
                  cfg: ShapeConfig) -> list[Cutout]:
    """Circular/elliptical cutouts in the safe interior, min-spacing
    enforced (Shape_Generation.py:233-318)."""
    if not cfg.with_cutouts:
        return []
    min_distance = cfg.cutout_min_size * (1 + cfg.cutout_min_distance_factor)
    lo, hi = poly.min(axis=0), poly.max(axis=0)
    step = min_distance / 2
    gx, gy = np.meshgrid(np.arange(lo[0], hi[0], step),
                         np.arange(lo[1], hi[1], step), indexing="ij")
    grid = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    ok = polygon_contains(grid, poly)
    ok &= _dist_to_polygon(grid, poly) >= min_distance
    interior = grid[ok]
    if len(interior) == 0:
        return []
    desired = int(rng.integers(1, cfg.max_cutouts + 1))
    cutouts: list[Cutout] = []
    for _ in range(cfg.max_attempts):
        if len(cutouts) >= desired or len(interior) == 0:
            break
        center = interior[int(rng.integers(len(interior)))]
        rx = float(rng.uniform(cfg.cutout_min_size, cfg.cutout_max_size)) / 2
        ry = rx
        ang = 0.0
        if rng.random() < cfg.ellipse_probability:
            ry = rx * float(rng.uniform(0.5, 0.9))
            ang = float(rng.uniform(0, np.pi))
        cut = Cutout(center=center, rx=rx, ry=ry, angle=ang)
        # keep inside shape and clear of earlier cutouts
        if np.any(_dist_to_polygon(center[None], poly) < max(rx, ry) * 1.2):
            continue
        if any(np.linalg.norm(center - c.center) <
               max(rx, ry) + max(c.rx, c.ry) + cfg.cutout_min_size / 2
               for c in cutouts):
            continue
        cutouts.append(cut)
        interior = interior[~cut.contains(interior, margin=min_distance)]
    return cutouts


def mesh_polygon(poly: np.ndarray, cutouts: list[Cutout],
                 elem_size: float) -> tuple[np.ndarray, np.ndarray] | None:
    """Masked-grid quad mesher with boundary snapping.

    Covers the bounding box with a structured grid at ``elem_size``, keeps
    quads whose center is inside the outline and outside every cutout, then
    pulls nodes that lie outside (or are nearly on the outline) onto the
    nearest outline point — a light Laplacian pass smooths the interior.
    Returns (coords [n,2], quads [q,4] int indices) or None if degenerate.
    """
    lo, hi = poly.min(axis=0) - elem_size, poly.max(axis=0) + elem_size
    nx = max(int(np.ceil((hi[0] - lo[0]) / elem_size)) + 1, 3)
    ny = max(int(np.ceil((hi[1] - lo[1]) / elem_size)) + 1, 3)
    xs = np.linspace(lo[0], hi[0], nx)
    ys = np.linspace(lo[1], hi[1], ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)

    def nid(i, j):
        return i * ny + j

    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    quads = np.stack(
        [nid(ii, jj), nid(ii + 1, jj), nid(ii + 1, jj + 1), nid(ii, jj + 1)],
        axis=1,
    )
    centers = nodes[quads].mean(axis=1)
    keep = polygon_contains(centers, poly)
    for c in cutouts:
        keep &= ~c.contains(centers)
    quads = quads[keep]
    if len(quads) < 4:
        return None

    used = np.unique(quads.reshape(-1))
    remap = -np.ones(len(nodes), dtype=np.int64)
    remap[used] = np.arange(len(used))
    coords = nodes[used].copy()
    quads = remap[quads]

    # snap nodes outside the outline (or inside a cutout) onto it
    outside = ~polygon_contains(coords, poly)
    if outside.any():
        coords[outside] = _nearest_on_polygon(coords[outside], poly)
    for c in cutouts:
        inside_cut = c.contains(coords)
        if inside_cut.any():
            coords[inside_cut] = _nearest_on_ellipse(coords[inside_cut], c)

    # one Jacobi-Laplacian smoothing pass on interior nodes
    counts = np.zeros(len(coords))
    sums = np.zeros_like(coords)
    for k in range(4):
        a = quads[:, k]
        b = quads[:, (k + 1) % 4]
        np.add.at(sums, a, coords[b])
        np.add.at(sums, b, coords[a])
        np.add.at(counts, a, 1)
        np.add.at(counts, b, 1)
    fixed = outside.copy()
    for c in cutouts:
        fixed |= c.contains(coords, margin=1e-6)
    interior = (~fixed) & (counts >= 7.9)  # nodes with all 4 quads present
    coords[interior] = 0.5 * coords[interior] + 0.5 * (
        sums[interior] / counts[interior][:, None]
    )

    # reject tangled quads (negative Jacobian corners)
    v1 = coords[quads[:, 1]] - coords[quads[:, 0]]
    v2 = coords[quads[:, 3]] - coords[quads[:, 0]]
    cross = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    quads = quads[cross > 1e-9]
    if len(quads) < 4:
        return None
    used2 = np.unique(quads.reshape(-1))
    remap2 = -np.ones(len(coords), dtype=np.int64)
    remap2[used2] = np.arange(len(used2))
    return coords[used2], remap2[quads]


def _nearest_on_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a
    denom = np.maximum(np.einsum("sd,sd->s", ab, ab), 1e-12)
    ap = points[:, None, :] - a[None, :, :]
    t = np.clip(np.einsum("psd,sd->ps", ap, ab) / denom, 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    d = np.linalg.norm(points[:, None, :] - proj, axis=2)
    best = np.argmin(d, axis=1)
    return proj[np.arange(len(points)), best]


def _nearest_on_ellipse(points: np.ndarray, c: Cutout) -> np.ndarray:
    rel = points - c.center
    co, s = np.cos(-c.angle), np.sin(-c.angle)
    u = rel[:, 0] * co - rel[:, 1] * s
    v = rel[:, 0] * s + rel[:, 1] * co
    ang = np.arctan2(v / max(c.ry, 1e-9), u / max(c.rx, 1e-9))
    u2, v2 = c.rx * np.cos(ang), c.ry * np.sin(ang)
    x = u2 * co + v2 * s
    y = -u2 * s + v2 * co
    return np.stack([x, y], axis=1) + c.center


def generate_shape_mesh(
    seed: int = 0,
    cfg: ShapeConfig | None = None,
) -> MeshModel:
    """One organic shape -> quad MeshModel (no BCs/loads; see
    datagen/loadcases.py for those). Retries generation until the aspect
    check and mesher both succeed (Shape_Generation.py:320-376's accept
    loop)."""
    cfg = cfg or ShapeConfig()
    rng = np.random.default_rng(seed)
    for _ in range(cfg.max_generation_attempts):
        verts = generate_boundary(rng, cfg)
        poly = bezier_chain(verts, rng, cfg)
        poly = scale_to_bounds(poly, rng, cfg)
        if not aspect_ok(poly, cfg):
            continue
        cutouts = place_cutouts(poly, rng, cfg)
        meshed = mesh_polygon(poly, cutouts, cfg.target_elem_size)
        if meshed is None:
            continue
        coords, quads = meshed
        n = len(coords)
        return MeshModel(
            node_ids=np.arange(1, n + 1),
            coords=np.concatenate([coords, np.zeros((n, 1))], axis=1),
            quads=quads,
            trias=np.zeros((0, 3), dtype=np.int64),
            cbars=np.zeros((0, 2), dtype=np.int64),
            cbar_pids=np.zeros((0,), dtype=np.int64),
        )
    raise RuntimeError(
        f"shape generation failed after {cfg.max_generation_attempts} attempts"
    )
