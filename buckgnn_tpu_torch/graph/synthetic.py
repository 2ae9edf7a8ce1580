"""Synthetic mesh generator + FEA-free oracle — hermetic datasets.

The reference can only exercise its pipeline against MSC Nastran + HyperMesh
outputs; its own GNN-only switch (INFERENCE_TIMER.py:298 ``NASTRAN=False``)
still needs pre-existing BDF/OP2 pairs. This module generalizes that
pattern (SURVEY §4.5): every pipeline stage runs hermetically on generated
meshes with a deterministic pseudo-FEA oracle, on any machine, in CI.

Geometry mirrors the reference's data regime: quad-dominant shell meshes of
~700-1000 mm panels (Shape_Generation.py:389-392), clamped SPC edge
('123456', Data_Generation_v3.py:386), random in-plane edge loads, optional
CBAR stiffeners with active pid 900 (Data_Generation_v3.py:246-262). The
oracle produces a smooth, learnable buckling eigenvalue plus consistent
displacement/stress/mode-shape fields — physics-flavoured, not physics.
"""

from __future__ import annotations

import numpy as np

from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.build import build_graph
from buckgnn_tpu_torch.graph.mesh import (
    ACTIVE_STIFFENER_PID,
    DUMMY_STIFFENER_PID,
    FEAResults,
    MeshModel,
)

__all__ = ["generate_mesh", "fake_fea", "generate_dataset"]


def generate_mesh(
    seed: int = 0,
    min_side: int = 4,
    max_side: int = 10,
    with_stiffeners: bool = False,
) -> MeshModel:
    """Random jittered quad-grid panel with clamped edge + edge loads."""
    rng = np.random.default_rng(seed)
    nx = int(rng.integers(min_side, max_side + 1))
    ny = int(rng.integers(min_side, max_side + 1))
    lx = float(rng.uniform(700.0, 1000.0))
    ly = float(rng.uniform(700.0, 1000.0))

    xs = np.linspace(0, lx, nx)
    ys = np.linspace(0, ly, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)

    # jitter interior nodes (keeps boundary topology intact)
    interior = (
        (gx > 0) & (gx < lx) & (gy > 0) & (gy < ly)
    ).reshape(-1)
    jitter = rng.uniform(-0.25, 0.25, size=coords.shape) * np.array(
        [lx / max(nx - 1, 1), ly / max(ny - 1, 1)]
    )
    coords[interior] += jitter[interior]

    # random global placement: rotation + translation (exercises the
    # canonicalization layer)
    ang = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    coords = coords @ rot.T + rng.uniform(-500, 500, size=2)

    def nid(i, j):
        return i * ny + j

    quads = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            quads.append([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)])
    quads = np.array(quads, dtype=np.int32)

    n = coords.shape[0]
    coords3 = np.concatenate([coords, np.zeros((n, 1))], axis=1)

    # clamp one grid edge, load the opposite (Data_Generation_v3.py:370-442)
    spc_components = {nid(0, j): "123456" for j in range(ny)}
    mag = float(rng.uniform(500.0, 5000.0))
    theta = rng.uniform(0, 2 * np.pi)
    fvec = mag * np.array([np.cos(theta), np.sin(theta), 0.0])
    forces = {nid(nx - 1, j): fvec.copy() for j in range(ny)}

    cbars = np.zeros((0, 2), np.int32)
    cbar_pids = np.zeros((0,), np.int32)
    if with_stiffeners:
        # stiffen a few consecutive aligned grid lines (weight-tied groups of
        # consecutive edges, Data_Generation_v3.py:322-368)
        segs = []
        pids = []
        n_groups = int(rng.integers(1, 4))
        for _ in range(n_groups):
            horizontal = bool(rng.integers(0, 2))
            active = bool(rng.integers(0, 2))
            pid = ACTIVE_STIFFENER_PID if active else DUMMY_STIFFENER_PID
            if horizontal:
                j = int(rng.integers(0, ny))
                i0 = int(rng.integers(0, max(nx - 3, 1)))
                length = int(rng.integers(2, max(nx - i0, 3)))
                for i in range(i0, min(i0 + length, nx - 1)):
                    segs.append([nid(i, j), nid(i + 1, j)])
                    pids.append(pid)
            else:
                i = int(rng.integers(0, nx))
                j0 = int(rng.integers(0, max(ny - 3, 1)))
                length = int(rng.integers(2, max(ny - j0, 3)))
                for j in range(j0, min(j0 + length, ny - 1)):
                    segs.append([nid(i, j), nid(i, j + 1)])
                    pids.append(pid)
        if segs:
            cbars = np.array(segs, dtype=np.int32)
            cbar_pids = np.array(pids, dtype=np.int32)

    return MeshModel(
        node_ids=np.arange(1, n + 1),
        coords=coords3,
        quads=quads,
        trias=np.zeros((0, 3), np.int32),
        cbars=cbars,
        cbar_pids=cbar_pids,
        spc_components=spc_components,
        forces=forces,
    )


def fake_fea(mesh: MeshModel, seed: int = 0) -> FEAResults:
    """Deterministic pseudo-FEA oracle.

    The buckling eigenvalue is a smooth function of load magnitude, panel
    span, aspect ratio and active-stiffener fraction — rich enough that a
    GNN must actually use geometry+load features to predict it, bounded to
    the reference's eigenvalue regime (~0.5..15,
    Eigenvalue_Distribution.py bins).
    """
    rng = np.random.default_rng(seed + 10_000)
    coords = mesh.coords[:, :2]
    span = coords.max(axis=0) - coords.min(axis=0)
    diag = float(np.linalg.norm(span))
    centroid = coords.mean(axis=0)

    force_nodes = sorted(mesh.forces)
    if force_nodes:
        total_force = np.sum(
            [mesh.forces[i][:2] for i in force_nodes], axis=0
        )
    else:
        total_force = np.zeros(2)
    fmag = float(np.linalg.norm(total_force)) + 1e-6
    fdir = total_force / fmag

    spc_nodes = sorted(mesh.spc_components)
    spc_centroid = coords[spc_nodes].mean(axis=0) if spc_nodes else centroid
    load_centroid = coords[force_nodes].mean(axis=0) if force_nodes else centroid
    lever = float(np.linalg.norm(load_centroid - spc_centroid)) + 1e-6

    n_active = (
        int(np.sum(mesh.cbar_pids == ACTIVE_STIFFENER_PID))
        if len(mesh.cbar_pids)
        else 0
    )
    stiff_frac = n_active / max(len(mesh.quads), 1)

    # pseudo critical load factor: plate-buckling flavoured scaling, tuned
    # so eigenvalues land in the reference's ~0.5..20 regime
    # (Eigenvalue_Distribution.py 0.05-wide bins over a few units)
    e_mod, t = 76_000.0, 1.5
    per_node_force = fmag / max(len(force_nodes), 1)
    k = 2.0 + 1.5 * abs(float(np.cos(2 * np.arctan2(fdir[1], fdir[0]))))
    aspect = float(max(span) / (min(span) + 1e-6))
    eigenvalue = (
        10.0 * k * e_mod * t**3
        / (diag * per_node_force)
        * (1.0 + 1.2 * stiff_frac)
        * (1.0 + 0.15 * (aspect - 1.0))
        * (diag / (2.0 * lever)) ** 0.3
    )
    eigenvalue *= float(rng.uniform(0.9, 1.1))
    eigenvalue = float(np.clip(eigenvalue, 0.05, 40.0))

    # displacement field: grows with distance from the clamped edge,
    # directed along the load
    d_from_spc = np.linalg.norm(coords - spc_centroid, axis=1)
    amp = fmag / (e_mod * t * 10.0)
    profile = (d_from_spc / (d_from_spc.max() + 1e-6)) ** 1.5
    disp = np.zeros((mesh.n_node, 6))
    disp[:, 0] = amp * profile * fdir[0]
    disp[:, 1] = amp * profile * fdir[1]

    # stress field: nominal membrane stress decaying from the load edge
    width = max(span.min(), 1.0)
    sigma0 = fmag / (width * t)
    d_from_load = np.linalg.norm(coords - load_centroid, axis=1)
    decay = np.exp(-2.0 * d_from_load / (diag + 1e-6))
    gp = np.zeros((mesh.n_node, 3))
    gp[:, 0] = sigma0 * decay * fdir[0] ** 2
    gp[:, 1] = sigma0 * decay * fdir[1] ** 2
    gp[:, 2] = 0.5 * sigma0 * decay * fdir[0] * fdir[1]

    # first mode: out-of-plane half-sine bump
    rel = (coords - coords.min(axis=0)) / np.maximum(span, 1e-6)
    mode = np.zeros((mesh.n_node, 6))
    mode[:, 2] = np.sin(np.pi * rel[:, 0]) * np.sin(np.pi * rel[:, 1])

    cbar_axial = {}
    if mesh.cbar_ids is not None:
        for ci, eid in enumerate(mesh.cbar_ids):
            a, b = mesh.cbars[ci]
            mid = 0.5 * (coords[a] + coords[b])
            d = float(np.linalg.norm(mid - load_centroid))
            cbar_axial[int(eid)] = sigma0 * float(np.exp(-2.0 * d / (diag + 1e-6)))

    gp_forces: dict = {}
    if mesh.quad_ids is not None:
        for eid, conn in zip(mesh.quad_ids, mesh.quads):
            center = coords[conn].mean(axis=0)
            d = float(np.linalg.norm(center - load_centroid))
            f = sigma0 * t * np.exp(-2.0 * d / (diag + 1e-6)) * fdir
            for c in conn:
                gp_forces.setdefault(int(mesh.node_ids[c]), {})[int(eid)] = (
                    np.array([f[0], f[1], 0.0]) / len(conn)
                )

    return FEAResults(
        eigenvalue=eigenvalue,
        static_displacements=disp,
        mode_shape=mode,
        gp_stresses=gp,
        gp_forces=gp_forces,
        cbar_axial=cbar_axial,
    )


def generate_dataset(
    n_graphs: int,
    seed: int = 0,
    with_stiffeners: bool = False,
    min_side: int = 4,
    max_side: int = 10,
    **build_kwargs,
) -> list[GraphData]:
    """n hermetic graphs (mesh -> oracle -> build_graph), deterministic in
    ``seed``. ``build_kwargs`` forward to `build_graph`."""
    out = []
    for i in range(n_graphs):
        s = seed * 1_000_003 + i
        mesh = generate_mesh(
            s, min_side=min_side, max_side=max_side, with_stiffeners=with_stiffeners
        )
        results = fake_fea(mesh, s)
        out.append(build_graph(mesh, results, seed=s, **build_kwargs))
    return out
