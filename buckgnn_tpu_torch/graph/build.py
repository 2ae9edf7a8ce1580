"""Graph construction: MeshModel + FEAResults -> GraphData.

The L2 core of the framework — re-implements
``create_graph_from_bdf`` (Dataset_Preparation/GraphCreate.py:143-432) with
the exact feature-schema contract (SURVEY §2.3):

node features (buckling, 2D, no supernode -> 15 dims):
  x, y (canonical frame) | SPC 1/0.25/0 | Fx, Fy (rotated) | boundary |
  4 stiffener bins / 3 | ux, uy (rotated) | Mohr-rotated sx, sy, txy
optional: +8 quadrant GP forces, +3/+6 mode shape, +1 z, +rotations,
+1 supernode indicator (always last).

edge features (5 dims): [stiffener_flag 1.0/0.01, length/1000, dir_x,
dir_y, virtual_flag] (+1 axial stress when enabled; the reference's
column-order quirk that treats column 4 as axial is preserved,
GraphCreate.py:371-377 / Normalizer.py:319-323).

Hot loops are vectorized NumPy instead of the reference's per-node Python
loop (GraphCreate.py:178-332, the ETL bottleneck). A NumPy copy of
buckgnn_tpu/graph/build.py, kept here so the port needs no JAX.
"""

from __future__ import annotations

import numpy as np

from buckgnn_tpu_torch.graph import virtual as virtual_mod
from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.mesh import (
    ACTIVE_STIFFENER_PID, FEAResults, MeshModel,
)
from buckgnn_tpu_torch.graph.transform import (
    mohr_transform,
    stiffener_bins,
    transform_to_simulation_coordinates,
)

__all__ = ["find_boundary_nodes", "build_graph", "shell_edges",
           "rcm_reorder"]


def shell_edges(mesh: MeshModel) -> tuple[np.ndarray, np.ndarray]:
    """All element-perimeter edges (undirected, as sorted index pairs) with
    occurrence counts. Quad perimeters + tria perimeters
    (find_boundary_nodes, GraphCreate.py:124-133)."""
    pairs = []
    for conn in (mesh.quads, mesh.trias):
        if len(conn) == 0:
            continue
        k = conn.shape[1]
        for i in range(k):
            a = conn[:, i]
            b = conn[:, (i + 1) % k]
            pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1))
    if not pairs:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    allp = np.concatenate(pairs)
    uniq, counts = np.unique(allp, axis=0, return_counts=True)
    return uniq, counts


def find_boundary_nodes(mesh: MeshModel) -> np.ndarray:
    """Boundary node indices: endpoints of shell edges that appear exactly
    once (GraphCreate.py:112-141)."""
    uniq, counts = shell_edges(mesh)
    b = uniq[counts == 1]
    return np.unique(b.reshape(-1))


def build_graph(
    mesh: MeshModel,
    results: FEAResults,
    use_z_coord: bool = False,
    use_rotations: bool = False,
    use_gp_forces: bool = False,
    use_axial_stress: bool = False,
    use_mode_shapes_as_features: bool = False,
    use_super_node: bool = False,
    use_virtual_edges: bool = True,
    virtual_edge_percentage: float = 0.1333,
    virtual_edges: list[tuple[int, int]] | None = None,
    transform: bool = True,
    prediction_type: str = "buckling",
    seed: int = 0,
) -> GraphData:
    """MeshModel + FEAResults -> GraphData (create_graph_from_bdf parity).

    When neither virtual edges nor supernode are requested the graph keeps
    only mesh edges (an ablation the reference cannot express: its builder
    always adds one of the two, GraphCreate.py:379-415; set
    ``use_virtual_edges=False, use_super_node=False``).
    """
    n = mesh.n_node
    coords2d = mesh.coords[:, :2]

    if transform:
        transformed, _, tmatrix, tinfo = transform_to_simulation_coordinates(
            coords2d
        )
    else:
        transformed = coords2d
        tmatrix = np.eye(2)
        tinfo = None

    boundary = np.zeros(n, dtype=bool)
    boundary[find_boundary_nodes(mesh)] = True

    is_static = "static" in prediction_type

    # --- vectorized node features (GraphCreate.py:178-332) ---
    cols: list[np.ndarray] = [transformed]
    if use_z_coord:
        cols.append(mesh.coords[:, 2:3])

    spc = np.zeros((n, 1))
    for idx, comp in mesh.spc_components.items():
        spc[idx, 0] = 1.0 if comp == "123456" else 0.25
    cols.append(spc)

    force_dim = 3 if use_z_coord else 2
    force = np.zeros((n, force_dim))
    for idx, vec in mesh.forces.items():
        v = np.asarray(vec, dtype=np.float64)
        if use_z_coord:
            v = v[:3].copy()
            v[:2] = v[:2] @ tmatrix
        else:
            v = v[:2] @ tmatrix
        force[idx] = v
    cols.append(force)

    # boundary + stiffener bins / 3 (GraphCreate.py:227-231)
    bins = np.zeros((n, 4))
    active = mesh.cbar_pids == ACTIVE_STIFFENER_PID if len(mesh.cbars) else None
    if active is not None and active.any():
        act = mesh.cbars[active]
        # group active-CBAR neighbors per node
        for a, b in act:
            bins[a] += stiffener_bins(coords2d[a], coords2d[None, b], tmatrix)
            bins[b] += stiffener_bins(coords2d[b], coords2d[None, a], tmatrix)
    cols.append(boundary.astype(np.float64)[:, None])
    cols.append(bins / 3.0)

    static_target_cols: list[np.ndarray] = []
    if results.static_displacements is not None:
        disp = np.asarray(results.static_displacements, dtype=np.float64)
        if use_z_coord:
            d = disp[:, :3].copy()
            d[:, :2] = d[:, :2] @ tmatrix
            cols.append(d)
            if use_rotations:
                r = disp[:, 3:6].copy()
                r[:, :2] = r[:, :2] @ tmatrix
                cols.append(r)
        else:
            d2 = disp[:, :2] @ tmatrix
            if not is_static:
                cols.append(d2)
            else:
                static_target_cols.append(d2)
            if use_rotations and not use_z_coord:
                r2 = disp[:, 3:5] @ tmatrix if disp.shape[1] >= 5 else np.zeros(
                    (n, 2)
                )
                if not is_static:
                    cols.append(r2)
                else:
                    static_target_cols.append(r2)

    if results.gp_stresses is not None:
        sig = mohr_transform(
            np.asarray(results.gp_stresses)[:, :3], tmatrix, tinfo, transform
        )
        if not is_static:
            cols.append(sig)
        else:
            static_target_cols.append(sig)

    if use_gp_forces and not is_static and results.gp_forces is not None:
        # quadrant-averaged grid-point forces (GraphCreate.py:291-318)
        elem_centers = {
            int(eid): transformed[conn].mean(axis=0)
            for eid, conn in zip(mesh.quad_ids, mesh.quads)
        }
        gpf = np.zeros((n, 8))
        for idx in range(n):
            node_forces = results.gp_forces.get(
                int(mesh.node_ids[idx]), results.gp_forces.get(idx)
            )
            if not node_forces:
                continue
            force_sums = np.zeros((4, 2))
            counts = np.zeros(4)
            for eid, fvec in node_forces.items():
                center = elem_centers.get(int(eid))
                if center is None:
                    continue
                rel = center - transformed[idx]
                quad = (int(rel[0] < 0) * 2) + int(rel[1] < 0)
                force_sums[quad] += np.asarray(fvec[:2]) @ tmatrix
                counts[quad] += 1
            for q in range(4):
                if counts[q] > 0:
                    gpf[idx, 2 * q : 2 * q + 2] = force_sums[q] / counts[q]
        cols.append(gpf)

    if (
        use_mode_shapes_as_features
        and not is_static
        and results.mode_shape is not None
    ):
        mode = np.asarray(results.mode_shape, dtype=np.float64).copy()
        m = mode[:, :3].copy()
        m[:, :2] = m[:, :2] @ tmatrix
        cols.append(m)
        if use_rotations:
            mr = mode[:, 3:6].copy()
            mr[:, :2] = mr[:, :2] @ tmatrix
            cols.append(mr)

    x = np.concatenate(cols, axis=1)

    # --- edges (GraphCreate.py:334-377) ---
    edges: dict[tuple[int, int], list[float]] = {}
    uniq, _counts = shell_edges(mesh)
    if len(uniq):
        p1 = transformed[uniq[:, 0]]
        p2 = transformed[uniq[:, 1]]
        d = p2 - p1
        dist = np.linalg.norm(d, axis=1)
        direction = d / dist[:, None]
        for i, (a, b) in enumerate(uniq):
            edges[(int(a), int(b))] = [
                0.01, dist[i] / 1000.0, direction[i, 0], direction[i, 1],
            ]
    for ci, (a, b) in enumerate(mesh.cbars):
        a, b = int(min(a, b)), int(max(a, b))
        p1, p2 = transformed[a], transformed[b]
        d = p2 - p1
        dist = float(np.linalg.norm(d))
        direction = d / dist
        flag = 1.0 if mesh.cbar_pids[ci] == ACTIVE_STIFFENER_PID else 0.01
        feat = [flag, dist / 1000.0, float(direction[0]), float(direction[1])]
        edges[(a, b)] = feat
        if use_axial_stress and results.cbar_axial is not None and not is_static:
            eid = int(mesh.cbar_ids[ci])
            feat.append(float(results.cbar_axial.get(eid, 0.0)))

    supernode = -1
    if use_super_node:
        # (GraphCreate.py:403-415; VirtualEdgeCreate.py:81-113)
        for e in edges.values():
            if len(e) < 5:
                e.append(0.0)  # virtual flag 0 for real edges
            if use_axial_stress and len(e) < 6:
                e.append(0.0)
        feat_size = x.shape[1]
        x = np.concatenate([x, np.zeros((n, 1))], axis=1)  # real-node flag 0
        super_row = np.zeros((1, feat_size + 1))
        super_row[0, -1] = 1.0
        x = np.concatenate([x, super_row], axis=0)
        transformed = np.vstack([transformed, np.zeros((1, 2))])
        supernode = n
        for a, b in virtual_mod.create_super_node_edges(n):
            edges[(a, b)] = virtual_mod.virtual_edge_features(
                transformed[a], transformed[b], use_axial_stress
            )
        n = n + 1
    elif use_virtual_edges:
        existing = set(edges.keys())
        if virtual_edges is None:
            virtual_edges = virtual_mod.create_random_virtual_edges(
                n, existing, virtual_edge_percentage, seed=seed
            )
        for e in edges.values():
            if len(e) < 5:
                e.append(0.0)
            if use_axial_stress and len(e) < 6:
                e.append(0.0)
        for a, b in virtual_edges:
            edges[(a, b)] = virtual_mod.virtual_edge_features(
                transformed[a], transformed[b], use_axial_stress
            )
    else:
        for e in edges.values():
            if len(e) < 5:
                e.append(0.0)
            if use_axial_stress and len(e) < 6:
                e.append(0.0)

    # Emit both directions (GraphCreate.py:417-422).
    pairs = np.array(list(edges.keys()), dtype=np.int32).reshape(-1, 2)
    feats = np.array(list(edges.values()), dtype=np.float32)
    senders = np.concatenate([pairs[:, 0], pairs[:, 1]])
    receivers = np.concatenate([pairs[:, 1], pairs[:, 0]])
    edge_attr = np.concatenate([feats, feats], axis=0)

    # --- targets (load_single_data, GraphCreate.py:524-542) ---
    eigenvalue = results.eigenvalue
    mode_shapes = None
    if prediction_type == "buckling":
        y = np.array([eigenvalue], dtype=np.float32)
        if results.mode_shape is not None:
            mode_shapes = np.asarray(results.mode_shape, dtype=np.float32)
    elif is_static:
        y = np.concatenate(static_target_cols, axis=1).astype(np.float32)
    elif prediction_type == "mode_shape":
        mode = np.asarray(results.mode_shape, dtype=np.float64).copy()
        mode[:, :2] = mode[:, :2] @ tmatrix
        if use_rotations:
            mode[:, 3:5] = mode[:, 3:5] @ tmatrix
            y = mode.astype(np.float32)
        else:
            y = mode[:, :3].astype(np.float32)
    else:
        raise ValueError(f"Unknown prediction type: {prediction_type}")

    return GraphData(
        x=x.astype(np.float32),
        senders=senders.astype(np.int32),
        receivers=receivers.astype(np.int32),
        edge_attr=edge_attr,
        y=y,
        supernode=supernode,
        eigenvalue=float(eigenvalue) if eigenvalue is not None else None,
        mode_shapes=mode_shapes,
    )


def _virtual_edge_mask(g: GraphData) -> np.ndarray:
    """Boolean [E] mask of RANDOM virtual edges via the trailing
    virtual-flag edge-feature dim (build_graph:259 writes 0 for real
    edges; the normalizer never rescales it). Supernode star edges carry
    the same flag (virtual.py::virtual_edge_features) but are handled by
    their own analytic path with its own full-star guard — they are NOT
    part of this mask."""
    e = len(np.asarray(g.senders))
    if g.edge_attr is None or g.edge_attr.shape[1] == 0:
        return np.zeros(e, dtype=bool)
    mask = np.asarray(g.edge_attr)[:, -1] != 0
    if g.supernode >= 0:
        s = np.asarray(g.senders)
        r = np.asarray(g.receivers)
        mask &= (s != g.supernode) & (r != g.supernode)
    return mask


def rcm_reorder(g: GraphData) -> GraphData:
    """Relabel nodes with a reverse Cuthill-McKee permutation so edges
    concentrate near the diagonal — the locality the block-banded SAGE path
    (ops/banded.py) exploits. Synthetic grid meshes are naturally banded;
    real BDF meshes arrive in arbitrary node order and need this.

    The supernode (always the last node, batch.py convention) stays last;
    its star edges are excluded from the RCM graph so they do not wreck the
    ordering (they are handled densely by the banded aggregator anyway).
    Virtual edges (VirtualEdgeCreate.py:21-49 parity: uniform random node
    pairs) are likewise excluded: they are global shortcuts with no
    locality, and feeding them to RCM inflates the mesh bandwidth ~10x —
    forcing width 256+ bands — while they still spill. Ordering by MESH
    edges only keeps the band at the mesh's natural width (~the panel
    side) and routes virtual edges through the kernel-fused spill window,
    which is exactly the fixed-capacity random-access path they need.
    """
    from buckgnn_tpu_torch.utils import native

    n = g.n_node
    s = np.asarray(g.senders, dtype=np.int64)
    r = np.asarray(g.receivers, dtype=np.int64)
    keep = ~_virtual_edge_mask(g)
    if g.supernode >= 0:
        keep &= (s != g.supernode) & (r != g.supernode)
        perm_core = native.rcm_order(n - 1, s[keep], r[keep])
        perm = np.concatenate([perm_core, [n - 1]])
    else:
        perm = native.rcm_order(n, s[keep], r[keep])
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    y = g.y
    if y.ndim == 2 and y.shape[0] == n:  # node-level target
        y = y[perm]
    ms = g.mode_shapes
    if ms is not None:
        # mode_shapes covers only real nodes (supernode appended after,
        # GraphCreate.py:551-552) — permute with the core permutation.
        ms = ms[perm] if ms.shape[0] == n else ms[perm[: ms.shape[0]]]
    return GraphData(
        x=g.x[perm],
        senders=inv[s].astype(np.int32),
        receivers=inv[r].astype(np.int32),
        edge_attr=g.edge_attr,
        y=y,
        supernode=g.supernode,
        eigenvalue=g.eigenvalue,
        mode_shapes=ms,
        file_path=g.file_path,
    )
