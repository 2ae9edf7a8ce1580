"""Loadcase + stiffener-pattern generation on FE meshes.

Host-side re-implementation of the reference's loadcase/stiffener data
generator (Data_Generation/Data_Generation_v3.py), decoupled from Nastran:

- outer-boundary tracing from the rightmost node over count==1 shell edges
  (Data_Generation_v3.py:136-179),
- random SPC ('123456') boundary-condition lines and load lines of
  connected boundary runs with a shared random direction/magnitude per
  line (:370-442),
- CBAR stiffener candidates on every element edge plus quad diagonals
  (:216-244) with active PBAR 900 (2x80 mm) vs dummy PBAR 999 properties
  (:246-262), activated in random-walk groups of consecutive connected
  edges (:322-368),
- loadcase classification from mean principal stresses into compression/
  shear/tension/... types (:547-622) and the eigenvalue-ratio
  accept/reject policy (:624-646).

The FEA oracle is injected: production uses an external solver through
datagen/runner.py; tests and CPU CI use graph/synthetic.py's fake_fea.
All randomness flows through a seeded ``numpy.random.Generator``.

A copy of buckgnn_tpu/datagen/loadcases.py, kept here so the port needs no
JAX: the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from buckgnn_tpu_torch.graph.build import shell_edges
from buckgnn_tpu_torch.graph.mesh import (
    ACTIVE_STIFFENER_PID,
    DUMMY_STIFFENER_PID,
    MeshModel,
)

__all__ = [
    "LoadcaseConfig", "LoadcaseType", "Loadcase", "trace_outer_boundary",
    "generate_loadcase", "stiffener_candidates", "activate_stiffener_group",
    "classify_loadcase", "should_accept_loadcase", "apply_loadcase",
    "generate_model_cases",
]


@dataclasses.dataclass
class LoadcaseConfig:
    """Mirrors the reference Config dataclass
    (Data_Generation_v3.py:72-96)."""

    min_load: float = 10.0
    max_load: float = 100.0
    generate_stiffeners: bool = True
    min_active_stiffeners: int = 5
    max_active_stiffeners: int = 200
    min_consecutive: int = 5
    max_consecutive: int = 10
    loadcases_per_model: int = 10
    patterns_per_loadcase: int = 1
    max_bc_lines: int = 3
    max_load_lines: int = 3
    max_nodes_per_line: int = 10
    min_nodes_per_line: int = 3
    max_nodes_per_load_line: int = 10
    min_nodes_per_load_line: int = 3
    max_trials: int = 4
    eigenvalue_ratio_limit: float = 3.0
    high_ratio_acceptance_rate: float = 0.1
    very_high_ratio_acceptance_rate: float = 0.05


class LoadcaseType(enum.Enum):
    COMPRESSION = "compression"
    COMPRESSION_SHEAR = "compression-shear"
    TENSION = "tension"
    TENSION_SHEAR = "tension-shear"
    SHEAR = "shear"
    MIXED = "mixed"


@dataclasses.dataclass
class Loadcase:
    """BC node indices (all '123456') + per-load-line (nodes, direction,
    magnitude)."""

    bc_nodes: np.ndarray                       # [nb] node indices
    load_lines: list[tuple[np.ndarray, np.ndarray, float]]
    loadcase_type: LoadcaseType | None = None
    eigenvalue_ratio: float | None = None


def trace_outer_boundary(mesh: MeshModel) -> np.ndarray:
    """Outer boundary node indices via the rightmost-node edge trace
    (detect_boundary, Data_Generation_v3.py:136-179). Interior cutout
    boundaries are excluded — only the loop reachable from the rightmost
    node counts."""
    uniq, counts = shell_edges(mesh)
    bedges = {tuple(e) for e in uniq[counts == 1].tolist()}
    if not bedges:
        return np.zeros((0,), dtype=np.int64)
    rightmost = int(np.argmax(mesh.coords[:, 0]))
    outer = [rightmost]
    current = rightmost
    while True:
        nxt = None
        for e in bedges:
            if e[0] == current:
                nxt = (e[0], e[1])
                break
            if e[1] == current:
                nxt = (e[1], e[0])
                break
        if nxt is None or nxt[1] == rightmost:
            if nxt is not None:
                bedges.discard(tuple(sorted(nxt)))
            break
        current = nxt[1]
        outer.append(current)
        bedges.discard(tuple(sorted(nxt)))
    return np.asarray(outer, dtype=np.int64)


def _connected_run(start: int, available: set[int],
                   boundary_order: np.ndarray, length: int) -> list[int]:
    """Walk the boundary cycle from `start` collecting up to `length`
    consecutive available nodes (find_connected_boundary_nodes's role)."""
    order = boundary_order.tolist()
    if start not in order:
        return []
    i = order.index(start)
    run = [start]
    n = len(order)
    step = 1
    while len(run) < length:
        j = order[(i + step) % n]
        if j in available and j not in run:
            run.append(j)
            step += 1
        else:
            break
    return run


def generate_loadcase(mesh: MeshModel, rng: np.random.Generator,
                      cfg: LoadcaseConfig) -> Loadcase | None:
    """Sample SPC lines + load lines on the outer boundary
    (generate_loadcase, Data_Generation_v3.py:370-442). Returns None when
    the boundary is too short or either set ends up empty."""
    boundary = trace_outer_boundary(mesh)
    if len(boundary) < cfg.min_nodes_per_line * 2:
        return None
    bset = set(boundary.tolist())

    bc_nodes: set[int] = set()
    for _ in range(cfg.max_bc_lines):
        num = int(rng.integers(cfg.min_nodes_per_line,
                               cfg.max_nodes_per_line + 1))
        avail = bset - bc_nodes
        if not avail:
            break
        start = int(rng.choice(sorted(avail)))
        run = _connected_run(start, avail, boundary, num)
        if len(run) == num:
            bc_nodes.update(run)

    load_lines: list[tuple[np.ndarray, np.ndarray, float]] = []
    avail = bset - bc_nodes
    for _ in range(cfg.max_load_lines):
        if len(avail) < cfg.min_nodes_per_load_line:
            break
        num = int(rng.integers(
            cfg.min_nodes_per_load_line,
            min(cfg.max_nodes_per_load_line, len(avail)) + 1,
        ))
        start = int(rng.choice(sorted(avail)))
        run = _connected_run(start, avail, boundary, num)
        if len(run) == num:
            avail -= set(run)
            ang = float(rng.uniform(0, 2 * np.pi))
            direction = np.array([np.cos(ang), np.sin(ang), 0.0])
            magnitude = float(rng.uniform(cfg.min_load, cfg.max_load))
            load_lines.append((np.asarray(run, dtype=np.int64), direction,
                               magnitude))

    if not bc_nodes or not load_lines:
        return None
    return Loadcase(bc_nodes=np.asarray(sorted(bc_nodes), dtype=np.int64),
                    load_lines=load_lines)


def stiffener_candidates(mesh: MeshModel) -> np.ndarray:
    """All candidate CBAR edges: element perimeter edges + quad diagonals
    (create_edges, Data_Generation_v3.py:216-244). Returns [c, 2] sorted
    unique index pairs."""
    uniq, _ = shell_edges(mesh)
    pairs = [np.asarray(uniq, dtype=np.int64).reshape(-1, 2)]
    if len(mesh.quads):
        q = mesh.quads
        for i, j in ((0, 2), (1, 3)):
            a, b = q[:, i], q[:, j]
            pairs.append(
                np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
            )
    allp = np.concatenate(pairs)
    return np.unique(allp, axis=0)


def activate_stiffener_group(
    candidates: np.ndarray, coords: np.ndarray, rng: np.random.Generator,
    cfg: LoadcaseConfig,
) -> np.ndarray:
    """Pick active stiffeners as random-walk groups of connected
    consecutive edges (activate_stiffener_group,
    Data_Generation_v3.py:322-368): grow forward from a random start edge
    by shared endpoints, falling back to backward growth once. Returns a
    boolean mask over candidates."""
    n = len(candidates)
    active = np.zeros(n, dtype=bool)
    if n == 0:
        return active
    target = int(rng.integers(
        cfg.min_active_stiffeners,
        min(cfg.max_active_stiffeners, n) + 1,
    ))
    # endpoint -> candidate edge ids
    by_node: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(candidates.tolist()):
        by_node.setdefault(a, []).append(i)
        by_node.setdefault(b, []).append(i)
    avail = np.ones(n, dtype=bool)

    def connected(edge_id: int, node: int) -> int | None:
        for j in by_node.get(node, ()):
            if avail[j] and j != edge_id:
                return j
        return None

    while active.sum() < target and avail.any():
        remaining = target - int(active.sum())
        lo = min(cfg.min_consecutive, remaining)
        hi = min(cfg.max_consecutive, remaining)
        size = int(rng.integers(lo, hi + 1)) if hi > lo else lo
        start = int(rng.choice(np.flatnonzero(avail)))
        group = [start]
        avail[start] = False
        forward = True
        back_tried = False
        while len(group) < size:
            if forward:
                tail = candidates[group[-1], 1]
                j = connected(group[-1], int(tail))
                if j is None and not back_tried:
                    forward, back_tried = False, True
                    continue
                if j is None:
                    break
                group.append(j)
            else:
                head = candidates[group[0], 0]
                j = connected(group[0], int(head))
                if j is None:
                    break
                group.insert(0, j)
            avail[j] = False
        active[group] = True
    return active


def classify_loadcase(gp_stresses: np.ndarray) -> LoadcaseType:
    """Loadcase type from mean principal stresses
    (Data_Generation_v3.py:575-622). ``gp_stresses`` is [n, 3]
    (sx, sy, txy); principal values computed per node then averaged."""
    s = np.asarray(gp_stresses, dtype=np.float64)
    cx, cy, txy = s[:, 0], s[:, 1], s[:, 2]
    mid = (cx + cy) / 2
    rad = np.sqrt(((cx - cy) / 2) ** 2 + txy ** 2)
    major = float(np.mean(mid + rad))
    minor = float(np.mean(mid - rad))
    denom = major - minor
    if denom <= 0:
        return LoadcaseType.MIXED
    compression_ratio = float(np.clip(minor / denom, -1.0, 0.0))
    tension_ratio = float(np.clip(major / denom, 0.0, 1.0))
    if compression_ratio <= -0.8:
        return LoadcaseType.COMPRESSION
    if compression_ratio <= -0.65:
        return LoadcaseType.COMPRESSION_SHEAR
    if tension_ratio >= 0.8:
        return LoadcaseType.TENSION
    if tension_ratio >= 0.65:
        return LoadcaseType.TENSION_SHEAR
    if max(abs(compression_ratio), tension_ratio) < 0.55:
        return LoadcaseType.SHEAR
    return LoadcaseType.MIXED


def should_accept_loadcase(
    loadcase_type: LoadcaseType, eigenvalue_ratio: float | None,
    rng: np.random.Generator, cfg: LoadcaseConfig,
) -> bool:
    """Eigenvalue-ratio acceptance policy
    (should_accept_loadcase, Data_Generation_v3.py:624-646):
    ratio <= limit always; <= 10 with 10% probability; > 10 with 5% for
    tension(-shear), 10% otherwise."""
    if eigenvalue_ratio is None:
        return False
    if eigenvalue_ratio <= cfg.eigenvalue_ratio_limit:
        return True
    if eigenvalue_ratio <= 10:
        return bool(rng.random() < cfg.high_ratio_acceptance_rate)
    if loadcase_type in (LoadcaseType.TENSION, LoadcaseType.TENSION_SHEAR):
        return bool(rng.random() < cfg.very_high_ratio_acceptance_rate)
    return bool(rng.random() < cfg.high_ratio_acceptance_rate)


def apply_loadcase(
    mesh: MeshModel, lc: Loadcase,
    stiffener_edges: np.ndarray | None = None,
    active_mask: np.ndarray | None = None,
) -> MeshModel:
    """New MeshModel with the loadcase's SPCs/forces (and optional
    stiffener CBARs) applied — the analysis-model construction step
    (create_analysis_model, Data_Generation_v3.py:444-471)."""
    spc = {int(i): "123456" for i in lc.bc_nodes}
    forces: dict[int, np.ndarray] = {}
    for nodes, direction, magnitude in lc.load_lines:
        for i in nodes:
            forces[int(i)] = forces.get(int(i), np.zeros(3)) + \
                direction * magnitude
    if stiffener_edges is not None and len(stiffener_edges):
        cbars = np.asarray(stiffener_edges, dtype=np.int64)
        pids = np.where(
            active_mask if active_mask is not None
            else np.zeros(len(cbars), dtype=bool),
            ACTIVE_STIFFENER_PID, DUMMY_STIFFENER_PID,
        ).astype(np.int64)
    else:
        cbars = np.zeros((0, 2), dtype=np.int64)
        pids = np.zeros((0,), dtype=np.int64)
    return MeshModel(
        node_ids=mesh.node_ids, coords=mesh.coords, quads=mesh.quads,
        trias=mesh.trias, cbars=cbars, cbar_pids=pids,
        quad_ids=mesh.quad_ids, spc_components=spc, forces=forces,
    )


def generate_model_cases(
    mesh: MeshModel, oracle, seed: int = 0,
    cfg: LoadcaseConfig | None = None,
) -> list[MeshModel]:
    """Accepted (loadcase x stiffener-pattern) models for one base mesh —
    the process_model loop (Data_Generation_v3.py:648-739) with the FEA
    oracle injected: ``oracle(mesh) -> FEAResults`` must fill eigenvalue
    and gp_stresses (graph/synthetic.py::fake_fea or a real solver via
    datagen/runner.py)."""
    cfg = cfg or LoadcaseConfig()
    rng = np.random.default_rng(seed)
    out: list[MeshModel] = []
    candidates = (stiffener_candidates(mesh)
                  if cfg.generate_stiffeners else None)
    accepted = 0
    trials = 0
    while accepted < cfg.loadcases_per_model and \
            trials < cfg.loadcases_per_model * cfg.max_trials:
        trials += 1
        lc = generate_loadcase(mesh, rng, cfg)
        if lc is None:
            continue
        probe = apply_loadcase(mesh, lc)
        res = oracle(probe)
        if res.eigenvalue is None or res.gp_stresses is None:
            continue
        # eigenvalue_ratio = |first positive / first| (the probe solve asks
        # for several modes; with a single-mode oracle the ratio is 1)
        ratio = getattr(res, "eigenvalue_ratio", None)
        if ratio is None:
            ratio = 1.0 if res.eigenvalue > 0 else None
        lc.loadcase_type = classify_loadcase(res.gp_stresses)
        lc.eigenvalue_ratio = ratio
        if not should_accept_loadcase(lc.loadcase_type, ratio, rng, cfg):
            continue
        accepted += 1
        if candidates is not None and len(candidates):
            for _ in range(cfg.patterns_per_loadcase):
                active = activate_stiffener_group(
                    candidates, mesh.coords[:, :2], rng, cfg
                )
                out.append(apply_loadcase(mesh, lc, candidates, active))
        else:
            out.append(probe)
    return out
