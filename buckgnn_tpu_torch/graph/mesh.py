"""Neutral FE-mesh model + results containers and Nastran BDF interop.

The reference couples graph construction to pyNastran BDF/OP2 objects
(GraphCreate.py:143-432). We decouple: `MeshModel`/`FEAResults` are plain
NumPy containers that any producer can fill — the built-in synthetic
generator (`buckgnn_tpu_torch.graph.synthetic`), the self-contained BDF reader
below, or pyNastran when installed (OP2 parsing, `read_op2_results`).

The in-repo BDF reader/writer covers exactly the card set the reference's
data generator emits (Data_Generation_v3.py:18-58,216-262: GRID, CQUAD4,
CTRIA3, CBAR, PSHELL, PBAR, MAT1, SPC1, FORCE, EIGRL), small-field and
free-field formats.

A copy of buckgnn_tpu/graph/mesh.py, kept here so the port needs no JAX:
the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MeshModel", "FEAResults", "read_bdf", "write_bdf", "read_op2_results"]

ACTIVE_STIFFENER_PID = 900  # PBAR 900 == active 2x80mm (Data_Generation_v3.py:246-262)
DUMMY_STIFFENER_PID = 999


@dataclasses.dataclass
class MeshModel:
    """FE mesh with boundary conditions. Node arrays are index-aligned to
    ``node_ids`` sorted ascending (the reference's sorted-node convention,
    GraphCreate.py:150-151)."""

    node_ids: np.ndarray                  # [n] int
    coords: np.ndarray                    # [n, 3] float
    quads: np.ndarray                     # [nq, 4] int node INDICES
    trias: np.ndarray                     # [nt, 3] int node indices
    cbars: np.ndarray                     # [nc, 2] int node indices
    cbar_pids: np.ndarray                 # [nc] int property ids
    quad_ids: np.ndarray | None = None    # [nq] element ids
    cbar_ids: np.ndarray | None = None    # [nc] element ids
    spc_components: dict | None = None    # node index -> component string
    forces: dict | None = None            # node index -> [3] scaled vector

    @property
    def n_node(self) -> int:
        return int(self.coords.shape[0])

    def __post_init__(self):
        if self.spc_components is None:
            self.spc_components = {}
        if self.forces is None:
            self.forces = {}
        if self.quad_ids is None and len(self.quads):
            self.quad_ids = np.arange(1, len(self.quads) + 1)
        if self.cbar_ids is None and len(self.cbars):
            self.cbar_ids = np.arange(
                100000, 100000 + len(self.cbars)
            )


@dataclasses.dataclass
class FEAResults:
    """Solver outputs consumed by graph construction
    (parse_nastran_results, GraphCreate.py:55-110)."""

    eigenvalue: float | None = None
    static_displacements: np.ndarray | None = None  # [n, >=2]
    mode_shape: np.ndarray | None = None            # [n, >=3]
    gp_stresses: np.ndarray | None = None           # [n, 3] (sx, sy, txy)
    gp_forces: dict | None = None                   # node idx -> {elem id: [>=2]}
    cbar_axial: dict | None = None                  # elem id -> float


# ---------------------------------------------------------------------- #
# BDF interop
# ---------------------------------------------------------------------- #


def _parse_field(s: str) -> float:
    """Nastran field: may use embedded exponent like '1.2-3' == 1.2e-3."""
    s = s.strip()
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:
        for i in range(len(s) - 1, 0, -1):
            if s[i] in "+-" and s[i - 1] not in "eE":
                return float(s[:i] + "e" + s[i:])
        raise


def _fields(line: str) -> list[str]:
    if "," in line:
        return [f.strip() for f in line.split(",")]
    if line[:8].rstrip().endswith("*"):
        # large-field: 8-char name then 16-char columns
        return [line[:8].strip()] + [
            line[i : i + 16].strip() for i in range(8, len(line), 16)
        ]
    # small-field: 8-char columns
    return [line[i : i + 8].strip() for i in range(0, len(line), 8)]


# Bulk cards read_bdf PARSES into MeshModel. This is the deck contract:
# anything else in the bulk section is skipped with a one-shot warning
# naming the card (real HyperMesh exports carry CORD2R/SPCADD/PARAM/...
# that this pipeline does not consume), never a silent drop.
_PARSED_CARDS = frozenset(
    {"GRID", "CQUAD4", "CTRIA3", "CBAR", "SPC1", "FORCE"}
)
# Property/material/solution cards the datagen writer emits with FIXED
# reference constants (write_bdf, NastranExport.tcl:46-60) — recognized
# (no foreign-card warning) but carrying nothing MeshModel stores.
_KNOWN_IGNORED_CARDS = frozenset(
    {"MAT1", "PSHELL", "PBAR", "EIGRL", "ENDDATA"}
)


def read_bdf(path: str) -> MeshModel:
    """Minimal BDF reader for the reference card set (module docstring).

    Card contract: bulk-section cards in ``_PARSED_CARDS`` populate the
    MeshModel; ``_KNOWN_IGNORED_CARDS`` are recognized no-ops; any OTHER
    card type is skipped with a ``UserWarning`` naming it (once per
    type). A malformed card of a PARSED type raises ``ValueError`` — a
    deck that corrupts supported cards must fail loudly, not produce a
    silently truncated mesh.
    """
    import warnings

    grid: dict[int, np.ndarray] = {}
    quads: list[tuple[int, list[int]]] = []
    trias: list[tuple[int, list[int]]] = []
    cbars: list[tuple[int, int, list[int]]] = []
    spc1: list[tuple[str, list[int]]] = []
    forces: list[tuple[int, float, np.ndarray]] = []

    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    # executive + case control end at BEGIN BULK; without the marker the
    # whole file is treated as bulk (bare card decks)
    bulk_start = 0
    for i, ln in enumerate(lines):
        if ln.upper().startswith("BEGIN BULK"):
            bulk_start = i + 1
            break
    # join continuation lines. In both small- and large-field formats the
    # data region runs through column 72 (cols 1-8 name / continuation
    # marker, cols 73-80 continuation pointer); writers routinely strip
    # trailing blanks, so pad the parent back out to the 72-column
    # boundary before appending — otherwise every appended field shifts
    # left and 16-char large-field columns misparse. Each continuation
    # contributes its own 64-char data region, padded likewise, keeping
    # the boundary aligned across multiple continuations.
    merged: list[str] = []
    for ln in lines[bulk_start:]:
        if ln.startswith(("+", "*", " ")) and merged and not ln.strip() == "":
            parent = merged[-1]
            if "," in parent:
                merged[-1] = parent + ln[8:]  # free-field: comma split
            else:
                if len(parent) <= 80:  # un-merged original line
                    parent = parent[:72].ljust(72)
                merged[-1] = parent + ln[8:72].ljust(64)
        else:
            merged.append(ln)
    unknown: set[str] = set()
    for ln in merged:
        if not ln or ln.startswith("$"):
            continue
        f = _fields(ln)
        card = f[0].upper().rstrip("*")
        if card not in _PARSED_CARDS:
            if card and card not in _KNOWN_IGNORED_CARDS:
                unknown.add(card)
            continue
        try:
            if card == "GRID":
                nid = int(f[1])
                xyz = np.array(
                    [_parse_field(f[3]), _parse_field(f[4]), _parse_field(f[5])]
                )
                grid[nid] = xyz
            elif card == "CQUAD4":
                quads.append((int(f[1]), [int(v) for v in f[3:7]]))
            elif card == "CTRIA3":
                trias.append((int(f[1]), [int(v) for v in f[3:6]]))
            elif card == "CBAR":
                cbars.append((int(f[1]), int(f[2]), [int(f[3]), int(f[4])]))
            elif card == "SPC1":
                comp = f[2]
                nodes = [int(v) for v in f[3:] if v]
                spc1.append((comp, nodes))
            elif card == "FORCE":
                nid = int(f[2])
                scale = _parse_field(f[4])
                vec = np.array(
                    [_parse_field(f[5]), _parse_field(f[6]), _parse_field(f[7])]
                )
                forces.append((nid, scale, vec))
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"malformed {card} card in {path!r}: {ln!r}"
            ) from e
    if unknown:
        warnings.warn(
            f"read_bdf({path!r}): skipped unsupported card types "
            f"{sorted(unknown)} — parsed set is {sorted(_PARSED_CARDS)}",
            UserWarning,
            stacklevel=2,
        )

    node_ids = np.array(sorted(grid))
    id_to_idx = {nid: i for i, nid in enumerate(node_ids)}
    coords = np.array([grid[n] for n in node_ids])

    def remap(rows):
        return np.array(
            [[id_to_idx[n] for n in r] for r in rows], dtype=np.int32
        ).reshape(len(rows), -1)

    quad_conn = remap([q[1] for q in quads]) if quads else np.zeros((0, 4), np.int32)
    tria_conn = remap([t[1] for t in trias]) if trias else np.zeros((0, 3), np.int32)
    cbar_conn = remap([c[2] for c in cbars]) if cbars else np.zeros((0, 2), np.int32)

    spc_components = {}
    for comp, nodes in spc1:
        for n in nodes:
            if n in id_to_idx:
                spc_components[id_to_idx[n]] = comp
    force_map = {}
    for nid, scale, vec in forces:
        if nid in id_to_idx:
            force_map[id_to_idx[nid]] = scale * vec

    return MeshModel(
        node_ids=node_ids,
        coords=coords,
        quads=quad_conn,
        trias=tria_conn,
        cbars=cbar_conn,
        cbar_pids=np.array([c[1] for c in cbars], dtype=np.int32),
        quad_ids=np.array([q[0] for q in quads], dtype=np.int64),
        cbar_ids=np.array([c[0] for c in cbars], dtype=np.int64),
        spc_components=spc_components,
        forces=force_map,
    )


def write_bdf(mesh: MeshModel, path: str, eigrl_nd: int = 1) -> None:
    """Write a SOL 105 deck in the reference's layout: static subcase +
    buckling subcase with EIGRL (CustomBDF, Data_Generation_v3.py:18-58);
    MAT1 aluminium E=76 GPa nu=0.3, PSHELL t=1.5 mm (NastranExport.tcl:46-60)."""
    with open(path, "w") as fh:
        w = fh.write
        w("SOL 105\nCEND\n")
        w("SPC = 1\nDISPLACEMENT(PLOT) = ALL\n")
        w("SUBCASE 1\n  LOAD = 2\n")
        w("SUBCASE 2\n  METHOD = 10\n  STATSUB = 1\n")
        w("BEGIN BULK\n")
        w(f"EIGRL,10,0.0,,{eigrl_nd}\n")
        w("MAT1,1,76000.,,0.3\n")
        w("PSHELL,1,1,1.5\n")
        w("PBAR,900,1,160.,21333.,85333.\n")
        w("PBAR,999,1,0.001,0.001,0.001\n")
        for nid, xyz in zip(mesh.node_ids, mesh.coords):
            w(f"GRID,{int(nid)},,{xyz[0]:.6g},{xyz[1]:.6g},{xyz[2]:.6g}\n")
        for eid, conn in zip(mesh.quad_ids, mesh.quads):
            ids = ",".join(str(int(mesh.node_ids[c])) for c in conn)
            w(f"CQUAD4,{int(eid)},1,{ids}\n")
        for i, conn in enumerate(mesh.trias):
            ids = ",".join(str(int(mesh.node_ids[c])) for c in conn)
            w(f"CTRIA3,{900000 + i},1,{ids}\n")
        cbar_ids = mesh.cbar_ids if mesh.cbar_ids is not None else ()
        for eid, pid, conn in zip(cbar_ids, mesh.cbar_pids, mesh.cbars):
            n1, n2 = (int(mesh.node_ids[c]) for c in conn)
            w(f"CBAR,{int(eid)},{int(pid)},{n1},{n2},0.,0.,1.\n")
        for idx, comp in mesh.spc_components.items():
            w(f"SPC1,1,{comp},{int(mesh.node_ids[idx])}\n")
        for idx, vec in mesh.forces.items():
            w(
                f"FORCE,2,{int(mesh.node_ids[idx])},,1.,"
                f"{vec[0]:.6g},{vec[1]:.6g},{vec[2]:.6g}\n"
            )
        w("ENDDATA\n")


def read_op2_results(op2_path: str) -> FEAResults:
    """Binary OP2 parsing (parse_nastran_results, GraphCreate.py:55-110):
    pyNastran when installed (full format coverage), else the in-repo
    FORTRAN-record reader (graph/op2.py, the BuckGNN OFP subset). Both
    produce pyNastran's attribute layout, so extraction is shared."""
    try:
        from pyNastran.op2.op2 import OP2  # type: ignore
    except ImportError:
        from buckgnn_tpu_torch.graph.op2 import read_op2

        return extract_op2_results(read_op2(op2_path))

    op2 = OP2(debug=False)
    op2.read_op2(op2_path)
    return extract_op2_results(op2)


def extract_op2_results(op2) -> FEAResults:
    """Extraction logic split from the pyNastran reader so it is unit
    testable against a mock OP2 object (the attribute layout mirrors
    pyNastran's OP2: eigenvectors/displacements/grid_point_surface_stresses
    /cbar_stress/grid_point_forces result dicts)."""
    buck = list(op2.eigenvectors.keys())[0]
    ev = op2.eigenvectors[buck]
    eigenvalue = float(ev.eigrs[0])
    mode_shape = np.asarray(ev.data[0])
    static_key = list(op2.displacements.keys())[0]
    disp = np.asarray(op2.displacements[static_key].data[0])
    gps_key = list(op2.grid_point_surface_stresses.keys())[0]
    gps = np.asarray(op2.grid_point_surface_stresses[gps_key].data[0])
    gps = _make_unique_groups(gps)
    cbar_axial = {}
    if op2.cbar_stress:
        ck = list(op2.cbar_stress.keys())[0]
        cs = op2.cbar_stress[ck]
        for i, eid in enumerate(np.asarray(cs.element)):
            cbar_axial[int(eid)] = float(cs.data[0, i, 4])
    gp_forces: dict = {}
    if op2.grid_point_forces:
        gk = list(op2.grid_point_forces.keys())[0]
        gpf = op2.grid_point_forces[gk]
        for i, ename in enumerate(gpf.element_names[0]):
            if str(ename).startswith("QUAD4"):
                nid, eid = gpf.node_element[0][i]
                gp_forces.setdefault(int(nid), {})[int(eid)] = np.asarray(
                    gpf.data[0][i][:3]
                )
    return FEAResults(
        eigenvalue=eigenvalue,
        static_displacements=disp,
        mode_shape=mode_shape,
        gp_stresses=gps[:, :3],
        gp_forces=gp_forces,
        cbar_axial=cbar_axial,
    )


def _make_unique_groups(arr: np.ndarray) -> np.ndarray:
    """Dedup GP stress triplets, keep first row per unique group
    (make_unique_groups, GraphCreate.py:891-906)."""
    if arr.shape[0] % 3 != 0:
        raise ValueError("Number of rows must be a multiple of 3")
    grouped = arr.reshape(-1, 3, arr.shape[1])
    flat = grouped.reshape(grouped.shape[0], -1)
    _, indices = np.unique(flat, axis=0, return_index=True)
    indices.sort()
    return grouped[indices][:, 0, :]
