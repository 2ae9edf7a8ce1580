"""Self-contained MSC Nastran OP2 binary reader + writer (OFP subset).

The reference ingests solver output through pyNastran
(Dataset_Preparation/GraphCreate.py:55-110). pyNastran is not part of
this framework's baked-in environment, and the tables BuckGNN consumes
are a small, stable subset of Nastran's output-file-processor (OFP)
format — so this module reads them straight from the binary
FORTRAN-record stream (real binary ingestion, no package dependency) and
writes the same subset (test fixtures; result caching for the datagen
runner). The layout follows the MSC OFP conventions as documented by
pyNastran's reader: 146-word IDENT records whose words carry
approach/table/subcase codes, followed by DATA records of
``num_wide``-word entries.

Framing: little-endian FORTRAN sequential records (4-byte length fence
before and after each payload). A table appears as an 8-character name
record followed by marker and content records. This reader SCANS records
tolerantly: an 8-byte record matching a known table name switches
context, a 584-byte record is an IDENT, the record after an IDENT is its
DATA, and everything else (markers, unknown tables, GEOM blocks from real
runs) is skipped — so OP2 files carrying more than this subset still
parse.

Consumed tables (matching what `extract_op2_results` pulls from
pyNastran, graph/mesh.py):

- ``OUGV1`` table_code 1  — static displacements (8-wide reals)
- ``OUGV1`` table_code 7  — buckling eigenvector (8-wide reals; the
  eigenvalue rides in IDENT word 6, and in ``LAMA`` when present)
- ``LAMA``                — eigenvalue summary (7-wide reals)
- ``OGS1``  table_code 26 — grid point surface stresses (10-wide)
- ``OGPFB1`` table_code 19 — grid point force balance (10-wide, with an
  8-char element name inline)
- ``OES1X1`` table_code 5, element type 34 — CBAR stresses (16-wide)

A copy of buckgnn_tpu/graph/op2.py, kept here so the port needs no JAX:
the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace

import numpy as np

_IDENT_WORDS = 146
_TABLE_NAMES = (b"OUGV1   ", b"LAMA    ", b"OGS1    ", b"OGPFB1  ",
                b"OES1X1  ")
_DEVICE_CODE = 1  # PLOT (the only device this pipeline emits/reads)

# IDENT word indices (0-based; MSC OFP via pyNastran's op2 reader)
_W_APPROACH = 0   # analysis_code * 10 + device_code
_W_TABLE = 1      # table_code
_W_ELTYPE = 2     # element type (OES) / 0
_W_SUBCASE = 3    # isubcase
_W_MODE = 4       # mode number / load set id
_W_EIGN = 5       # eigenvalue (float) for eigen results
_W_NUMWIDE = 9    # words per data entry

_TABLE_DISP = 1
_TABLE_OES = 5
_TABLE_EIGENVECTOR = 7
_TABLE_GPFORCE = 19
_TABLE_GPSTRESS = 26
_ELEM_CBAR = 34


# ------------------------- FORTRAN records ------------------------- #


def _write_record(f, payload: bytes) -> None:
    fence = struct.pack("<i", len(payload))
    f.write(fence)
    f.write(payload)
    f.write(fence)


def _write_marker(f, value: int) -> None:
    _write_record(f, struct.pack("<i", value))


def _iter_records(path: str):
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if not head:
                return
            if len(head) < 4:
                raise ValueError(f"{path}: truncated record header")
            n = struct.unpack("<i", head)[0]
            if n < 0 or n > 1 << 27:
                # a sane OFP record is KBs; a wildly large/negative fence
                # almost always means a big-endian file (byte-swapped
                # length) or 8-byte record fences — fail loudly instead of
                # reading garbage
                raise ValueError(
                    f"{path}: implausible record length {n} — not a "
                    "little-endian 4-byte-fence OP2 (big-endian or 64-bit "
                    "record markers are not supported)"
                )
            payload = f.read(n)
            tail = f.read(4)
            if len(payload) < n or len(tail) < 4:
                raise ValueError(f"{path}: truncated record body")
            if struct.unpack("<i", tail)[0] != n:
                raise ValueError(
                    f"{path}: FORTRAN record fence mismatch (not an OP2?)"
                )
            yield payload


def _ident(analysis_code: int, table_code: int, isubcase: int,
           num_wide: int, *, element_type: int = 0, mode: int = 0,
           eigenvalue: float = 0.0) -> bytes:
    words = np.zeros(_IDENT_WORDS, dtype=np.int32)
    words[_W_APPROACH] = analysis_code * 10 + _DEVICE_CODE
    words[_W_TABLE] = table_code
    words[_W_ELTYPE] = element_type
    words[_W_SUBCASE] = isubcase
    words[_W_MODE] = mode
    words[_W_NUMWIDE] = num_wide
    buf = bytearray(words.tobytes())
    buf[4 * _W_EIGN: 4 * _W_EIGN + 4] = struct.pack("<f", eigenvalue)
    return bytes(buf)


# ------------------------------ writer ----------------------------- #


def write_op2(
    path: str,
    node_ids,
    *,
    eigenvalue: float | None = None,
    mode_shape: np.ndarray | None = None,          # [n, >=3]
    static_displacements: np.ndarray | None = None,  # [n, >=2]
    gp_stresses: np.ndarray | None = None,          # [n, 3] (sx, sy, txy)
    gp_forces: dict | None = None,   # nid -> {eid: [>=3]} (QUAD4 rows)
    cbar_axial: dict | None = None,  # eid -> axial stress
) -> None:
    """Write the BuckGNN OFP subset. ``gp_stresses`` rows are emitted as
    the 3-row surface-stress groups Nastran produces per node (the reader
    side dedups them back, GraphCreate.py:891-906 parity)."""
    node_ids = np.asarray(node_ids, dtype=np.int64)

    def pad6(a, n_col=6):
        a = np.asarray(a, dtype=np.float32)
        out = np.zeros((a.shape[0], n_col), np.float32)
        out[:, : min(n_col, a.shape[1])] = a[:, :n_col]
        return out

    with open(path, "wb") as f:
        # file header: date + tape id (the scanner skips these; real
        # files carry the same shape of preamble)
        _write_marker(f, 3)
        _write_record(f, np.array([8, 20, 26], np.int32).tobytes())
        _write_marker(f, 7)
        _write_record(f, b"NASTRAN FORT TAPE ID CODE - ")

        if eigenvalue is not None:
            _write_record(f, b"LAMA    ")
            _write_marker(f, -1)
            _write_record(
                f, _ident(8, _TABLE_DISP, 2, 7, eigenvalue=eigenvalue)
            )
            row = np.zeros(7, np.float32)
            row[:2] = (1, 1)  # mode, extraction order
            row[2] = eigenvalue
            _write_record(f, row.tobytes())
            _write_marker(f, 0)

        if static_displacements is not None:
            _write_record(f, b"OUGV1   ")
            _write_marker(f, -1)
            _write_record(f, _ident(1, _TABLE_DISP, 1, 8))
            d = pad6(static_displacements)
            entries = np.zeros((len(node_ids), 8), np.float32)
            entries[:, 0] = np.frombuffer(
                (node_ids * 10 + _DEVICE_CODE).astype(np.int32).tobytes(),
                np.float32,
            )
            entries[:, 1] = np.frombuffer(
                np.full(len(node_ids), 1, np.int32).tobytes(), np.float32
            )
            entries[:, 2:8] = d
            _write_record(f, entries.tobytes())
            _write_marker(f, 0)

        if mode_shape is not None:
            _write_record(f, b"OUGV1   ")
            _write_marker(f, -1)
            _write_record(f, _ident(8, _TABLE_EIGENVECTOR, 2, 8, mode=1,
                                    eigenvalue=float(eigenvalue or 0.0)))
            m = pad6(mode_shape)
            entries = np.zeros((len(node_ids), 8), np.float32)
            entries[:, 0] = np.frombuffer(
                (node_ids * 10 + _DEVICE_CODE).astype(np.int32).tobytes(),
                np.float32,
            )
            entries[:, 1] = np.frombuffer(
                np.full(len(node_ids), 1, np.int32).tobytes(), np.float32
            )
            entries[:, 2:8] = m
            _write_record(f, entries.tobytes())
            _write_marker(f, 0)

        if gp_stresses is not None:
            _write_record(f, b"OGS1    ")
            _write_marker(f, -1)
            _write_record(f, _ident(1, _TABLE_GPSTRESS, 1, 10))
            gs = np.asarray(gp_stresses, np.float32)
            n = gs.shape[0]
            # 3 identical rows per node (Z1/Z2/MID surface group)
            entries = np.zeros((3 * n, 10), np.float32)
            ids = np.repeat(node_ids, 3) * 10 + _DEVICE_CODE
            entries[:, 0] = np.frombuffer(
                ids.astype(np.int32).tobytes(), np.float32
            )
            entries[:, 1] = np.frombuffer(
                np.tile(np.arange(3, dtype=np.int32), n).tobytes(),
                np.float32,
            )
            entries[:, 2:5] = np.repeat(gs[:, :3], 3, axis=0)
            _write_record(f, entries.tobytes())
            _write_marker(f, 0)

        if gp_forces:
            _write_record(f, b"OGPFB1  ")
            _write_marker(f, -1)
            _write_record(f, _ident(1, _TABLE_GPFORCE, 1, 10))
            rows = []
            for nid, per_elem in sorted(gp_forces.items()):
                for eid, force in sorted(per_elem.items()):
                    fx = np.zeros(3, np.float32)
                    fr = np.asarray(force, np.float32).reshape(-1)
                    fx[: min(3, fr.size)] = fr[:3]
                    rows.append((int(nid), int(eid), b"QUAD4   ", fx))
            entries = bytearray()
            for nid, eid, name, fx in rows:
                entries += struct.pack("<ii", nid * 10 + _DEVICE_CODE, eid)
                entries += name
                entries += fx.tobytes()
                entries += struct.pack("<fff", 0.0, 0.0, 0.0)  # moments
            _write_record(f, bytes(entries))
            _write_marker(f, 0)

        if cbar_axial:
            _write_record(f, b"OES1X1  ")
            _write_marker(f, -1)
            _write_record(
                f, _ident(1, _TABLE_OES, 1, 16, element_type=_ELEM_CBAR)
            )
            entries = np.zeros((len(cbar_axial), 16), np.float32)
            eids = np.array(sorted(cbar_axial), np.int64)
            entries[:, 0] = np.frombuffer(
                (eids * 10 + _DEVICE_CODE).astype(np.int32).tobytes(),
                np.float32,
            )
            entries[:, 5] = [cbar_axial[int(e)] for e in eids]
            _write_record(f, entries.tobytes())
            _write_marker(f, 0)


# ------------------------------ reader ----------------------------- #


def read_op2(path: str):
    """Parse the OFP subset into an object with pyNastran's attribute
    layout (eigenvectors / displacements / grid_point_surface_stresses /
    grid_point_forces / cbar_stress result dicts), so
    `graph.mesh.extract_op2_results` consumes either reader unchanged."""
    out = SimpleNamespace(
        eigenvectors={}, displacements={},
        grid_point_surface_stresses={}, grid_point_forces={},
        cbar_stress={},
    )
    lama_eigs: list[float] = []

    table = None
    pending_ident: np.ndarray | None = None
    pending_data: list[bytes] = []
    # True when a marker has passed since an undischarged IDENT: the
    # next IDENT-sized record is then a NEW ident (the old one had an
    # empty body), not this table's first data record
    ident_stale = False

    def flush(discard_ident=False):
        # a large table may be split across SEVERAL consecutive DATA
        # records (real Nastran splits long tables; one IDENT still
        # governs them all) — concatenate everything accumulated since
        # the IDENT and parse it as one table body. An IDENT with no
        # DATA yet survives a plain flush (markers can legitimately sit
        # between an IDENT and its DATA); it is only discarded at a
        # table boundary / EOF (where keeping it would mis-attach the
        # next table's records) or when a fresh IDENT supersedes it
        # after a marker (empty-body subtables).
        nonlocal pending_ident, pending_data
        if pending_ident is not None and pending_data:
            _read_data(out, lama_eigs, table, pending_ident,
                       b"".join(pending_data))
            pending_ident, pending_data = None, []
        elif discard_ident:
            pending_ident = None

    for rec in _iter_records(path):
        if len(rec) == 8 and rec in _TABLE_NAMES:
            flush(discard_ident=True)
            ident_stale = False
            table = rec.rstrip().decode()
            continue
        if len(rec) == 4:
            flush()  # marker record closes a completed IDENT/DATA group
            ident_stale = pending_ident is not None
            continue
        if table is None:
            continue  # file preamble
        if len(rec) == 4 * _IDENT_WORDS and (pending_ident is None
                                             or ident_stale):
            pending_ident = np.frombuffer(rec, np.int32)
            ident_stale = False
            continue
        if pending_ident is None:
            continue  # data record of a table we never identified
        # once the IDENT has data, it is no longer a marker-stale
        # candidate: a later IDENT-sized record is a continuation chunk
        # of THIS body (splits can land on any boundary), not a new ident
        ident_stale = False
        pending_data.append(rec)
    flush(discard_ident=True)

    if lama_eigs:
        for ev in out.eigenvectors.values():
            ev.eigrs = list(lama_eigs)
    return out


def _read_data(out, lama_eigs, table, ident, rec):
    table_code = int(ident[_W_TABLE])
    isubcase = int(ident[_W_SUBCASE])
    num_wide = int(ident[_W_NUMWIDE])
    eig = struct.unpack("<f", ident[_W_EIGN: _W_EIGN + 1].tobytes())[0]

    if table == "LAMA":
        rows = np.frombuffer(rec, np.float32).reshape(-1, 7)
        lama_eigs.extend(float(v) for v in rows[:, 2])
        return
    if num_wide <= 0 or len(rec) % (4 * num_wide):
        raise ValueError(
            f"{table}: data record length {len(rec)} is not a multiple of "
            f"num_wide {num_wide}"
        )
    fdata = np.frombuffer(rec, np.float32).reshape(-1, num_wide)
    idata = np.frombuffer(rec, np.int32).reshape(-1, num_wide)

    if table == "OUGV1":
        node_ids = idata[:, 0] // 10
        obj = SimpleNamespace(
            node_gridtype=np.stack([node_ids, idata[:, 1]], axis=1),
            data=fdata[None, :, 2:8].astype(np.float64),
        )
        if table_code == _TABLE_EIGENVECTOR:
            obj.eigrs = [float(eig)]
            out.eigenvectors[isubcase] = obj
        else:
            out.displacements[isubcase] = obj
    elif table == "OGS1":
        out.grid_point_surface_stresses[isubcase] = SimpleNamespace(
            node=idata[:, 0] // 10,
            data=fdata[None, :, 2:].astype(np.float64),
        )
    elif table == "OGPFB1":
        names = [
            rec[i * 4 * num_wide + 8: i * 4 * num_wide + 16]
            .decode().strip()
            for i in range(fdata.shape[0])
        ]
        out.grid_point_forces[isubcase] = SimpleNamespace(
            node_element=np.stack(
                [idata[:, 0] // 10, idata[:, 1]], axis=1)[None],
            element_names=[names],
            data=fdata[None, :, 4:10].astype(np.float64),
        )
    elif table == "OES1X1" and int(ident[_W_ELTYPE]) == _ELEM_CBAR:
        out.cbar_stress[isubcase] = SimpleNamespace(
            element=idata[:, 0] // 10,
            data=fdata[None, :, 1:].astype(np.float64),
        )
