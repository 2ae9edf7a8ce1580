"""The port's folder-dataset layer against the JAX package, bit for bit.

`graph/mesh.py`'s BDF reader and writer, `graph/op2.py`, `graph/io.py`'s
dataset cache and `graph/folder.py` are NumPy copies of the JAX
package's: the same inputs must give the same arrays (``np.array_equal``
and the same dtypes), the same bytes on disk and the same errors. The
folders come from the port's ``datagen`` (4 models x 2 loadcases), which
must write the JAX command's bytes.
"""

import dataclasses
import filecmp
import json
import os
import struct
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import buckgnn_tpu.cli as jcli
import buckgnn_tpu.config as jconfig
import buckgnn_tpu.graph.folder as jfolder
import buckgnn_tpu.graph.io as jio
import buckgnn_tpu.graph.mesh as jmesh
import buckgnn_tpu.graph.op2 as jop2
import buckgnn_tpu.graph.synthetic as jsyn
import buckgnn_tpu_torch.cli as tcli
import buckgnn_tpu_torch.config as tconfig
import buckgnn_tpu_torch.graph.folder as tfolder
import buckgnn_tpu_torch.graph.io as tio
import buckgnn_tpu_torch.graph.mesh as tmesh
import buckgnn_tpu_torch.graph.op2 as top2
import buckgnn_tpu_torch.graph.synthetic as tsyn
from tests.torch_port_compare import both, same

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "reference_small_field.bdf")


# ------------------------------- BDF --------------------------------- #

LARGE_FIELD = (
    "BEGIN BULK\n"
    "GRID*   " + "7".ljust(16) + "".ljust(16) + "12.5".ljust(16) + "-3.\n"
    + "*       " + "4.75\n"
    "GRID,8,,1.,2.,3.\n"
    "CQUAD4,1,1,7,8,7,8\n"
    "ENDDATA\n"
)
FOREIGN = (
    "SOL 105\nCEND\nBEGIN BULK\n"
    "PARAM,POST,-1\n"
    "CORD2R,5,,0.,0.,0.,0.,0.,1.,1.,0.,0.\n"
    "MAT1,1,76000.,,0.3\n"
    "GRID,1,,0.,0.,0.\n"
    "GRID*   " + "2".ljust(16) + "".ljust(16) + "100.".ljust(16)
    + "0.".ljust(16) + "\n" + "*       " + "0.".ljust(16) + "\n"
    "GRID,3,,100.,100.,0.\n"
    "GRID,4,,0.,100.,0.\n"
    "CQUAD4,10,1,1,2,3,4\n"
    "CTRIA3,11,1,1,2,3\n"
    "CBAR,12,900,1,3,0.,0.,1.\n"
    "SPCADD,100,1,2\n"
    "SPC1,1,123456,1,4\n"
    "PLOAD4,3,10,-0.1\n"
    "FORCE,2,2,,1.,1000.,0.,0.\n"
    "ENDDATA\n"
)
MALFORMED = "BEGIN BULK\nGRID,1,,0.,0.,0.\nCQUAD4,10,1,1,TWO,3,4\nENDDATA\n"


@pytest.mark.parametrize("deck", ["fixture", "large_field", "foreign",
                                  "malformed"])
def test_read_bdf_matches_jax(deck, tmp_path):
    path = FIXTURE
    if deck != "fixture":
        path = str(tmp_path / f"{deck}.bdf")
        with open(path, "w") as f:
            f.write({"large_field": LARGE_FIELD, "foreign": FOREIGN,
                     "malformed": MALFORMED}[deck])
    got = []
    for mod in (jmesh, tmesh):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                got.append(("ok", mod.read_bdf(path)))
            except ValueError as e:
                got.append(("raise", str(e)))
        got[-1] += ([str(w.message) for w in rec],)
    assert got[0][0] == got[1][0] == ("raise" if deck == "malformed"
                                      else "ok")
    same(got[0][1], got[1][1])
    assert got[0][2] == got[1][2]  # the skipped-card warning
    assert bool(got[1][2]) == (deck in ("fixture", "foreign"))


def test_write_bdf_bytes_match_jax(tmp_path):
    """The same deck, byte for byte, for a mesh with trias, stiffeners,
    SPCs and forces."""
    mesh = tsyn.generate_mesh(seed=3, min_side=4, max_side=5,
                              with_stiffeners=True)
    mesh.trias = np.array([[0, 1, 2]], np.int32)
    assert len(mesh.cbars) and mesh.spc_components and mesh.forces
    jm = jmesh.MeshModel(**dataclasses.asdict(mesh))
    jmesh.write_bdf(jm, str(tmp_path / "j.bdf"), eigrl_nd=2)
    tmesh.write_bdf(mesh, str(tmp_path / "t.bdf"), eigrl_nd=2)
    assert filecmp.cmp(tmp_path / "j.bdf", tmp_path / "t.bdf", shallow=False)
    same(jmesh.read_bdf(str(tmp_path / "j.bdf")),
          tmesh.read_bdf(str(tmp_path / "t.bdf")))


# ------------------------------- OP2 --------------------------------- #

def _rec(payload: bytes, fmt="<i") -> bytes:
    return (struct.pack(fmt, len(payload)) + payload
            + struct.pack(fmt, len(payload)))


def _ident(analysis_code, table_code, isubcase, num_wide, mode=0,
           eigenvalue=0.0) -> bytes:
    words = [0] * 146
    words[0], words[1], words[3] = analysis_code * 10 + 1, table_code, isubcase
    words[4], words[9] = mode, num_wide
    buf = b"".join(struct.pack("<i", w) for w in words)
    return buf[:20] + struct.pack("<f", eigenvalue) + buf[24:]


def _entry(*fields) -> bytes:
    return b"".join(struct.pack("<i", f) if isinstance(f, int)
                    else struct.pack("<f", f) for f in fields)


def _mark(v):
    return _rec(struct.pack("<i", v))


EIG_ROW = _entry(11, 1, 0.1, 0.2, 1.5, 0.0, 0.0, 0.0)
_BODY = b"".join(_entry(i * 10 + 1, 1, 0.1 * i, 0.2 * i, 1.5, 0.0, 0.0, 0.0)
                 for i in range(1, 20))
BROKEN_OP2 = {
    # the error and edge cases of tests/test_op2.py
    "not_op2": b"not an op2 file at all..",
    "truncated": struct.pack("<i", 1000) + b"\0" * 10,
    "big_endian": _rec(b"LAMA    " + b"\0" * 4, ">i"),
    "fences_64bit": _rec(b"LAMA    ", "<q"),
    "marker_between_ident_and_data": (
        _rec(b"LAMA    ") + _mark(-1)
        + _rec(_ident(8, 1, 2, 7, eigenvalue=7.25))
        + _mark(-2) + _rec(_entry(1.0, 1.0, 7.25, 0.0, 0.0, 0.0, 0.0))
        + _mark(0) + _rec(b"OUGV1   ") + _mark(-1)
        + _rec(_ident(8, 7, 2, 8, mode=1, eigenvalue=7.25)) + _mark(-3)
        + _rec(EIG_ROW) + _mark(0)),
    "empty_body": (
        _rec(b"OUGV1   ") + _mark(-1)
        + _rec(_ident(8, 7, 1, 8, mode=1, eigenvalue=7.25)) + _mark(-2)
        + _rec(_ident(8, 7, 2, 8, mode=1, eigenvalue=7.25)) + _rec(EIG_ROW)
        + _mark(0)),
    # a body split after a marker into a 24-byte chunk and an IDENT-sized
    # (584-byte) one, which must not parse as a new IDENT
    "ident_sized_continuation": (
        _rec(b"OUGV1   ") + _mark(-1)
        + _rec(_ident(8, 7, 2, 8, mode=1, eigenvalue=7.25)) + _mark(-2)
        + _rec(_BODY[:24]) + _rec(_BODY[24:]) + _mark(0)),
}


@pytest.fixture(scope="module")
def op2_case(tmp_path_factory):
    """A datagen mesh's results written by both packages' write_op2."""
    d = tmp_path_factory.mktemp("op2")
    mesh = tsyn.generate_mesh(seed=11, min_side=4, max_side=5,
                              with_stiffeners=True)
    fea = tsyn.fake_fea(mesh, 11)
    rng = np.random.default_rng(5)
    fea.gp_stresses = rng.normal(size=(mesh.n_node, 3)).astype(np.float32)
    fea.cbar_axial = {int(e): float(rng.normal())
                      for e in np.asarray(mesh.cbar_ids)[:3]}
    kw = dict(eigenvalue=fea.eigenvalue, mode_shape=fea.mode_shape,
              static_displacements=fea.static_displacements,
              gp_stresses=fea.gp_stresses, gp_forces=fea.gp_forces,
              cbar_axial=fea.cbar_axial)
    jop2.write_op2(str(d / "j.op2"), mesh.node_ids, **kw)
    top2.write_op2(str(d / "t.op2"), mesh.node_ids, **kw)
    return d


def test_write_op2_bytes_and_read_match_jax(op2_case):
    d = op2_case
    assert filecmp.cmp(d / "j.op2", d / "t.op2", shallow=False)
    same(jop2.read_op2(str(d / "j.op2")), top2.read_op2(str(d / "t.op2")))
    same(jmesh.read_op2_results(str(d / "j.op2")),
          tmesh.read_op2_results(str(d / "t.op2")))


@pytest.mark.parametrize("case", [*BROKEN_OP2, "foreign_tables"])
def test_read_op2_error_cases_match_jax(case, op2_case, tmp_path):
    if case == "foreign_tables":
        foreign = (_rec(b"GEOM1   ") + _mark(-1)
                   + _rec(np.arange(64, dtype=np.int32).tobytes()) + _mark(0))
        blob = foreign + (op2_case / "t.op2").read_bytes() + foreign
    else:
        blob = BROKEN_OP2[case]
    p = tmp_path / f"{case}.op2"
    p.write_bytes(blob)
    kind, _ = both("read_op2", (jop2, top2), str(p))
    assert kind == ("raise" if case in ("not_op2", "truncated", "big_endian",
                                        "fences_64bit") else "ok")


def test_extract_op2_results_and_unique_groups_match_jax():
    """The extraction from a pyNastran-shaped object, with duplicate
    stress triplets, CBAR stresses and grid-point forces."""
    rng = np.random.default_rng(0)
    gps = rng.normal(size=(12, 5))
    gps[6:9] = gps[0:3]  # a duplicate group
    op2 = SimpleNamespace(
        eigenvectors={2: SimpleNamespace(eigrs=[12.5],
                                         data=rng.normal(size=(1, 4, 6)))},
        displacements={1: SimpleNamespace(data=rng.normal(size=(1, 4, 6)))},
        grid_point_surface_stresses={1: SimpleNamespace(data=gps[None])},
        cbar_stress={1: SimpleNamespace(element=np.array([101, 102]),
                                        data=rng.normal(size=(1, 2, 8)))},
        grid_point_forces={1: SimpleNamespace(
            element_names=[["QUAD4", "BAR", "QUAD4"]],
            node_element=[[(1, 11), (1, 55), (2, 11)]],
            data=[rng.normal(size=(3, 6))])},
    )
    same(jmesh.extract_op2_results(op2), tmesh.extract_op2_results(op2))
    both("_make_unique_groups", (jmesh, tmesh), gps[:10])  # not % 3: raise


# --------------------------- folder datasets -------------------------- #

@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The port's datagen folder (4 models x 2 loadcases, stiffeners and
    cutouts), beside the JAX command's."""
    root = tmp_path_factory.mktemp("cases")
    argv = ["datagen", "--n-models", "4", "--loadcases-per-model", "2",
            "--stiffeners", "--cutouts", "--seed", "3"]
    assert tcli.main(argv + ["--out-dir", str(root / "t")]) == 0
    assert jcli.main(argv + ["--out-dir", str(root / "j")]) == 0
    return root


def test_datagen_folder_bytes_match_jax(cases):
    names = sorted(os.listdir(cases / "t"))
    assert len(names) == 16 and names == sorted(os.listdir(cases / "j"))
    for n in names:
        if n.endswith(".bdf"):
            assert filecmp.cmp(cases / "t" / n, cases / "j" / n,
                               shallow=False), n
        else:  # npz members: the zip stamps times, so compare contents
            same(dict(np.load(cases / "j" / n)),
                  dict(np.load(cases / "t" / n)), n)
        same(jfolder.load_fea_npz(str(cases / "j" / n))
              if n.endswith(".npz") else None,
              tfolder.load_fea_npz(str(cases / "t" / n))
              if n.endswith(".npz") else None)


def _graphs_equal(jgs, tgs):
    assert len(jgs) == len(tgs)
    for i, (a, b) in enumerate(zip(jgs, tgs)):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        if fa["file_path"] is not None:  # the two folders' paths
            assert os.path.basename(fa.pop("file_path")) == \
                os.path.basename(fb.pop("file_path"))
        same(fa, fb, f"graph {i}")


@pytest.mark.parametrize("super_node", [False, True])
def test_load_folder_dataset_matches_jax(cases, super_node, tmp_path):
    """Every array of every graph, raw and normalized, the fitted
    normalizer's statistics, the apply path, and the cache file each
    package writes, loaded in the other."""
    kw = dict(use_super_node=super_node)
    out = {}
    for tag, folder, config in (("j", jfolder, jconfig), ("t", tfolder,
                                                          tconfig)):
        d = tmp_path / tag
        d.mkdir()
        for n in os.listdir(cases / "j"):
            os.link(cases / "j" / n, d / n)
        cfg = config.DataConfig(**kw)
        normed, nz = folder.load_folder_dataset(str(d), data_cfg=cfg)
        applied, _ = folder.load_folder_dataset(str(d), normalizer=nz,
                                                data_cfg=cfg)
        nz.save(str(tmp_path / f"{tag}_nz.npz"))
        out[tag] = normed, applied, str(d / "dataset_cache_buckling.npz")
    for k in (0, 1):
        _graphs_equal(out["j"][k], out["t"][k])
    same(dict(np.load(tmp_path / "j_nz.npz")),
          dict(np.load(tmp_path / "t_nz.npz")))
    # the caches cross both ways
    _graphs_equal(jio.load_dataset_file(out["t"][2]),
                  tio.load_dataset_file(out["j"][2]))
    _graphs_equal(tio.load_dataset_file(out["t"][2]),
                  jio.load_dataset_file(out["j"][2]))
    assert len(out["t"][0]) == 8
    assert all((g.supernode >= 0) == super_node for g in out["t"][0])


def test_dataset_cache_with_mode_shapes_and_node_targets_crosses(tmp_path):
    """The optional members: node-level targets and mode shapes."""
    graphs = tsyn.generate_dataset(3, seed=4, prediction_type="mode_shape")
    for i, g in enumerate(graphs):
        g.mode_shapes = np.full((g.n_node, 3), i, np.float32)
    tio.save_dataset(graphs, str(tmp_path / "t.npz"))
    jgraphs = [jsyn.GraphData(**dataclasses.asdict(g)) for g in graphs]
    jio.save_dataset(jgraphs, str(tmp_path / "j.npz"))
    same(dict(np.load(tmp_path / "j.npz")), dict(np.load(tmp_path / "t.npz")))
    _graphs_equal(jio.load_dataset_file(str(tmp_path / "t.npz")),
                  tio.load_dataset_file(str(tmp_path / "j.npz")))
    assert tio.dataset_cache_path("d", "static_stress") == \
        jio.dataset_cache_path("d", "static_stress")


def test_quarantine_log_matches_jax(tmp_path):
    """A pair whose results have another node count is moved aside and
    logged the same way; the good pair loads the same."""
    mesh = tsyn.generate_mesh(seed=1, min_side=4, max_side=4)
    other = tsyn.generate_mesh(seed=2, min_side=6, max_side=6)
    logs = {}
    for tag, folder in (("j", jfolder), ("t", tfolder)):
        d = tmp_path / tag
        d.mkdir()
        tmesh.write_bdf(mesh, str(d / "good.bdf"))
        tfolder.save_fea_npz(tsyn.fake_fea(mesh, seed=1),
                             str(d / "good.fea.npz"))
        tmesh.write_bdf(mesh, str(d / "bad.bdf"))
        tfolder.save_fea_npz(tsyn.fake_fea(other, seed=2),
                             str(d / "bad.fea.npz"))
        ds, _ = folder.load_folder_dataset(str(d), use_cache=False,
                                           processes=1, normalize=False)
        logs[tag] = (ds, sorted(os.listdir(d / "problematic_files")),
                     json.loads((d / "problematic_files"
                                 / "problems.json").read_text()))
    _graphs_equal(logs["j"][0], logs["t"][0])
    assert logs["j"][1] == logs["t"][1] == ["bad.bdf", "bad.fea.npz",
                                            "problems.json"]
    for e in logs.values():
        for entry in e[2]:
            entry.pop("time")
    assert logs["j"][2] == logs["t"][2]
    assert "mismatch" in logs["t"][2][0]["reason"]


def test_process_pool_load_matches_jax_serial(tmp_path):
    """More than 8 pairs load through the port's forked process pool, in
    the order of the files, as the JAX package loads them one by one."""
    argv = ["datagen", "--n-models", "5", "--loadcases-per-model", "2",
            "--seed", "7", "--out-dir", str(tmp_path)]
    assert tcli.main(argv) == 0
    pooled, _ = tfolder.load_folder_dataset(str(tmp_path), processes=2,
                                            use_cache=False, normalize=False)
    serial, _ = jfolder.load_folder_dataset(str(tmp_path), processes=1,
                                            use_cache=False, normalize=False)
    assert len(pooled) == 10
    _graphs_equal(serial, pooled)
