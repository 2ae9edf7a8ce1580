"""The port's data generation against the JAX package, bit for bit.

`datagen/` is a NumPy copy of the JAX package's: shapes, loadcases,
stiffener groups and the solver runner draw from a seeded
``numpy.random.Generator`` in the same order, so every mesh, loadcase and
repaired deck must equal the JAX one exactly.
"""

import stat
import textwrap

import numpy as np
import pytest

import buckgnn_tpu.datagen.loadcases as jlc
import buckgnn_tpu.datagen.runner as jrun
import buckgnn_tpu.datagen.shapes as jshapes
import buckgnn_tpu.graph.synthetic as jsyn
import buckgnn_tpu_torch.datagen as tdatagen
import buckgnn_tpu_torch.datagen.loadcases as tlc
import buckgnn_tpu_torch.datagen.runner as trun
import buckgnn_tpu_torch.datagen.shapes as tshapes
import buckgnn_tpu_torch.graph.synthetic as tsyn
from tests.torch_port_compare import both, same


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cutouts", [False, True])
def test_generate_shape_mesh_matches_jax(seed, cutouts):
    kw = dict(seed=seed)
    meshes = [mod.generate_shape_mesh(
        cfg=mod.ShapeConfig(with_cutouts=cutouts), **kw)
        for mod in (jshapes, tshapes)]
    same(*meshes)
    assert meshes[1].n_node > 0


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("stiffeners", [False, True])
def test_generate_model_cases_matches_jax(seed, stiffeners):
    """The whole chain the datagen command runs: shape, loadcases (with
    the oracle's stresses for classification and acceptance), stiffener
    groups."""
    out = []
    for lc, shapes, syn in ((jlc, jshapes, jsyn), (tlc, tshapes, tsyn)):
        mesh = shapes.generate_shape_mesh(seed=seed)
        cfg = lc.LoadcaseConfig(loadcases_per_model=3,
                                generate_stiffeners=stiffeners)
        out.append(lc.generate_model_cases(
            mesh, lambda m, s=syn: s.fake_fea(m, seed=seed), seed=seed,
            cfg=cfg))
    same(*out)
    assert out[1] and (not stiffeners or any(
        len(c.cbars) for c in out[1]))


def test_loadcase_pieces_match_jax():
    """The boundary trace, one loadcase draw, the stiffener candidates and
    a group, classification and acceptance, on one mesh."""
    mesh = tsyn.generate_mesh(seed=4, min_side=8, max_side=8)
    for name in ("trace_outer_boundary", "stiffener_candidates"):
        both(name, (jlc, tlc), mesh)
    draws = []
    for lc in (jlc, tlc):
        rng = np.random.default_rng(9)
        cfg = lc.LoadcaseConfig(min_active_stiffeners=5,
                                max_active_stiffeners=20)
        cands = lc.stiffener_candidates(mesh)
        draws.append((lc.generate_loadcase(mesh, rng, cfg),
                      lc.activate_stiffener_group(cands, mesh.coords, rng,
                                                  cfg),
                      [lc.should_accept_loadcase(t, ratio, rng, cfg)
                       for t in lc.LoadcaseType
                       for ratio in (None, 2.0, 5.0, 20.0)],
                      rng.integers(1 << 30)))
    same(*draws)
    stresses = tsyn.fake_fea(mesh, seed=2).gp_stresses
    kinds = {both("classify_loadcase", (jlc, tlc), s)[1].name
             for s in (stresses, -stresses, stresses * [1, -1, 1],
                       stresses * [0, 0, 1])}
    assert len(kinds) > 1
    assert tdatagen.generate_model_cases is tlc.generate_model_cases


_BDF_WITH_ORPHAN = textwrap.dedent("""\
    SOL 105
    CEND
    BEGIN BULK
    GRID           1            0.0     0.0     0.0
    GRID           2          100.0     0.0     0.0
    GRID           3          100.0   100.0     0.0
    GRID           4            0.0   100.0     0.0
    GRID           9          999.0   999.0     0.0
    CQUAD4         1       1       1       2       3       4
    EIGRL          1                      10
    MAT1           4  70000.              .3
    ENDDATA
""")


@pytest.mark.parametrize("eigrl_nd", [1, 3])
def test_fix_bdf_text_matches_jax(eigrl_nd):
    lines = _BDF_WITH_ORPHAN.splitlines(keepends=True)
    both("find_orphan_nodes", (jrun, trun), lines)
    fixed = both("fix_bdf_text", (jrun, trun), lines, eigrl_nd=eigrl_nd)[1]
    assert fixed[1] and "GRID           9" not in "".join(fixed[0])


def test_solver_runner_with_stub_matches_jax(tmp_path):
    """Both runners against a stub solver that writes an .op2 (and one
    that fails): the same outputs, repaired decks and failure records."""
    ok = tmp_path / "fakesolver.sh"
    ok.write_text("#!/bin/sh\ncp \"$1\" \"${1%.bdf}.op2\"\n"
                  "touch \"${1%.bdf}.log\"\n")
    bad = tmp_path / "failsolver.sh"
    bad.write_text("#!/bin/sh\nexit 3\n")
    for stub in (ok, bad):
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    got = {}
    for tag, run in (("j", jrun), ("t", trun)):
        for stub in (ok, bad):
            d = tmp_path / f"{tag}_{stub.stem}"
            d.mkdir()
            for i in range(3):
                (d / f"model_{i}.bdf").write_text(_BDF_WITH_ORPHAN)
            runner = run.SolverRunner(run.RunnerConfig(
                solver_cmd=f"{stub} {{bdf}}", max_workers=2))
            op2s = runner.process_directory(str(d))
            got[tag, stub.stem] = (
                sorted(p.replace(str(d), "") for p in op2s),
                sorted(p.name for p in d.iterdir()),
                (d / "model_0.bdf").read_text(),
                len(runner.failures))
    for stub in (ok, bad):
        assert got["j", stub.stem] == got["t", stub.stem]
    assert len(got["t", "fakesolver"][0]) == 3
    assert got["t", "failsolver"][3] == 3
