"""The port's C++ host-ETL kernels (csrc/native.cpp via utils/native.py).

The six tests of tests/test_native.py on the port (the library builds,
shell edges, RCM, the band fraction, RCM's meaning), then the port held to
the JAX package: both libraries are built here with g++ from their own
copies of the source, and on the same graphs (random and grid graphs with
self-loops, negative and out-of-range ids, from a numpy seed) give the
same permutations, fractions and edge arrays; the port's native paths
equal its NumPy fallbacks; `build_graph` equals the JAX one bit for bit;
and two threads that load the library at once start one g++.
"""

import os
import stat
import threading
import types

import numpy as np
import pytest

import buckgnn_tpu.graph.build as jbuild
import buckgnn_tpu.graph.synthetic as jsyn
from buckgnn_tpu.utils import native as jnative
from buckgnn_tpu_torch.graph import build as tbuild
from buckgnn_tpu_torch.graph import synthetic as tsyn
from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.build import (
    _shell_edges_numpy, build_graph, rcm_reorder, shell_edges,
)
from buckgnn_tpu_torch.graph.mesh import MeshModel
from buckgnn_tpu_torch.graph.synthetic import (
    fake_fea, generate_dataset, generate_mesh,
)
from buckgnn_tpu_torch.utils import cuda_build, native
from tests.torch_port_compare import same

N_CASES = 20


def _numpy_shell_edges(mesh):
    pairs = []
    for conn in (mesh.quads, mesh.trias):
        if len(conn) == 0:
            continue
        k = conn.shape[1]
        for i in range(k):
            a, b = conn[:, i], conn[:, (i + 1) % k]
            pairs.append(
                np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)
            )
    allp = np.concatenate(pairs)
    return np.unique(allp, axis=0, return_counts=True)


def test_native_library_builds():
    assert native.available(), "g++ is on the path; the build must work"
    lib = native.lib_path()
    assert lib.startswith(cuda_build.BUILD_DIR) and os.path.exists(lib)


def test_shell_edges_native_matches_numpy():
    mesh = generate_mesh(seed=3, min_side=6, max_side=9)
    got_pairs, got_counts = native.shell_edges_native(mesh.quads, mesh.trias)
    exp_pairs, exp_counts = _numpy_shell_edges(mesh)
    np.testing.assert_array_equal(got_pairs, exp_pairs)
    np.testing.assert_array_equal(got_counts, exp_counts)


def test_shell_edges_build_path_uses_native(monkeypatch):
    calls = []
    real = native.shell_edges_native

    def spy(quads, trias):
        calls.append(len(quads))
        return real(quads, trias)

    monkeypatch.setattr(native, "shell_edges_native", spy)
    mesh = generate_mesh(seed=5, min_side=5, max_side=7)
    pairs, counts = shell_edges(mesh)
    exp_pairs, exp_counts = _numpy_shell_edges(mesh)
    np.testing.assert_array_equal(np.asarray(pairs), exp_pairs)
    np.testing.assert_array_equal(np.asarray(counts), exp_counts)
    assert calls == [len(mesh.quads)] and pairs.dtype == np.int64


def test_rcm_is_permutation_and_matches_fallback_coverage():
    rng = np.random.default_rng(0)
    n = 200
    # path graph shuffled to a random labeling: RCM must recover near-
    # optimal bandwidth (exactly 1 for a path).
    relabel = rng.permutation(n)
    s = relabel[np.arange(n - 1)]
    r = relabel[np.arange(1, n)]
    for impl in ("native", "numpy"):
        if impl == "native":
            perm = native.rcm_order(n, s, r)
        else:
            perm = native._rcm_order_numpy(n, s, r)
        assert sorted(perm.tolist()) == list(range(n))
        pos = np.empty(n, dtype=np.int64)
        pos[perm] = np.arange(n)
        bw = int(np.max(np.abs(pos[s] - pos[r])))
        assert bw <= 2, f"{impl} RCM bandwidth {bw} on a path"


def test_band_fraction_improves_with_rcm():
    rng = np.random.default_rng(1)
    mesh = generate_mesh(seed=7, min_side=12, max_side=12)
    # scramble node order like an arbitrary-order BDF would
    perm = rng.permutation(mesh.n_node)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(mesh.n_node)
    scrambled = MeshModel(
        coords=mesh.coords[perm],
        node_ids=mesh.node_ids[perm],
        quads=inv[mesh.quads],
        quad_ids=mesh.quad_ids,
        trias=inv[mesh.trias] if len(mesh.trias) else mesh.trias,
        cbars=inv[mesh.cbars] if len(mesh.cbars) else mesh.cbars,
        cbar_ids=mesh.cbar_ids,
        cbar_pids=mesh.cbar_pids,
        spc_components={int(inv[k]): v for k, v in mesh.spc_components.items()},
        forces={int(inv[k]): v for k, v in mesh.forces.items()},
    )
    res = fake_fea(mesh, seed=7)
    res2 = type(res)(
        eigenvalue=res.eigenvalue,
        static_displacements=res.static_displacements[perm],
        gp_stresses=res.gp_stresses[perm],
        mode_shape=res.mode_shape[perm] if res.mode_shape is not None else None,
        gp_forces=res.gp_forces,
        cbar_axial=res.cbar_axial,
    )
    g = build_graph(scrambled, res2, use_virtual_edges=False)
    n = g.n_node
    ident = np.arange(n)
    frac_before = native.band_fraction(
        g.senders, g.receivers, ident, n, tile=64, width=32
    )
    g2 = rcm_reorder(g)
    frac_after = native.band_fraction(
        g2.senders, g2.receivers, ident, n, tile=64, width=32
    )
    assert frac_after > frac_before + 0.2
    assert frac_after > 0.9


def test_rcm_reorder_preserves_graph_semantics():
    (g,) = generate_dataset(1, seed=11, min_side=6, max_side=6,
                            use_super_node=True, use_virtual_edges=False)
    g2 = rcm_reorder(g)
    # supernode still last, indicator column still correct
    assert g2.supernode == g.supernode == g.n_node - 1
    np.testing.assert_array_equal(g2.x[:, -1], g.x[:, -1])
    # degree sequence is permutation-invariant
    assert sorted(np.bincount(g.receivers, minlength=g.n_node).tolist()) == \
        sorted(np.bincount(g2.receivers, minlength=g2.n_node).tolist())
    # node feature multiset preserved
    a = np.sort(g.x.sum(axis=1))
    b = np.sort(g2.x.sum(axis=1))
    np.testing.assert_allclose(a, b, rtol=1e-6)
    # edges map to the same coordinate pairs: compare sorted edge-length sets
    def lengths(gr):
        xy = gr.x[:, :2]
        return np.sort(
            np.linalg.norm(xy[gr.senders] - xy[gr.receivers], axis=1)
        )

    np.testing.assert_allclose(lengths(g), lengths(g2), rtol=1e-5)


# ---- the port against the JAX package, and against its own fallback ----

def _case(seed):
    """(n, senders, receivers, bad senders, bad receivers, quads, trias):
    a shuffled grid (odd seeds) or a random multigraph with self-loops
    (even seeds); the bad edge list adds negative and out-of-range ids."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        a, b = (int(v) for v in rng.integers(3, 13, 2))
        n = a * b
        idx = np.arange(n).reshape(a, b)
        s = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        r = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
        lab = rng.permutation(n)
        s, r = np.concatenate([lab[s], lab[r]]), np.concatenate([lab[r], lab[s]])
    else:
        n = int(rng.integers(5, 150))
        e = int(rng.integers(0, 4 * n))
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        loops = rng.integers(0, n, max(1, e // 10))
        s, r = np.concatenate([s, loops]), np.concatenate([r, loops])
    k = max(1, len(s) // 8)
    bad = np.concatenate([rng.integers(-5, 0, k), rng.integers(n, n + 5, k)])
    other = rng.integers(0, n, 2 * k)
    flip = rng.random(2 * k) < 0.5
    bs = np.concatenate([s, np.where(flip, bad, other)])
    br = np.concatenate([r, np.where(flip, other, bad)])
    quads = rng.integers(0, n, (int(rng.integers(1, 3 * n)), 4))
    trias = rng.integers(0, n, (int(rng.integers(0, n)) * (seed % 3 > 0), 3))
    return n, s, r, bs, br, quads, trias


def _positions(perm):
    pos = np.empty(len(perm), dtype=np.int64)
    pos[perm] = np.arange(len(perm))
    return pos


GEOMETRIES = ((8, 4), (16, 8), (64, 32))


@pytest.mark.parametrize("seed", range(N_CASES))
def test_native_matches_jax_package(seed):
    n, s, r, bs, br, quads, trias = _case(seed)
    assert jnative.available() and native.available()
    for ss, rr in ((s, r), (bs, br)):
        same(native.rcm_order(n, ss, rr), jnative.rcm_order(n, ss, rr))
    pos = _positions(native.rcm_order(n, s, r))
    for ss, rr in ((s, r), (bs, br)):
        for p in (pos, np.arange(n)):
            for tile, width in GEOMETRIES:
                same(native.band_fraction(ss, rr, p, n, tile, width),
                     jnative.band_fraction(ss, rr, p, n, tile, width))
    same(native.shell_edges_native(quads, trias),
         jnative.shell_edges_native(quads, trias))


@pytest.mark.parametrize("seed", range(N_CASES))
def test_native_matches_fallback(seed):
    n, s, r, bs, br, quads, trias = _case(seed)
    for ss, rr in ((s, r), (bs, br)):
        same(native.rcm_order(n, ss, rr), native._rcm_order_numpy(n, ss, rr))
    pos = _positions(native.rcm_order(n, s, r))
    for p in (pos, np.arange(n)):
        for tile, width in GEOMETRIES:
            if not len(s):
                continue
            same(native.band_fraction(s, r, p, n, tile, width),
                 native._band_fraction_numpy(s, r, p, n, tile, width))
    got = native.shell_edges_native(quads, trias)
    exp = _shell_edges_numpy(types.SimpleNamespace(quads=quads, trias=trias))
    same(got, exp)


@pytest.mark.parametrize("kw", [
    dict(seed=2, use_virtual_edges=True),
    dict(seed=4, use_super_node=True, use_virtual_edges=False),
    dict(seed=6, use_gp_forces=True, use_axial_stress=True),
])
def test_build_graph_matches_jax(kw):
    seed = kw["seed"]
    meshes = [mod.generate_mesh(seed=seed, min_side=5, max_side=9,
                                with_stiffeners=True) for mod in (jsyn, tsyn)]
    results = [mod.fake_fea(m, seed=seed) for mod, m in zip((jsyn, tsyn),
                                                             meshes)]
    graphs = [mod.build_graph(m, res, **kw) for mod, m, res in zip(
        (jbuild, tbuild), meshes, results)]
    assert isinstance(graphs[1], GraphData)
    same(vars(graphs[0]), vars(graphs[1]))
    same(jbuild.shell_edges(meshes[0]), tbuild.shell_edges(meshes[1]))


def test_two_threads_start_one_gxx_build(tmp_path, monkeypatch):
    """Two threads that load the library at once start one compiler (a
    stub that counts its runs and writes its -o file after a pause). The
    stub's output is no library, so both fall back to NumPy; no temporary
    file is left behind."""
    calls = tmp_path / "calls"
    stub = tmp_path / "g++"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi\n'
        "  shift\n"
        "done\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_gxx", lambda: str(stub))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.delenv("BUCKGNN_DISABLE_NATIVE", raising=False)
    got, barrier = [], threading.Barrier(2)

    def ask():
        barrier.wait()
        got.append(native.available())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert calls.read_text().splitlines() == ["run"]
    assert got == [False, False]
    lib = native.lib_path()
    assert lib.startswith(str(tmp_path))
    assert os.listdir(tmp_path / "build") == [os.path.basename(lib)]
    # the fallback answers as the library would
    s, r = np.arange(9), np.arange(1, 10)
    same(native.rcm_order(10, s, r), native._rcm_order_numpy(10, s, r))


def test_disable_env_takes_the_fallback(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("BUCKGNN_DISABLE_NATIVE", "1")
    assert not native.available()
    mesh = generate_mesh(seed=8, min_side=4, max_side=6)
    assert native.shell_edges_native(mesh.quads, mesh.trias) is None
    pairs, counts = shell_edges(mesh)
    assert pairs.dtype == mesh.quads.dtype
    exp_pairs, exp_counts = _numpy_shell_edges(mesh)
    same((pairs, counts), (exp_pairs, exp_counts))


def test_native_refuses_malformed_arrays():
    """Arrays whose lengths would let the library read past their ends."""
    with pytest.raises(ValueError, match="3 positions for 4 nodes"):
        native.band_fraction([0, 1], [1, 2], np.arange(3), 4, 8, 4)
    with pytest.raises(ValueError, match="2 senders but 1 receivers"):
        native.band_fraction([0, 1], [1], np.arange(4), 4, 8, 4)
    with pytest.raises(ValueError, match="2 senders but 3 receivers"):
        native.rcm_order(4, [0, 1], [1, 2, 3])
