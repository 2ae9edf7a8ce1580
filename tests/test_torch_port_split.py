"""The port's split tooling, flattening and materializer against the JAX
package, bit for bit.

`graph/split.py`, `graph/flatten.py` and `graph/materialize.py` are NumPy
copies of the JAX package's (scikit-learn imported lazily for the
mode-shape families): on the same graphs they must give the same bins,
split indices, outlier masks, flattened selection and the same folders
and manifest on disk.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import buckgnn_tpu.graph.batch as jbatch
import buckgnn_tpu.graph.flatten as jflat
import buckgnn_tpu.graph.io as jio
import buckgnn_tpu.graph.materialize as jmat
import buckgnn_tpu.graph.split as jsplit
import buckgnn_tpu_torch.graph.flatten as tflat
import buckgnn_tpu_torch.graph.io as tio
import buckgnn_tpu_torch.graph.materialize as tmat
import buckgnn_tpu_torch.graph.split as tsplit
from buckgnn_tpu_torch.graph.build import build_graph
from buckgnn_tpu_torch.graph.synthetic import fake_fea, generate_mesh
from tests.torch_port_compare import both, same


def _dataset(prediction_type):
    """5 geometries x 6 loadcases (geometry groups matter for the split),
    as the port's graphs and as the JAX package's."""
    graphs = []
    for m in range(5):
        mesh = generate_mesh(m, min_side=3, max_side=5)
        for lc in range(6):
            graphs.append(build_graph(mesh, fake_fea(mesh, m * 100 + lc),
                                      seed=lc,
                                      prediction_type=prediction_type))
    return [jbatch.GraphData(**dataclasses.asdict(g)) for g in graphs], graphs


@pytest.fixture(scope="module")
def buckling():
    return _dataset("buckling")


def _sklearn():
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("prediction_type", [
    "buckling", "static_stress",
    pytest.param("mode_shape", marks=pytest.mark.skipif(
        not _sklearn(), reason="scikit-learn does not import"))])
def test_bins_outliers_and_split_match_jax(prediction_type, buckling):
    """create_bins, the family's outlier mask and the 4-pass split (with
    and without outlier removal) on the same graphs."""
    jds, tds = buckling if prediction_type == "buckling" else \
        _dataset(prediction_type)
    family = {"buckling": "buckling", "static_stress": "static",
              "mode_shape": "modeshape"}[prediction_type]
    kind, (combined, values, info) = both("create_bins", (jsplit, tsplit),
                                          tds, family)
    assert kind == "ok" and len(combined) == 30
    # the JAX function on its own graphs gives the same bins
    same(jsplit.create_bins(jds, family)[0], combined)
    detector = {"buckling": "detect_buckling_outliers",
                "static": "detect_static_outliers",
                "modeshape": "detect_modeshape_outliers"}[family]
    mask = both(detector, (jsplit, tsplit), tds)[1]
    assert mask.dtype == bool and mask.shape == (30,)
    for remove in (False, True):
        for lengths in ((0.8, 0.2), (0.6, 0.2, 0.2)):
            j = jsplit.dataset_split(jds, family, lengths, n_bins=5, seed=3,
                                     remove_outliers=remove)
            t = tsplit.dataset_split(tds, family, lengths, n_bins=5, seed=3,
                                     remove_outliers=remove)
            same(j, t)
            same(jsplit.verify_splits(j, jds, family),
                 tsplit.verify_splits(t, tds, family))


def test_geometry_groups_match_jax(buckling):
    jds, tds = buckling
    assert [jsplit.geometry_hash(g) for g in jds] == \
        [tsplit.geometry_hash(g) for g in tds]
    same(jsplit.identify_geometry_groups(jds),
         tsplit.identify_geometry_groups(tds))
    assert len(tsplit.identify_geometry_groups(tds)) == 5


@pytest.mark.parametrize("kw", [dict(samples_per_bin=2),
                                dict(target_total=12, seed=4),
                                dict(samples_per_bin=3, lower_pct=10.0,
                                     upper_pct=90.0, bin_width=0.2)])
def test_flatten_distribution_matches_jax(kw, buckling):
    jds, tds = buckling
    ev = both("scan_eigenvalues", (jflat, tflat), tds)[1]
    same(jflat.scan_eigenvalues(jds), ev)
    rng = np.random.default_rng(1)
    for values in (ev, rng.lognormal(1.0, 0.6, size=500)):
        idx, info = both("flatten_distribution", (jflat, tflat), values,
                         **kw)[1]
        assert 0 < len(idx) <= len(values)


def test_split_and_save_matches_jax(buckling, tmp_path):
    """The split folders' caches, the normalizer and the manifest, with
    the source decks copied."""
    for tag, mat, ds in (("j", jmat, buckling[0]), ("t", tmat, buckling[1])):
        ds = [dataclasses.replace(g) for g in ds]
        src = tmp_path / f"{tag}_src"
        src.mkdir()
        for i, g in enumerate(ds):
            g.file_path = str(src / f"case_{i:02d}.bdf")
            with open(g.file_path, "w") as f:
                f.write(f"$ case {i}\n")
        splits, nz, report = mat.split_and_save(
            ds, str(tmp_path / tag), lengths=(0.6, 0.2, 0.2), n_bins=5,
            seed=2, copy_source_files=True)
    assert tmat.SPLIT_NAMES == jmat.SPLIT_NAMES == ["Train", "Val", "Test"]
    j, t = tmp_path / "j", tmp_path / "t"
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    same(json.loads((j / "split_manifest.json").read_text()),
         json.loads((t / "split_manifest.json").read_text()))
    same(dict(np.load(j / "normalizer_cache.npz")),
         dict(np.load(t / "normalizer_cache.npz")))
    for name in tmat.SPLIT_NAMES:
        assert sorted(os.listdir(j / name)) == sorted(os.listdir(t / name))
        cache = "dataset_cache_buckling.npz"
        jg = jio.load_dataset_file(str(j / name / cache))
        tg = tio.load_dataset_file(str(t / name / cache))
        same([dataclasses.asdict(g) for g in jg],
             [dataclasses.asdict(g) for g in tg])
    sizes = json.loads((t / "split_manifest.json").read_text())["sizes"]
    assert sum(sizes) == 30 and len(sizes) == 3
