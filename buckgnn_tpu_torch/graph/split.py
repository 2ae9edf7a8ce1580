"""Stratified geometry-aware dataset splitting + outlier detection.

Re-implements Dataset_Preparation/DatasetSplit.py on `GraphData`:

- target-value binning per prediction type (create_bins, :371-492),
- geometry dedup via SHA-256 over normalized rounded coordinates +
  real-edge connectivity (identify_geometry_groups, :194-313),
- 4-pass assignment guaranteeing Train coverage of every bin and geometry
  with abundance-aware redistribution (dataset_split, :1069-1252),
- outlier detectors (buckling IQR 15/85 x2 :608-637; static von Mises +
  displacement magnitude :639-724; modeshape PCA + Mahalanobis + chi^2
  :725-881) — like the reference, NOT applied on the live path unless
  requested (GraphCreate.py:850-858),
- split verification stats (verify_splits, :1254-1277).

Determinism upgrade: all random choices run through a seeded Generator
(the reference uses the global numpy RNG).

A copy of buckgnn_tpu/graph/split.py, kept here so the port needs no JAX:
the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Sequence

import numpy as np

from buckgnn_tpu_torch.graph.batch import GraphData

__all__ = [
    "create_bins",
    "identify_geometry_groups",
    "dataset_split",
    "verify_splits",
    "detect_buckling_outliers",
    "detect_static_outliers",
    "detect_modeshape_outliers",
]


def _scalar_targets(dataset):
    return np.array([float(np.reshape(d.y, (-1,))[0]) for d in dataset])


def create_bins(dataset: Sequence[GraphData], prediction_type: str,
                n_bins: int = 10):
    """(combined_bins, values, bin_info) — DatasetSplit.py:371-492."""
    if prediction_type == "buckling":
        values = _scalar_targets(dataset)
        _, edges = np.histogram(values, bins="auto")
        combined = np.digitize(values, edges) - 1
        return combined, values, {"edges": edges, "values": values}

    if prediction_type in ("static", "static_disp", "static_stress"):
        disp_magnitudes, von_mises_max = [], []
        for d in dataset:
            v = d.y
            disp = v[:, :2]
            stress = v[:, -3:]
            disp_magnitudes.append(
                float(np.max(np.sqrt(np.sum(disp**2, axis=1))))
            )
            vm = np.sqrt(
                stress[:, 0] ** 2
                - stress[:, 0] * stress[:, 1]
                + stress[:, 1] ** 2
                + 3 * stress[:, 2] ** 2
            )
            von_mises_max.append(float(np.max(vm)))
        disp_magnitudes = np.array(disp_magnitudes)
        von_mises_max = np.array(von_mises_max)
        _, disp_edges = np.histogram(disp_magnitudes, bins="auto")
        _, stress_edges = np.histogram(von_mises_max, bins="auto")
        disp_bins = np.digitize(disp_magnitudes, disp_edges) - 1
        stress_bins = np.digitize(von_mises_max, stress_edges) - 1
        n_disp = len(np.unique(disp_bins))
        combined = disp_bins * n_disp + stress_bins
        return combined, (disp_magnitudes, von_mises_max), {
            "disp_edges": disp_edges, "stress_edges": stress_edges,
        }

    if prediction_type in ("modeshape", "mode_shape"):
        from sklearn.cluster import KMeans
        from sklearn.decomposition import PCA

        magnitudes, normalized = [], []
        max_len = max(d.y.size for d in dataset)
        for d in dataset:
            ms = d.y
            mags = np.sqrt(np.sum(ms**2, axis=1))
            mx = float(np.max(mags))
            magnitudes.append(mx)
            flat = (ms / (mx + 1e-8)).flatten()
            normalized.append(
                np.pad(flat, (0, max_len - flat.size))
            )
        magnitudes = np.array(magnitudes)
        normalized = np.array(normalized)
        _, mag_edges = np.histogram(magnitudes, bins="auto")
        mag_bins = np.digitize(magnitudes, mag_edges) - 1
        pca = PCA(n_components=min(5, normalized.shape[1]))
        feats = pca.fit_transform(normalized)
        km = KMeans(n_clusters=max(len(np.unique(mag_bins)), 1), n_init=10,
                    random_state=42)
        clusters = km.fit_predict(feats)
        n_mag = len(np.unique(mag_bins))
        combined = mag_bins * n_mag + clusters
        return combined, (magnitudes, feats), {
            "magnitude_edges": mag_edges, "pca": pca, "kmeans": km,
        }

    raise ValueError(f"Unknown prediction type: {prediction_type}")


def geometry_hash(data: GraphData) -> str:
    """SHA-256 geometry fingerprint (DatasetSplit.py:209-266)."""
    coords = np.round(data.x[:, :2], decimals=3)
    # virtual-edge flag is the last edge feature; real edges have 0
    real = data.edge_attr[:, -1] == 0
    s = data.senders[real]
    r = data.receivers[real]
    edge_list = sorted({(int(min(a, b)), int(max(a, b))) for a, b in zip(s, r)})

    mins = coords.min(axis=0)
    maxs = coords.max(axis=0)
    dims = maxs - mins
    normalized = (coords - mins) / (dims + 1e-8)

    conn: dict[int, list[int]] = {}
    for a, b in edge_list:
        conn.setdefault(a, []).append(b)
        conn.setdefault(b, []).append(a)
    info = [
        f"{len(coords)}_{len(edge_list)}",
        f"{dims[0]:.3f}_{dims[1]:.3f}",
        "_".join(f"{x:.3f}_{y:.3f}" for x, y in normalized),
    ]
    for node in sorted(conn):
        info.append(f"{node}:" + ",".join(map(str, sorted(conn[node]))))
    return hashlib.sha256("_".join(info).encode()).hexdigest()


def identify_geometry_groups(dataset: Sequence[GraphData]):
    groups: dict[str, list[int]] = {}
    for i, d in enumerate(dataset):
        groups.setdefault(geometry_hash(d), []).append(i)
    return groups


def _split_geometry_group(indices, all_bins, lengths, rng,
                          is_abundant=False):
    """Per-group bin-stratified split (DatasetSplit.py:883-960)."""
    if len(indices) == 0:
        return [[] for _ in lengths]
    bin_groups: dict[int, list[int]] = {}
    for idx in indices:
        bin_groups.setdefault(int(all_bins[idx]), []).append(idx)

    split_indices: list[list[int]] = [[] for _ in lengths]
    for bin_indices in bin_groups.values():
        bin_indices = list(bin_indices)
        rng.shuffle(bin_indices)
        if not is_abundant and bin_indices:
            split_indices[0].append(bin_indices.pop(0))
        # distribute the rest proportionally
        n = len(bin_indices)
        targets = [int(n * l) for l in lengths]
        targets[-1] = n - sum(targets[:-1])
        pos = 0
        for si, t in enumerate(targets):
            split_indices[si].extend(bin_indices[pos : pos + t])
            pos += t
    return split_indices


def dataset_split(
    dataset: Sequence[GraphData],
    prediction_type: str = "buckling",
    lengths: Sequence[float] = (0.85, 0.15),
    remove_outliers: bool = False,
    n_bins: int = 10,
    seed: int = 0,
    verbose: bool = False,
):
    """4-pass stratified split; returns lists of dataset indices per split
    (the reference returns torch Subsets, DatasetSplit.py:1069-1252)."""
    rng = np.random.default_rng(seed)

    if remove_outliers:
        if prediction_type == "buckling":
            mask = detect_buckling_outliers(dataset)
        elif "static" in prediction_type:
            mask = detect_static_outliers(dataset)
        else:
            mask = detect_modeshape_outliers(dataset)
        keep = np.where(mask)[0]
    else:
        keep = np.arange(len(dataset))
    sub = [dataset[int(i)] for i in keep]

    bins, values, bin_info = create_bins(sub, prediction_type, n_bins)
    geometry_groups = identify_geometry_groups(sub)

    total = len(sub)
    target_sizes = [int(total * l) for l in lengths]
    target_sizes[-1] = total - sum(target_sizes[:-1])

    bin_counts = Counter(bins.tolist())
    geo_counts = {h: len(ix) for h, ix in geometry_groups.items()}
    bin_thr = np.mean(list(bin_counts.values())) * 1.5
    geo_thr = np.mean(list(geo_counts.values())) * 1.5
    abundant_geos = {h for h, c in geo_counts.items() if c > geo_thr}

    split_indices: list[list[int]] = [[] for _ in lengths]
    remaining = set(range(total))

    # Coverage passes are capped at the train target — the reference's
    # uncapped version (DatasetSplit.py:1146-1160) empties the other splits
    # whenever most geometries are unique.
    def room():
        return len(split_indices[0]) < target_sizes[0]

    # pass 1a: Train covers every bin
    for bin_val in bin_counts:
        if not room():
            break
        cands = [i for i in remaining if bins[i] == bin_val]
        if cands:
            pick = int(rng.choice(cands))
            split_indices[0].append(pick)
            remaining.remove(pick)
    # pass 1b: Train covers every geometry
    for h, ix in geometry_groups.items():
        if not room():
            break
        cands = list(set(ix) & remaining)
        if cands:
            pick = int(rng.choice(cands))
            split_indices[0].append(pick)
            remaining.remove(pick)

    remaining_targets = [
        t - len(s) for t, s in zip(target_sizes, split_indices)
    ]

    def handle(group_hashes, is_abundant):
        for h in group_hashes:
            cands = list(set(geometry_groups[h]) & remaining)
            if not cands or sum(remaining_targets) <= 0:
                continue
            adjusted = [
                max(0, t) / max(sum(max(0, t) for t in remaining_targets), 1)
                for t in remaining_targets
            ]
            parts = _split_geometry_group(cands, bins, adjusted, rng,
                                          is_abundant)
            for si, ix in enumerate(parts):
                to_add = min(len(ix), max(remaining_targets[si], 0))
                if to_add > 0:
                    sel = list(ix)[:to_add]
                    split_indices[si].extend(sel)
                    remaining.difference_update(sel)
                    remaining_targets[si] -= to_add

    handle([h for h in geometry_groups if h not in abundant_geos], False)
    handle([h for h in geometry_groups if h in abundant_geos], True)

    # final pass: fill largest remaining target
    rest = list(remaining)
    rng.shuffle(rest)
    for idx in rest:
        si = int(np.argmax(remaining_targets))
        split_indices[si].append(idx)
        remaining_targets[si] -= 1

    out = [sorted(keep[i] for i in ix) for ix in split_indices]
    if verbose:
        verify_splits(out, dataset, prediction_type)
    return out


def verify_splits(split_indices, dataset, prediction_type):
    """Split-quality stats (verify_splits, DatasetSplit.py:1254-1277)."""
    total = len(dataset)
    sizes = [len(s) for s in split_indices]
    report = {
        "sizes": sizes,
        "ratios": [s / total for s in sizes],
    }
    if prediction_type == "buckling":
        values = _scalar_targets(dataset)
        report["value_stats"] = [
            (
                dict(mean=float(np.mean(v)), std=float(np.std(v)),
                     min=float(np.min(v)), max=float(np.max(v)))
                if len(v := values[list(ix)]) else None
            )
            for ix in split_indices
        ]
    return report


# ------------------------- outlier detectors ------------------------- #


def detect_buckling_outliers(dataset) -> np.ndarray:
    """IQR(15, 85) x2 filter on eigenvalues (DatasetSplit.py:608-637)."""
    ev = _scalar_targets(dataset)
    q1, q3 = np.percentile(ev, 15), np.percentile(ev, 85)
    iqr = q3 - q1
    return (ev >= q1 - 2 * iqr) & (ev <= q3 + 2 * iqr)


def detect_static_outliers(dataset) -> np.ndarray:
    """Max von Mises + displacement-magnitude IQR filter
    (DatasetSplit.py:639-724)."""
    vm_max, disp_max = [], []
    for d in dataset:
        v = d.y
        disp = v[:, :2]
        stress = v[:, -3:]
        disp_max.append(float(np.max(np.sqrt(np.sum(disp**2, axis=1)))))
        vm = np.sqrt(
            stress[:, 0] ** 2 - stress[:, 0] * stress[:, 1]
            + stress[:, 1] ** 2 + 3 * stress[:, 2] ** 2
        )
        vm_max.append(float(np.max(vm)))
    mask = np.ones(len(dataset), bool)
    for arr in (np.array(vm_max), np.array(disp_max)):
        q1, q3 = np.percentile(arr, 15), np.percentile(arr, 85)
        iqr = q3 - q1
        mask &= (arr >= q1 - 2 * iqr) & (arr <= q3 + 2 * iqr)
    return mask


def detect_modeshape_outliers(dataset, significance: float = 0.999) -> np.ndarray:
    """PCA + Mahalanobis + chi^2 filter (DatasetSplit.py:725-881)."""
    from scipy import stats as sstats
    from sklearn.decomposition import PCA

    max_len = max(d.y.size for d in dataset)
    feats = []
    for d in dataset:
        ms = d.y
        mx = float(np.max(np.sqrt(np.sum(ms**2, axis=1)))) + 1e-8
        flat = (ms / mx).flatten()
        feats.append(np.pad(flat, (0, max_len - flat.size)))
    feats = np.array(feats)
    k = min(5, feats.shape[1], len(dataset) - 1)
    p = PCA(n_components=k).fit_transform(feats)
    mean = p.mean(axis=0)
    cov = np.cov(p.T) + np.eye(k) * 1e-8
    inv = np.linalg.inv(cov)
    d2 = np.einsum("ij,jk,ik->i", p - mean, inv, p - mean)
    thr = sstats.chi2.ppf(significance, df=k)
    return d2 <= thr
