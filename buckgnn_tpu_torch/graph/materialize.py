"""End-to-end split materialization — the 'Split&Save.py' role.

Reference flow (Dataset_Preparation/Split&Save.py:303-352): load + normalize
a dataset, persist the normalizer, split (90/10, n_bins=1000), copy raw
files into Train/Val folders and pickle per-split dataset caches. Here:
GraphData in -> per-split .npz caches + normalizer .npz + split manifest.

A copy of buckgnn_tpu/graph/materialize.py, kept here so the port needs no
JAX: the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Sequence

from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.io import dataset_cache_path, save_dataset
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer, normalize_dataset
from buckgnn_tpu_torch.graph.split import dataset_split, verify_splits

SPLIT_NAMES = ["Train", "Val", "Test"]


def split_and_save(
    dataset: Sequence[GraphData],
    out_dir: str,
    prediction_type: str = "buckling",
    lengths: Sequence[float] = (0.9, 0.1),
    n_bins: int = 1000,
    seed: int = 0,
    copy_source_files: bool = False,
):
    """Returns (split_indices, normalizer, report)."""
    os.makedirs(out_dir, exist_ok=True)
    normed, normalizer = normalize_dataset(
        dataset, prediction_type=prediction_type
    )
    normalizer.save(os.path.join(out_dir, "normalizer_cache.npz"))

    split_prediction = (
        "buckling" if prediction_type == "buckling"
        else ("static" if "static" in prediction_type else "modeshape")
    )
    splits = dataset_split(
        normed, split_prediction, lengths, n_bins=n_bins, seed=seed
    )
    report = verify_splits(splits, normed, split_prediction)

    for name, indices in zip(SPLIT_NAMES, splits):
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        subset = [normed[i] for i in indices]
        save_dataset(subset, dataset_cache_path(d, prediction_type))
        if copy_source_files:
            # copy BDF/OP2 pairs like dataset_split_folder_copy
            # (Split&Save.py:260-299)
            for i in indices:
                fp = dataset[i].file_path
                if fp and os.path.exists(fp):
                    shutil.copy(fp, d)
                    op2 = fp.replace(".bdf", ".op2")
                    if os.path.exists(op2):
                        shutil.copy(op2, d)

    with open(os.path.join(out_dir, "split_manifest.json"), "w") as f:
        json.dump(
            dict(
                lengths=list(lengths), n_bins=n_bins, seed=seed,
                prediction_type=prediction_type,
                sizes=[len(s) for s in splits],
                indices=[list(map(int, s)) for s in splits],
                report={k: v for k, v in report.items() if k != "value_stats"},
            ),
            f, indent=2,
        )
    return splits, normalizer, report
