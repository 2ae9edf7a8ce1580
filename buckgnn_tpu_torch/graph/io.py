"""Dataset (de)serialization — the reference's pickle caches, in .npz.

The reference pickles lists of PyG Data objects per split
(dataset_cache_*.pkl, GraphCreate.py:562-568,636-638; TRAIN_FINAL.py cache
orchestration :1160-1255). We store a whole GraphData list in one .npz of
concatenated arrays + offsets: portable, mmap-able, no pickle.

A copy of buckgnn_tpu/graph/io.py, kept here so the port needs no JAX.
The npz layout is the JAX package's, so a cache either package writes
loads in the other.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from buckgnn_tpu_torch.graph.batch import GraphData

__all__ = ["save_dataset", "load_dataset_file", "dataset_cache_path"]


def dataset_cache_path(data_dir: str, prediction_type: str) -> str:
    """Cache naming parity: static_* types share one cache
    (GraphCreate.py:562)."""
    tag = "static" if "static" in prediction_type else prediction_type
    return os.path.join(data_dir, f"dataset_cache_{tag}.npz")


def save_dataset(dataset: Sequence[GraphData], path: str) -> None:
    x = np.concatenate([g.x for g in dataset])
    e = np.concatenate([g.edge_attr for g in dataset])
    s = np.concatenate([g.senders for g in dataset])
    r = np.concatenate([g.receivers for g in dataset])
    node_off = np.cumsum([0] + [g.n_node for g in dataset])
    edge_off = np.cumsum([0] + [g.n_edge for g in dataset])
    node_level = dataset[0].y.ndim == 2
    y = np.concatenate([np.atleast_2d(g.y) for g in dataset])
    y_off = np.cumsum([0] + [np.atleast_2d(g.y).shape[0] for g in dataset])
    supernode = np.array([g.supernode for g in dataset], np.int64)
    ev = np.array(
        [np.nan if g.eigenvalue is None else g.eigenvalue for g in dataset]
    )
    has_ms = all(g.mode_shapes is not None for g in dataset)
    extra = {}
    if has_ms:
        extra["mode_shapes"] = np.concatenate([g.mode_shapes for g in dataset])
        extra["ms_off"] = np.cumsum(
            [0] + [g.mode_shapes.shape[0] for g in dataset]
        )
    np.savez_compressed(
        path, x=x, edge_attr=e, senders=s, receivers=r,
        node_off=node_off, edge_off=edge_off, y=y, y_off=y_off,
        supernode=supernode, eigenvalue=ev,
        node_level=np.array(node_level), **extra,
    )


def load_dataset_file(path: str) -> list[GraphData]:
    with np.load(path) as z:
        # Materialize each archive member exactly once: NpzFile re-inflates
        # the whole compressed array on EVERY __getitem__, so indexing
        # inside the per-graph loop would decompress the archive O(graphs)
        # times.
        d = {k: z[k] for k in z.files}
    node_off = d["node_off"]
    edge_off = d["edge_off"]
    y_off = d["y_off"]
    node_level = bool(d["node_level"])
    has_ms = "mode_shapes" in d
    out = []
    for i in range(len(node_off) - 1):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        y = d["y"][y_off[i] : y_off[i + 1]]
        if not node_level:
            y = y.reshape(-1)
        ev = float(d["eigenvalue"][i])
        out.append(
            GraphData(
                x=d["x"][ns:ne],
                senders=d["senders"][es:ee],
                receivers=d["receivers"][es:ee],
                edge_attr=d["edge_attr"][es:ee],
                y=y,
                supernode=int(d["supernode"][i]),
                eigenvalue=None if np.isnan(ev) else ev,
                mode_shapes=(
                    d["mode_shapes"][d["ms_off"][i] : d["ms_off"][i + 1]]
                    if has_ms else None
                ),
            )
        )
    return out
