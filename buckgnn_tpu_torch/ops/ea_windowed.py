"""Window geometry of the edge-augmented GraphNetBlock.

The port of buckgnn_tpu/ops/ea_windowed.py:32-55. Edges are
receiver-sorted into per-node-tile windows of W slots
(graph/batch.py::GraphBatch.win_*); these helpers read the batch's static
geometry, the sender slabs' starts, the in-degree for the scatter-mean and
the raw window features. ops/ea_block.py::make_ea_context builds the fused
block's flat slot geometry from them.
The unfused windowed path (``gather_senders`` and the one-hot matmuls,
ea_windowed.py:57-114 of the JAX package) is ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import torch


def window_geometry(batch) -> tuple[int, int, int, int, int]:
    """Static window geometry (tile, width, slab, n_tiles, n)."""
    tile, width = batch.band_tile, batch.band_width
    n = batch.n_node_cap
    return (tile, width, tile + width, n // tile, n)


def slab_starts(batch) -> torch.Tensor:
    """[n_tiles] int64 first node of each tile's sender slab: the tile's
    start less width/2, clamped into [0, N - slab]."""
    tile, width, slab, n_tiles, n = window_geometry(batch)
    t = torch.arange(n_tiles, device=batch.device)
    return (t * tile - width // 2).clamp(0, max(n - slab, 0))


def window_count(batch) -> torch.Tensor:
    """[N] float32 incoming-edge counts (CSR row lengths, pad edges
    included, as the fused block's mean divides by)."""
    return (batch.row_offsets[1:] - batch.row_offsets[:-1]).float()


def window_degree(batch) -> torch.Tensor:
    """[N, 1] float32 incoming-edge counts for the mean, at least 1."""
    return window_count(batch).clamp_min(1.0)[:, None]


def supports_windowed(batch) -> bool:
    return batch.win_edges is not None and batch.band_tile is not None


def window_edge_features(batch) -> torch.Tensor:
    """Raw edge features in window layout [n_tiles, W, Fe] (host-built)."""
    return batch.win_edges
