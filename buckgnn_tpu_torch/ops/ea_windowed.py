"""Window geometry of the edge-augmented GraphNetBlock.

The port of buckgnn_tpu/ops/ea_windowed.py:32-55. Edges are
receiver-sorted into per-node-tile windows of W slots
(graph/batch.py::GraphBatch.win_*); these helpers read the batch's static
geometry, the sender slabs' starts, the in-degree for the scatter-mean and
the raw window features. ops/ea_block.py::make_ea_context builds the fused
block's flat slot geometry from them.

`gather_senders`, `gather_receivers` and `scatter_mean_messages` are the
unfused windowed block's gathers and scatter-mean (ea_windowed.py:57-114
of the JAX package): one-hot products over each tile's slab or tile, in
the data's dtype with float32 accumulation, and the far senders added into
the flat window buffer. They are XLA one-hot einsums in the JAX package,
batched matmuls here; autograd gives their transposes.
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


def _one_hot(idx: torch.Tensor, width: int, dtype) -> torch.Tensor:
    """[..., width] one-hot rows of ``idx`` (codes >= width: zero rows)."""
    return (idx.long()[..., None] == torch.arange(
        width, device=idx.device)).to(dtype)


def _bmm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b accumulated in float32, cast once to ``dtype``."""
    return torch.bmm(a.float(), b.float()).to(dtype)


def gather_senders(x, win_sidx, far_pos, far_send, geom) -> torch.Tensor:
    """x[senders] in window layout [n_tiles, W, H]: the slab one-hot
    product, then the far senders added at their flat positions (pads lie
    past the buffer and are dropped, as ``mode="drop"``)."""
    tile, width, slab, n_tiles, n = geom
    h = x.shape[1]
    starts = (torch.arange(n_tiles, device=x.device) * tile
              - width // 2).clamp(0, max(n - slab, 0))
    slabs = x[starts[:, None] + torch.arange(slab, device=x.device)]
    xs = _bmm(_one_hot(win_sidx, slab, x.dtype), slabs, x.dtype)
    w = xs.shape[1]
    pos = far_pos.long()
    live = pos < n_tiles * w
    flat = xs.reshape(n_tiles * w, h).index_add(
        0, pos[live], x[far_send.long()[live]])
    return flat.reshape(n_tiles, w, h)


def gather_receivers(x, win_ridx, geom) -> torch.Tensor:
    """x[receivers] in window layout (receivers are tile-local)."""
    tile, _, _, n_tiles, _ = geom
    tiles = x.reshape(n_tiles, tile, -1)
    return _bmm(_one_hot(win_ridx, tile, x.dtype), tiles, x.dtype)


def scatter_mean_messages(msg, win_ridx, degree, geom) -> torch.Tensor:
    """scatter_mean(msg, receivers) as the transposed receiver one-hot
    product over [N, 1] ``degree``; pads (code T) select nothing."""
    tile, _, _, n_tiles, n = geom
    onehot = _one_hot(win_ridx, tile, msg.dtype)
    agg = torch.bmm(onehot.transpose(1, 2).float(), msg.float())
    return (agg.reshape(n, -1) / degree).to(msg.dtype)
