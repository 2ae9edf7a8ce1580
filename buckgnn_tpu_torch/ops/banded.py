"""Aggregation context for the banded SAGE path.

The port of buckgnn_tpu/ops/banded.py:40-138 for batches that carry the
pack-time int8 band: one context per forward, shared by every layer. The
band is handed to the fused layer as int8 [n_tiles, T, T+W] (the kernel
converts it in shared memory). Device-side band building, the spill and
partitioned paths and the unfused aggregation come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from buckgnn_tpu_torch.graph.batch import GraphBatch


@dataclasses.dataclass(frozen=True)
class AggContext:
    """Per-forward aggregation context: build once, reuse across layers."""

    batch: GraphBatch
    band: torch.Tensor | None  # [n_tiles, T, S] int8


def make_agg_context(batch: GraphBatch) -> AggContext:
    if batch.band_senders is None:
        return AggContext(batch=batch, band=None)
    if batch.band is None:
        raise NotImplementedError(
            "batches packed with materialize_band=False need the device "
            "band build (ROADMAP queue 1, item 2)"
        )
    n_tiles = batch.n_node_cap // batch.band_tile
    band = batch.band.reshape(n_tiles, batch.band_tile, -1)
    return AggContext(batch=batch, band=band)
