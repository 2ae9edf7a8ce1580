"""Graph readout over the `GraphBatch` segment layout (port of
buckgnn_tpu/ops/pooling.py).

Segment reductions and gathers in place of PyG's global poolings and the
reference's supernode-index loop (Models/BuckGNN.py:255-293). Padding
nodes belong to the padding graph slot, so plain segment ops keep them out
of the real graphs' statistics.
"""

from __future__ import annotations

import torch

from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.ops import segment


def global_add_pool(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return segment.segment_sum(x, batch.node_graph, batch.n_graph_cap)


def is_supernode_flat(batch: GraphBatch) -> torch.Tensor:
    """[N_cap] bool marking each graph's supernode row (graphs without one
    point at the dead node, which stays unmarked)."""
    flags = torch.zeros(batch.n_node_cap, dtype=torch.bool,
                        device=batch.device)
    has_super = batch.supernode_index < batch.n_node_cap - 1
    flags[batch.supernode_index.long()[has_super]] = True
    return flags


def global_mean_pool(x: torch.Tensor, batch: GraphBatch,
                     exclude_supernode: bool = False) -> torch.Tensor:
    """Mean per graph; optionally over its real (non-super) nodes only."""
    if not exclude_supernode:
        return segment.segment_mean(x, batch.node_graph, batch.n_graph_cap)
    keep = batch.node_mask & ~is_supernode_flat(batch)
    total = segment.segment_sum(x * keep.to(x.dtype)[:, None],
                                batch.node_graph, batch.n_graph_cap)
    count = segment.segment_count(batch.node_graph, batch.n_graph_cap,
                                  mask=keep)
    return total.float() / count.clamp_min(1.0)[:, None]


def global_max_pool(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return segment.segment_max(x, batch.node_graph, batch.n_graph_cap)


def supernode_features(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """x at each graph's supernode ('supernode_only')."""
    return x[batch.supernode_index.long()]


def detect_supernodes(batch: GraphBatch, pooling_layer: str) -> torch.Tensor:
    """[N_cap] bool supernode rows from the input features, for the
    poolings that look for them (Models/BuckGNN.py:315-316: the last input
    feature is nonzero exactly on supernodes); all False otherwise."""
    if "super" in pooling_layer:
        return batch.node_mask & (batch.nodes[:, -1] != 0)
    return torch.zeros(batch.n_node_cap, dtype=torch.bool,
                       device=batch.device)
