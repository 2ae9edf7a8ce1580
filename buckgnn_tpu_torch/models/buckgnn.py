"""The BuckGNN model (port of buckgnn_tpu/models/buckgnn.py), serving slice.

Covers the flagship variant ``GraphSage_addAggr_Shared`` with ``mean``
pooling and the buckling head, forward only, on banded batches that the
fused layer takes: node encoder -> L weight-tied fused SAGE layers (skip on
0 < i < L-1, Models/BuckGNN.py:349-351) -> mean pool -> decoder. On
supernode batches with local star windows each layer's kernel emits the
next layer's star table (models/buckgnn.py:169-242 of the JAX package);
without windows the table is rebuilt from x for each layer.

Every other model name, pooling or prediction type raises
NotImplementedError naming the ROADMAP item that brings it, and so does a
batch the fused layer does not take: nothing silently takes another path.
"""

from __future__ import annotations

import torch
from torch import nn

from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.models.blocks import (
    MLP, SAGEConv, decoder_widths, encoder_widths,
)
from buckgnn_tpu_torch.ops import segment


class BuckGNN(nn.Module):
    def __init__(self, num_node_features: int, num_edge_features: int,
                 hidden_channels: int = 128, num_layers: int = 6,
                 pooling_layer: str = "mean",
                 prediction_type: str = "buckling",
                 dropout_rate: float = 0.1,
                 model_name: str = "GraphSage_addAggr_Shared",
                 dtype: torch.dtype = torch.float32,
                 impl: str = "banded_pallas",
                 generator: torch.Generator | None = None):
        super().__init__()
        if model_name != "GraphSage_addAggr_Shared":
            raise NotImplementedError(
                f"model_name={model_name!r}: only GraphSage_addAggr_Shared "
                "is ported (rest of the family: ROADMAP queue 1, items 6-7)")
        if pooling_layer != "mean":
            raise NotImplementedError(
                f"pooling_layer={pooling_layer!r}: only 'mean' is ported "
                "(other poolings: ROADMAP queue 1, item 7)")
        if prediction_type != "buckling":
            raise NotImplementedError(
                f"prediction_type={prediction_type!r}: only the buckling "
                "head is ported (node-level heads: ROADMAP queue 1, item 7)")
        if impl != "banded_pallas":
            raise NotImplementedError(
                f"impl={impl!r}: only the fused banded path is ported "
                "(unfused and CSR paths: ROADMAP queue 1, items 2 and 7)")
        self.num_node_features = num_node_features
        self.num_edge_features = num_edge_features
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.pooling_layer = pooling_layer
        self.prediction_type = prediction_type
        self.dropout_rate = dropout_rate
        self.model_name = model_name
        self.dtype = dtype
        self.impl = impl
        h = hidden_channels
        self.node_encoder = MLP(num_node_features, encoder_widths(h),
                                dtype=dtype, generator=generator)
        self.shared_graphsage_block = SAGEConv(h, dtype=dtype,
                                               generator=generator)
        self.decoder = MLP(h, decoder_widths(h, 1), dtype=dtype,
                           generator=generator)

    def forward(self, batch: GraphBatch, deterministic: bool = True):
        """Returns ``(pred [G_cap], aux)`` with ``aux['real_node_mask']``
        and ``aux['node_keep']`` as in the JAX model."""
        from buckgnn_tpu_torch.ops.banded import make_agg_context
        from buckgnn_tpu_torch.ops.sage_layer import supports_fused_layer

        if not deterministic and self.dropout_rate > 0.0:
            raise NotImplementedError(
                "training-mode dropout comes with the training slice "
                "(ROADMAP queue 2, kernel 2)")
        if batch.band_senders is None:
            raise NotImplementedError(
                "unbanded batches need the CSR path (ROADMAP queue 1, item 7)")
        if batch.has_spill_edges:
            raise NotImplementedError(
                "batches with spill edges need the spill path "
                "(ROADMAP queue 1, item 5)")
        h = self.hidden_channels
        L = self.num_layers
        # 'mean' pooling does not look for supernodes (BuckGNN.py:315-316)
        real_node_mask = batch.node_mask

        x = self.node_encoder(batch.nodes)
        agg_ctx = make_agg_context(batch)
        if not supports_fused_layer(agg_ctx, x, "add", True):
            raise NotImplementedError(
                f"the fused layer does not take this batch/width (h={h}); "
                "the unfused banded path is ROADMAP queue 1, item 2")
        conv = self.shared_graphsage_block
        weights = conv.fused_weights(x.dtype)  # tied: convert once
        thread_tables = batch.has_supernode_edges and batch.gwin is not None
        table = None
        for i in range(L):
            emit = thread_tables and i < L - 1
            x, table = conv(x, agg_ctx, skip=0 < i < L - 1, weights=weights,
                            table_in=table, emit_table=emit)

        pooled = self._pool(x, batch)
        pred = self.decoder(pooled)
        aux = {"real_node_mask": real_node_mask, "node_keep": batch.node_mask}
        return pred.squeeze(-1), aux

    def _pool(self, x, batch: GraphBatch):
        """Masked mean readout (BuckGNN.py:246-307); divides in float32."""
        total = segment.segment_sum_dense(x, batch.node_graph,
                                          batch.n_graph_cap,
                                          keep=batch.node_mask)
        count = segment.segment_count_dense(batch.node_graph,
                                            batch.n_graph_cap,
                                            keep=batch.node_mask)
        return total.float() / count.clamp_min(1.0)[:, None]
