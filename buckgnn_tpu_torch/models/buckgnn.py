"""The BuckGNN model (port of buckgnn_tpu/models/buckgnn.py).

Covers the flagship variant ``GraphSage_addAggr_Shared`` with ``mean``
pooling and the buckling head on banded batches that the fused layer
takes: node encoder -> L weight-tied fused SAGE layers (skip on
0 < i < L-1, Models/BuckGNN.py:349-351, dropout after each) -> mean pool
-> decoder. Batches with spill edges (the virtual-edge config) add the
spill window in every layer and take the split backward. On supernode
batches without spill edges the layers thread their deferred backward star
tables from one to the next (`star_source` opens the chain at the encoder
output), and with local star windows each layer's kernel also emits the
next layer's star table; otherwise the table is rebuilt from x for each
layer (models/buckgnn.py:169-242 of the JAX package, `star_threading`).
In training (``deterministic=False``) each layer draws its two dropout
seed words from the caller's ``torch.Generator``.

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

    def forward(self, batch: GraphBatch, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Returns ``(pred [G_cap], aux)`` with ``aux['real_node_mask']``
        and ``aux['node_keep']`` as in the JAX model. Training with dropout
        (``deterministic=False``, ``dropout_rate`` > 0) needs ``generator``,
        the source of each layer's dropout seeds."""
        from buckgnn_tpu_torch.ops.banded import make_agg_context
        from buckgnn_tpu_torch.ops.sage_layer import (
            star_source, supports_fused_layer,
        )

        training = not deterministic
        rate = self.dropout_rate if training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "for the layers' dropout seeds")
        if batch.band_senders is None:
            raise NotImplementedError(
                "unbanded batches need the CSR path (ROADMAP queue 1, item 7)")
        h = self.hidden_channels
        L = self.num_layers
        # 'mean' pooling does not look for supernodes (BuckGNN.py:315-316)
        real_node_mask = batch.node_mask

        x = self.node_encoder(batch.nodes)
        agg_ctx = make_agg_context(batch)
        if not supports_fused_layer(agg_ctx, x, "add", True):
            raise NotImplementedError(
                f"the fused layer does not take this batch/width (h={h}, "
                f"spill2 overflow edges: {batch.has_spill2_edges}); the "
                "unfused banded path is ROADMAP queue 1, item 2")
        conv = self.shared_graphsage_block
        # serving casts the tied weights once; training casts them in every
        # layer call, so their six gradients are summed in float32
        weights = None if training else conv.fused_weights(x.dtype)
        thread, thread_tables = star_threading(batch)
        star = None
        if thread:
            x, star = star_source(x, agg_ctx)
        table = None
        for i in range(L):
            emit = thread_tables and i < L - 1
            seed = draw_seed(generator) if rate > 0.0 else None
            out = conv(x, agg_ctx, skip=0 < i < L - 1, weights=weights,
                       rate=rate, seed=seed, deterministic=deterministic,
                       star_in=star, star_next=thread and i < L - 1,
                       table_in=table, emit_table=emit)
            if star is None:
                x, table = out
            else:
                x, star, table = out

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


def star_threading(batch: GraphBatch) -> tuple[bool, bool]:
    """``(thread, thread_tables)`` as the JAX model decides them
    (models/buckgnn.py:193-211): the layers thread their backward star
    tables on supernode batches without spill edges that carry star codes,
    and emit the next layer's forward table when the batch also has local
    star windows."""
    thread = (batch.has_supernode_edges and not batch.has_spill_edges
              and batch.gcode is not None)
    return thread, thread and batch.gwin is not None


def draw_seed(generator: torch.Generator) -> tuple[int, int]:
    """One layer's two 32-bit dropout seed words (ops/dropout.py)."""
    words = torch.randint(0, 2**32, (2,), generator=generator,
                          dtype=torch.int64)
    return int(words[0]), int(words[1])
