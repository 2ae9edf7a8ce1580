"""The BuckGNN model (port of buckgnn_tpu/models/buckgnn.py).

Covers ``mean`` pooling and the buckling head with two processors.

``GraphSage_addAggr_Shared`` (node encoder -> L weight-tied SAGE layers,
skip on 0 < i < L-1 (Models/BuckGNN.py:349-351), dropout after each ->
mean pool -> decoder) takes one of two routes, as the JAX model decides
them (models/buckgnn.py:141-242):

- the fused layer (ops/sage_layer.py), for ``impl="banded_pallas"`` on
  banded batches that it takes. Batches with spill edges (the
  virtual-edge config) add the spill window in every layer and take the
  split backward. On supernode batches without spill edges the layers
  thread their deferred backward star tables from one to the next
  (`star_source` opens the chain at the encoder output), and with local
  star windows each layer's kernel also emits the next layer's star table;
  otherwise the table is rebuilt from x for each layer (`star_threading`);
- the unfused layers, for ``impl`` ``'xla'``, ``'sorted'`` and
  ``'pallas'`` on any batch (a band is ignored) and for a banded impl on a
  batch without a band: per layer `SAGEConv.unfused` (the aggregation of
  ops/sage.py: the CSR kernel for ``'pallas'``, the segment reductions for
  the others, banded impls included), then
  ops/epilogue.py::relu_skip_dropout of the conv output and the skip.

The other banded impls (``'banded'``, ``'banded_partitioned'``) on a banded
batch, and the batches the fused layer refuses (spill2 overflow), need the
unfused banded path: they raise, naming ROADMAP queue 1 item 2. In training
(``deterministic=False``) each layer draws its two dropout seed words from
the caller's ``torch.Generator``.

The edge-augmented ``EA_GNN_Shared`` (one weight-tied ``shared_gn_block``)
and ``EA_GNN`` (``gn_block_{i}`` per layer), with a banded impl on batches
with edge windows that the fused block takes (models/buckgnn.py:295-428 of
the JAX package, fused and not tensor-parallel): node encoder, and the
edge encoder on the raw window, or inside layer 0's kernel when
`supports_fused_encoder` holds; then L fused blocks with skip on x and e
for 0 < i < L-1 and dropout inside the kernel; mean pool and decoder.

Every other model name, pooling or prediction type raises
NotImplementedError naming the ROADMAP item that brings it, and so do
``remat=True`` and the EA family's unfused windowed path (item 7c):
nothing silently takes another path.
"""

from __future__ import annotations

import torch
from torch import nn

from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.models.blocks import (
    MLP, GraphNetBlock, SAGEConv, decoder_widths, encoder_widths,
)
from buckgnn_tpu_torch.ops import segment


PORTED_MODELS = ("GraphSage_addAggr_Shared", "EA_GNN_Shared", "EA_GNN")
# segment_impl values of the JAX package (config.py:62)
IMPLS = ("xla", "sorted", "pallas", "banded", "banded_pallas",
         "banded_partitioned")


class BuckGNN(nn.Module):
    def __init__(self, num_node_features: int, num_edge_features: int,
                 hidden_channels: int = 128, num_layers: int = 6,
                 pooling_layer: str = "mean",
                 prediction_type: str = "buckling",
                 dropout_rate: float = 0.1,
                 model_name: str = "GraphSage_addAggr_Shared",
                 dtype: torch.dtype = torch.float32,
                 impl: str = "banded_pallas",
                 remat: bool | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if model_name not in PORTED_MODELS:
            raise NotImplementedError(
                f"model_name={model_name!r}: only {', '.join(PORTED_MODELS)} "
                "are ported (rest of the family: ROADMAP queue 1, item 7)")
        if remat:
            raise NotImplementedError(
                "remat=True selects the rematerialized paths (ROADMAP "
                "queue 1, items 2 and 7c)")
        if pooling_layer != "mean":
            raise NotImplementedError(
                f"pooling_layer={pooling_layer!r}: only 'mean' is ported "
                "(other poolings: ROADMAP queue 1, item 7)")
        if prediction_type != "buckling":
            raise NotImplementedError(
                f"prediction_type={prediction_type!r}: only the buckling "
                "head is ported (node-level heads: ROADMAP queue 1, item 7)")
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}: one of {', '.join(IMPLS)}")
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
        kw = dict(dtype=dtype, generator=generator)
        self.node_encoder = MLP(num_node_features, encoder_widths(h), **kw)
        if model_name == "GraphSage_addAggr_Shared":
            self.shared_graphsage_block = SAGEConv(h, **kw)
        else:
            self.edge_encoder = MLP(num_edge_features, encoder_widths(h),
                                    **kw)
            if model_name == "EA_GNN_Shared":
                self.shared_gn_block = GraphNetBlock(h, **kw)
            else:
                for i in range(num_layers):
                    self.add_module(f"gn_block_{i}", GraphNetBlock(h, **kw))
        self.decoder = MLP(h, decoder_widths(h, 1), dtype=dtype,
                           generator=generator)

    def forward(self, batch: GraphBatch, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Returns ``(pred [G_cap], aux)`` with ``aux['real_node_mask']``
        and ``aux['node_keep']`` as in the JAX model. Training with dropout
        (``deterministic=False``, ``dropout_rate`` > 0) needs ``generator``,
        the source of each layer's dropout seeds."""
        rate = self.dropout_rate if not deterministic else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "for the layers' dropout seeds")
        # 'mean' pooling does not look for supernodes (BuckGNN.py:315-316)
        real_node_mask = batch.node_mask

        x = self.node_encoder(batch.nodes)
        if self.model_name != "GraphSage_addAggr_Shared":
            x = self._ea_stack(x, batch, rate, deterministic, generator)
        elif self.impl.startswith("banded") and batch.band_senders is not None:
            x = self._sage_stack(x, batch, rate, deterministic, generator)
        else:
            x = self._sage_unfused(x, batch, rate, generator)

        pooled = self._pool(x, batch)
        pred = self.decoder(pooled)
        aux = {"real_node_mask": real_node_mask, "node_keep": batch.node_mask}
        return pred.squeeze(-1), aux

    def _ea_stack(self, x, batch, rate, deterministic, generator):
        """L fused GraphNetBlocks (models/buckgnn.py:295-428 of the JAX
        package, the fused branch)."""
        from buckgnn_tpu_torch.ops.ea_block import (
            make_ea_context, supports_fused_ea, supports_fused_encoder,
        )
        from buckgnn_tpu_torch.ops.ea_windowed import window_edge_features

        h = self.hidden_channels
        L = self.num_layers
        if not self.impl.startswith("banded"):
            raise NotImplementedError(
                f"impl={self.impl!r}: the EA family's unfused path is "
                "ROADMAP queue 1, item 7c")
        if not supports_fused_ea(batch, h):
            raise NotImplementedError(
                f"the fused EA block does not take this batch/width (h={h}, "
                f"edge windows: {batch.win_edges is not None}); the unfused "
                "windowed path is ROADMAP queue 1, item 7")
        ctx = make_ea_context(batch)
        edge_attr = window_edge_features(batch)
        fuse_enc = supports_fused_encoder(batch, h, edge_attr.shape[-1])
        if not fuse_enc:
            edge_attr = self.edge_encoder(edge_attr)
        for i in range(L):
            blk = (self.shared_gn_block if self.model_name == "EA_GNN_Shared"
                   else getattr(self, f"gn_block_{i}"))
            seed = draw_seed(generator) if rate > 0.0 else None
            x, edge_attr = blk(
                x, edge_attr, ctx, skip=0 < i < L - 1, rate=rate, seed=seed,
                deterministic=deterministic,
                encoder=self.edge_encoder if fuse_enc and i == 0 else None)
        return x

    def _sage_stack(self, x, batch, rate, deterministic, generator):
        """L fused, weight-tied SAGE layers with star threading."""
        from buckgnn_tpu_torch.ops.banded import make_agg_context
        from buckgnn_tpu_torch.ops.sage_layer import (
            star_source, supports_fused_layer,
        )

        training = not deterministic
        h = self.hidden_channels
        L = self.num_layers
        if self.impl != "banded_pallas":
            raise NotImplementedError(
                f"impl={self.impl!r} on a banded batch runs the unfused "
                "banded path, ROADMAP queue 1, item 2")
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
        return x

    def _sage_unfused(self, x, batch, rate, generator):
        """L unfused, weight-tied SAGE layers (models/buckgnn.py:238-242 of
        the JAX package): conv, then relu, the skip and dropout. A banded
        impl aggregates by the 'xla' route here (blocks.py:159-162)."""
        from buckgnn_tpu_torch.ops.csr_segment import make_csr_context
        from buckgnn_tpu_torch.ops.epilogue import relu_skip_dropout

        L = self.num_layers
        impl = "xla" if self.impl.startswith("banded") else self.impl
        csr = (make_csr_context(batch.senders, batch.receivers,
                                batch.n_node_cap) if impl == "pallas" else None)
        conv = self.shared_graphsage_block
        for i in range(L):
            c = conv.unfused(x, batch.senders, batch.receivers, impl, csr)
            seed = draw_seed(generator) if rate > 0.0 else None
            x = relu_skip_dropout(c, x if 0 < i < L - 1 else None, seed, rate)
        return x

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
