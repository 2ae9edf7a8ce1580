"""The BuckGNN model family (port of buckgnn_tpu/models/buckgnn.py).

One `model_name`-switched module, as the JAX package's:

  GraphSage_addAggr_Shared   weight-tied SAGEConv(add, normalize) x L
  GraphSage_{sum,add,mean,max}Aggr        per-layer SAGE + MaskedBatchNorm
  GraphSage_{sum,add}Aggr_woBatchNorm     per-layer SAGE, no BN
  GraphSage_MLP              SAGE -> BN -> ReLU -> Dense -> (same) BN ->
                             ReLU, inner residual from the SAGE output
  EA_GNN / EA_GNN_Shared     edge-augmented GraphNetBlock stacks
  GraphSAGE_SAG / EAGNN_SAG  stacks with SAGPooling(ratio 0.5) mid-model

with the poolings mean, mean_no_super, supernode_only,
supernode_with_pooling, mlp, mlp_no_super and hybrid, and the heads
buckling (graph-level), static_disp, static_stress and mode_shape
(node-level; `output_dim_for`). Skips as the reference places them: 0 < i
< L-1 in the flat stacks, i > 0 in the first SAG stack and always in the
second.

``GraphSage_addAggr_Shared`` takes the fused layer (ops/sage_layer.py) for
``impl="banded_pallas"`` on a banded batch that the layer takes (no
``remat``, no spill2 overflow), threading the supernode star tables from
layer to layer on supernode batches without spill edges
(`star_threading`). Every other SAGE conv is unfused: `SAGEConv.unfused`
(the banded aggregation of ops/banded.py for a banded impl on a banded
batch, where kernel #4 is the band product of ``banded_pallas``; the CSR
kernel for ``'pallas'``; the segment reductions otherwise), then
ops/epilogue.py::relu_skip_dropout for the SAGE stacks. The EA family takes
the fused block (ops/ea_block.py) on windowed batches it takes without
``remat=True``, else the unfused block (`GraphNetBlock.unfused`: over the
windows for a banded impl on a windowed batch, else over the flat edge
list), rematerialized by default at h >= 256.

``remat`` wraps exactly what the JAX package wraps in ``nn.remat``: each
SAGE conv of the SAGE and SAG stacks (not the SAG score conv), and each
unfused GraphNetBlock of EA_GNN / EA_GNN_Shared, as
``torch.utils.checkpoint`` (non-reentrant). Dropout seeds are drawn from
the caller's generator outside the checkpointed functions, and the batch
norms, whose running statistics move in training, stay outside them too.

``impl="banded_partitioned"`` runs the multi-device routes on a batch
that carries them (the trainer attaches them, train/trainer.py): the SAGE
convs' aggregation over ``batch.part`` (parallel/partitioned.py), and the
fused EA stack tile-sharded over ``batch.ea_part`` (parallel/ea_shard.py,
with the edge encoder run per shard), both over the current mesh's
``model`` dim (parallel/mesh.py::set_mesh). What still raises on the card
is kernel #4's limits (ops/banded.py::band_route).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.models.blocks import (
    MLP, Dense, GraphNetBlock, MaskedBatchNorm, SAGEConv, decoder_widths,
    encoder_widths,
)
from buckgnn_tpu_torch.ops import pooling as pool_ops
from buckgnn_tpu_torch.ops import segment
from buckgnn_tpu_torch.ops.dropout import xla_dropout
from buckgnn_tpu_torch.utils.profiling import span

# the per-layer SAGE variants and their aggregation
SAGE_VARIANTS = {
    "GraphSage_sumAggr": "add",
    "GraphSage_addAggr": "add",
    "GraphSage_meanAggr": "mean",
    "GraphSage_maxAggr": "max",
    "GraphSage_sumAggr_woBatchNorm": "add",
    "GraphSage_addAggr_woBatchNorm": "add",
}
MODELS = ("GraphSage_addAggr_Shared", *SAGE_VARIANTS, "GraphSage_MLP",
          "EA_GNN", "EA_GNN_Shared", "GraphSAGE_SAG", "EAGNN_SAG")
POOLINGS = ("mean", "mean_no_super", "supernode_only",
            "supernode_with_pooling", "mlp", "mlp_no_super", "hybrid")
PREDICTION_TYPES = ("buckling", "static_disp", "static_stress", "mode_shape")
# segment_impl values of the JAX package (config.py:62)
IMPLS = ("xla", "sorted", "pallas", "banded", "banded_pallas",
         "banded_partitioned")


def output_dim_for(prediction_type: str, use_z_coord: bool,
                   use_rotations: bool) -> int:
    """Output dimension switch (Models/BuckGNN.py:19-38)."""
    if prediction_type == "buckling":
        return 1
    if prediction_type == "static_disp":
        if use_z_coord and use_rotations:
            return 6
        if use_z_coord:
            return 3
        if use_rotations:
            return 4
        return 2
    if prediction_type == "static_stress":
        return 3
    if prediction_type == "mode_shape":
        return 6 if use_rotations else 3
    raise ValueError(f"Unknown prediction type: {prediction_type}")


class BuckGNN(nn.Module):
    def __init__(self, num_node_features: int, num_edge_features: int,
                 hidden_channels: int = 128, num_layers: int = 6,
                 pooling_layer: str = "mean",
                 prediction_type: str = "buckling",
                 use_z_coord: bool = False, use_rotations: bool = False,
                 dropout_rate: float = 0.1,
                 model_name: str = "GraphSage_addAggr_Shared",
                 dtype: torch.dtype = torch.float32,
                 impl: str = "banded_pallas",
                 sag_ratio: float = 0.5,
                 remat: bool | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if model_name not in MODELS:
            raise ValueError(f"Unknown model_name: {model_name}")
        if pooling_layer not in POOLINGS:
            raise ValueError(f"Unknown pooling layer: {pooling_layer}")
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}: one of {', '.join(IMPLS)}")
        out_dim = output_dim_for(prediction_type, use_z_coord, use_rotations)
        self.num_node_features = num_node_features
        self.num_edge_features = num_edge_features
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.pooling_layer = pooling_layer
        self.prediction_type = prediction_type
        self.use_z_coord = use_z_coord
        self.use_rotations = use_rotations
        self.dropout_rate = dropout_rate
        self.model_name = model_name
        self.dtype = dtype
        self.impl = impl
        self.sag_ratio = sag_ratio
        self.remat = remat
        h, L = hidden_channels, num_layers
        kw = dict(dtype=dtype, generator=generator)
        self.node_encoder = MLP(num_node_features, encoder_widths(h), **kw)
        name = model_name
        if name in ("EA_GNN", "EA_GNN_Shared", "EAGNN_SAG"):
            self.edge_encoder = MLP(num_edge_features, encoder_widths(h),
                                    **kw)
        if name == "GraphSage_addAggr_Shared":
            self.shared_graphsage_block = SAGEConv(h, **kw)
        elif name in SAGE_VARIANTS or name == "GraphSage_MLP":
            aggr = SAGE_VARIANTS.get(name, "add")
            for i in range(L):
                self.add_module(f"sage_{i}", SAGEConv(h, aggr, **kw))
                if "woBatchNorm" not in name:
                    self.add_module(f"bn_{i}", MaskedBatchNorm(h))
                if name == "GraphSage_MLP":
                    self.add_module(f"mlp_{i}", Dense(h, h, **kw))
        elif name == "EA_GNN_Shared":
            self.shared_gn_block = GraphNetBlock(h, **kw)
        elif name == "EA_GNN":
            for i in range(L):
                self.add_module(f"gn_block_{i}", GraphNetBlock(h, **kw))
        else:  # the SAG stacks
            for i in range(L):
                stack, j = (1, i) if i < L // 2 else (2, i - L // 2)
                if name == "GraphSAGE_SAG":
                    self.add_module(f"sage{stack}_{j}", SAGEConv(h, **kw))
                    self.add_module(f"bn{stack}_{j}", MaskedBatchNorm(h))
                else:
                    self.add_module(f"gn{stack}_{j}", GraphNetBlock(h, **kw))
            self.sag_score = SAGEConv(1, normalize=False, in_features=h, **kw)
        dec_in = h
        if prediction_type == "buckling":
            # the readout's own layers exist only on the graph-level head
            if pooling_layer in ("mlp", "mlp_no_super"):
                self.pool_mlp = Dense(h, h, **kw)
            elif pooling_layer == "hybrid":
                self.hybrid_att = MLP(h, (h, 1), **kw)
                self.hybrid_mix = MLP(3 * h, (h, h), **kw)
            elif pooling_layer == "supernode_with_pooling":
                dec_in = 2 * h
        self.decoder = MLP(dec_in, decoder_widths(h, out_dim), **kw)

    # ------------------------------------------------------------------ #

    def forward(self, batch: GraphBatch, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Returns ``(pred, aux)``: pred [G_cap] (buckling) or [N_cap, out]
        (node-level heads), ``aux['real_node_mask']`` (valid, non-super
        rows) and ``aux['node_keep']`` (SAG survivors), as the JAX model.
        Training with dropout (``deterministic=False``, ``dropout_rate`` >
        0) needs ``generator``, the source of every dropout seed."""
        rate = self.dropout_rate if not deterministic else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "for the layers' dropout seeds")
        is_super = pool_ops.detect_supernodes(batch, self.pooling_layer)
        real_node_mask = batch.node_mask & ~is_super
        run = _Run(self, batch, rate, deterministic, generator)

        with span("model.encoder"):
            x = self.node_encoder(batch.nodes)
        node_keep = batch.node_mask
        name = self.model_name
        with span("model.stack"):
            if name == "GraphSage_addAggr_Shared":
                x = self._shared_sage(x, run)
            elif name in SAGE_VARIANTS:
                x = self._sage_variant(x, run)
            elif name == "GraphSage_MLP":
                x = self._sage_mlp(x, run)
            elif name in ("EA_GNN", "EA_GNN_Shared"):
                x = self._ea_stack(x, run)
            elif name == "GraphSAGE_SAG":
                x, node_keep = self._sage_sag(x, run)
            else:
                x, node_keep = self._ea_sag(x, run)

        aux = {"real_node_mask": real_node_mask, "node_keep": node_keep}
        if self.prediction_type == "buckling":
            with span("model.pool"):
                pooled = self._pool(x, batch, is_super, node_keep)
            with span("model.decoder"):
                return self.decoder(pooled).squeeze(-1), aux
        # node-level heads: supernodes leave through aux['real_node_mask']
        with span("model.decoder"):
            return self.decoder(x), aux

    # ---- SAGE stacks ---------------------------------------------------- #

    def _shared_sage(self, x, run):
        """The weight-tied stack: fused when the layer takes the batch,
        else unfused convs (models/buckgnn.py:169-242)."""
        from buckgnn_tpu_torch.ops.sage_layer import supports_fused_layer

        ctx = run.agg_ctx()
        if not self.remat and supports_fused_layer(ctx, x, "add", True):
            return self._sage_stack(x, run, ctx)
        conv, L = self.shared_graphsage_block, self.num_layers
        for i in range(L):
            c = run.conv(conv, x)
            x = run.epilogue(c, x if 0 < i < L - 1 else None)
        return x

    def _sage_stack(self, x, run, agg_ctx):
        """L fused, weight-tied SAGE layers with star threading."""
        from buckgnn_tpu_torch.ops.sage_layer import star_source

        training = not run.deterministic
        L = self.num_layers
        conv = self.shared_graphsage_block
        # serving casts the tied weights once; training casts them in every
        # layer call, so their six gradients are summed in float32
        weights = None if training else conv.fused_weights(x.dtype)
        thread, thread_tables = star_threading(run.batch)
        star = None
        if thread:
            x, star = star_source(x, agg_ctx)
        table = None
        for i in range(L):
            emit = thread_tables and i < L - 1
            out = conv(x, agg_ctx, skip=0 < i < L - 1, weights=weights,
                       rate=run.rate, seed=run.seed(),
                       deterministic=run.deterministic, star_in=star,
                       star_next=thread and i < L - 1, table_in=table,
                       emit_table=emit)
            if star is None:
                x, table = out
            else:
                x, star, table = out
        return x

    def _sage_variant(self, x, run):
        """Per-layer SAGE convs, BatchNorm (but the woBatchNorm names), the
        epilogue (models/buckgnn.py:244-271)."""
        L, mask = self.num_layers, run.batch.node_mask
        for i in range(L):
            x_prev = x
            x = run.conv(getattr(self, f"sage_{i}"), x)
            bn = getattr(self, f"bn_{i}", None)
            if bn is not None:
                x = bn(x, mask, use_running_average=run.deterministic)
            x = run.epilogue(x, x_prev if 0 < i < L - 1 else None)
        return x

    def _sage_mlp(self, x, run):
        """SAGE -> BN -> relu -> Dense -> the same BN -> relu, plus the
        SAGE output and the skip, then dropout (models/buckgnn.py:273-293;
        the one BN instance updates its statistics twice a layer)."""
        L, mask = self.num_layers, run.batch.node_mask
        for i in range(L):
            x_prev = x
            x_sage = run.conv(getattr(self, f"sage_{i}"), x)
            bn = getattr(self, f"bn_{i}")
            x = torch.relu(bn(x_sage, mask,
                              use_running_average=run.deterministic))
            x = getattr(self, f"mlp_{i}")(x)
            x = torch.relu(bn(x, mask, use_running_average=run.deterministic))
            x = x_sage + x
            if 0 < i < L - 1:
                x = x + x_prev
            x = run.dropout(x)
        return x

    def _sage_sag(self, x, run):
        """GraphSAGE_SAG (models/buckgnn.py:430-459)."""
        L, mask = self.num_layers, run.batch.node_mask
        n_before = L // 2
        for i in range(n_before):
            identity = x
            x = run.conv(getattr(self, f"sage1_{i}"), x)
            x = getattr(self, f"bn1_{i}")(
                x, mask, use_running_average=run.deterministic)
            x = run.dropout(torch.relu(x))
            if i > 0:
                x = x + identity
        x, keep = self._sag_pool(x, run)
        for i in range(L - n_before):
            identity = x
            x = run.conv(getattr(self, f"sage2_{i}"), x)
            x = x * keep.to(x.dtype)[:, None]
            x = getattr(self, f"bn2_{i}")(
                x, keep, use_running_average=run.deterministic)
            x = run.dropout(torch.relu(x)) + identity
            x = x * keep.to(x.dtype)[:, None]
        return x, keep

    # ---- EA stacks ------------------------------------------------------ #

    def _ea_stack(self, x, run):
        """EA_GNN / EA_GNN_Shared (models/buckgnn.py:295-428): the fused
        block on the windowed batches it takes, else the unfused block."""
        from buckgnn_tpu_torch.ops import ea_windowed as eaw
        from buckgnn_tpu_torch.ops.ea_block import (
            supports_fused_ea, supports_fused_encoder,
        )

        batch, h, L = run.batch, self.hidden_channels, self.num_layers
        windows = None
        edge_attr = batch.edges
        if self.impl.startswith("banded") and eaw.supports_windowed(batch):
            windows = (eaw.window_geometry(batch), batch.win_sidx,
                       batch.win_ridx, batch.win_far_pos, batch.win_far_send,
                       eaw.window_degree(batch))
            edge_attr = eaw.window_edge_features(batch)
        can_fuse = (windows is not None and self.remat is not True
                    and supports_fused_ea(batch, h))
        shared = self.model_name == "EA_GNN_Shared"

        def block(i):
            return (self.shared_gn_block if shared
                    else getattr(self, f"gn_block_{i}"))

        if can_fuse and self.impl == "banded_partitioned" \
                and batch.ea_part is not None:
            from buckgnn_tpu_torch.parallel.ea_shard import ea_tp_stack

            return ea_tp_stack(x, batch.ea_part, [block(i) for i in range(L)],
                               self.edge_encoder, rate=run.rate,
                               seed=run.seed(),
                               deterministic=run.deterministic)

        if can_fuse:
            from buckgnn_tpu_torch.ops.ea_block import make_ea_context

            ctx = make_ea_context(batch)
            fuse_enc = supports_fused_encoder(batch, h, edge_attr.shape[-1])
            if not fuse_enc:
                edge_attr = self.edge_encoder(edge_attr)
            for i in range(L):
                x, edge_attr = block(i)(
                    x, edge_attr, ctx, skip=0 < i < L - 1, rate=run.rate,
                    seed=run.seed(), deterministic=run.deterministic,
                    encoder=self.edge_encoder if fuse_enc and i == 0
                    else None)
            return x
        # the edge-dense unfused blocks remat by default at h >= 256
        remat = h >= 256 if self.remat is None else self.remat
        edge_attr = self.edge_encoder(edge_attr)
        for i in range(L):
            x_prev, e_prev = x, edge_attr
            x, edge_attr = run.call(
                block(i).unfused, remat, x, edge_attr, batch.senders,
                batch.receivers, windows)
            if 0 < i < L - 1:
                x = x + x_prev
                edge_attr = edge_attr + e_prev
            x = run.dropout(x)
            edge_attr = run.dropout(edge_attr)
        return x

    def _ea_sag(self, x, run):
        """EAGNN_SAG (models/buckgnn.py:461-492): flat unfused blocks."""
        batch, L = run.batch, self.num_layers
        s, r = batch.senders, batch.receivers
        e = self.edge_encoder(batch.edges)
        n_before = L // 2
        for i in range(n_before):
            x_prev, e_prev = x, e
            x, e = getattr(self, f"gn1_{i}").unfused(x, e, s, r)
            x, e = run.dropout(x), run.dropout(e)
            if i > 0:
                x, e = x + x_prev, e + e_prev
        x, keep = self._sag_pool(x, run)
        edge_keep = keep[s.long()] & keep[r.long()]
        e = e * edge_keep.to(e.dtype)[:, None]
        for i in range(L - n_before):
            x_prev, e_prev = x, e
            x, e = getattr(self, f"gn2_{i}").unfused(x, e, s, r)
            x = run.dropout(x * keep.to(x.dtype)[:, None])
            e = run.dropout(e)
            x, e = x + x_prev, e + e_prev
            x = x * keep.to(x.dtype)[:, None]
        return x, keep

    # ---- pooling -------------------------------------------------------- #

    def _sag_pool(self, x, run):
        """SAGPooling(ratio, GNN=SAGEConv, aggr='add') with static shapes
        (models/buckgnn.py:587-612): each graph keeps its
        ceil(ratio * n_real_node) best nodes by the learned score, ranked
        by a stable sort on (graph, -score) as ``jnp.lexsort``; survivors
        become x * tanh(score), the rest zero rows, and padding never
        survives."""
        batch = run.batch
        score = run.conv(self.sag_score, x, remat=False).squeeze(-1)
        graph = batch.node_graph.long()
        by_score = torch.argsort(-score.detach(), stable=True)
        order = by_score[torch.argsort(graph[by_score], stable=True)]
        counts = segment.segment_count(batch.node_graph, batch.n_graph_cap)
        starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
        sorted_graph = graph[order]
        rank = (torch.arange(batch.n_node_cap, device=x.device)
                - starts[sorted_graph])
        k = torch.ceil(self.sag_ratio * batch.n_real_node.float())
        keep = torch.zeros_like(batch.node_mask)
        keep[order] = rank < k[sorted_graph]
        keep = keep & batch.node_mask
        x = x * torch.tanh(score)[:, None] * keep.to(x.dtype)[:, None]
        return x, keep

    def _pool(self, x, batch: GraphBatch, is_super, node_keep):
        """Graph readout (models/buckgnn.py:519-585)."""
        p = self.pooling_layer
        mask = node_keep
        g_cap = batch.n_graph_cap

        def masked_mean(keep):
            total = segment.segment_sum_dense(x, batch.node_graph, g_cap,
                                              keep=keep)
            count = segment.segment_count_dense(batch.node_graph, g_cap,
                                                keep=keep)
            # divide in float32 (bf16 rounds counts above 256)
            return total.float() / count.clamp_min(1.0)[:, None]

        if p == "mean":
            return masked_mean(mask)
        if p == "mean_no_super":
            return masked_mean(mask & ~is_super)
        if p == "supernode_only":
            return pool_ops.supernode_features(x, batch)
        if p == "supernode_with_pooling":
            pooled = masked_mean(mask & ~is_super)
            sup = pool_ops.supernode_features(x, batch)
            return torch.cat([pooled, sup.float()], dim=-1)
        if p in ("mlp", "mlp_no_super"):
            keep = mask if p == "mlp" else mask & ~is_super
            return torch.relu(self.pool_mlp(masked_mean(keep)))
        # hybrid: sigmoid-attention sum, mean and max pools, mixed by an MLP
        att = torch.sigmoid(self.hybrid_att(x))
        att_pool = segment.segment_sum_dense(x * att, batch.node_graph,
                                             g_cap, keep=mask)
        mean_pool = masked_mean(mask)
        big_neg = torch.finfo(x.dtype).min
        masked_x = torch.where(mask[:, None], x,
                               torch.full((), big_neg, dtype=x.dtype,
                                          device=x.device))
        max_pool = segment.segment_max(masked_x, batch.node_graph, g_cap)
        count = segment.segment_count(batch.node_graph, g_cap, mask=mask)
        max_pool = torch.where(count[:, None] > 0, max_pool,
                               torch.zeros((), dtype=max_pool.dtype,
                                           device=x.device))
        dt = torch.promote_types(torch.promote_types(att_pool.dtype,
                                                     mean_pool.dtype),
                                 max_pool.dtype)
        combined = torch.cat([att_pool.to(dt), mean_pool.to(dt),
                              max_pool.to(dt)], dim=-1)
        return self.hybrid_mix(combined)


class _Run:
    """What one forward shares across its layers: the batch, the dropout
    rate and seed source, and the aggregation contexts built once (the
    banded `AggContext` and, for impl 'pallas', the CSR context)."""

    def __init__(self, model: BuckGNN, batch: GraphBatch, rate: float,
                 deterministic: bool, generator):
        self.model, self.batch, self.rate = model, batch, rate
        self.deterministic, self.generator = deterministic, generator
        self._agg_ctx = self._csr = None
        self._built = False

    def seed(self):
        """The next dropout seed words (None when nothing drops)."""
        return draw_seed(self.generator) if self.rate > 0.0 else None

    def agg_ctx(self):
        """The banded aggregation context (None unless a banded impl on a
        banded batch), built on first use."""
        m, batch = self.model, self.batch
        if not self._built:
            self._built = True
            if m.impl.startswith("banded") and batch.band_senders is not None:
                from buckgnn_tpu_torch.ops.banded import make_agg_context

                self._agg_ctx = make_agg_context(
                    batch, use_pallas=m.impl == "banded_pallas",
                    need_degree="mean" in m.model_name.lower(),
                    # EA batches carry ea_part (tile shards) instead of
                    # part: their context stays unpartitioned
                    partitioned=(m.impl == "banded_partitioned"
                                 and batch.part is not None))
            if m.impl == "pallas":
                from buckgnn_tpu_torch.ops.csr_segment import (
                    make_csr_context,
                )

                self._csr = make_csr_context(batch.senders, batch.receivers,
                                             batch.n_node_cap)
        return self._agg_ctx

    def call(self, fn, remat: bool, *args):
        """fn(*args), rematerialized in the backward when ``remat`` and
        autograd records (the JAX package's nn.remat)."""
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def conv(self, conv: SAGEConv, x, remat: bool | None = None):
        """One unfused SAGE conv on this forward's contexts; ``remat``
        defaults to the model's."""
        ctx = self.agg_ctx()
        remat = bool(self.model.remat) if remat is None else remat
        b = self.batch
        return self.call(
            lambda v: conv.unfused(v, b.senders, b.receivers,
                                   self.model.impl, self._csr, ctx),
            remat, x)

    def epilogue(self, c, p):
        """relu -> (+ skip p) -> dropout, one epilogue Function (kernels #8
        and #9 on the card); c and p promoted to one dtype first, as the
        JAX sum promotes."""
        from buckgnn_tpu_torch.ops.epilogue import relu_skip_dropout

        if p is not None and p.dtype != c.dtype:
            dt = torch.promote_types(c.dtype, p.dtype)
            c, p = c.to(dt), p.to(dt)
        return relu_skip_dropout(c, p, self.seed(), self.rate)

    def dropout(self, v):
        """Dropout outside the epilogue (ops/dropout.py::xla_dropout)."""
        if self.rate <= 0.0:
            return v
        return xla_dropout(v, self.seed(), self.rate)


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


def model_config_dict(model: BuckGNN) -> dict:
    """The checkpoint ``config`` payload (TRAIN_FINAL.py:397-409)."""
    return dict(
        num_node_features=model.num_node_features,
        num_edge_features=model.num_edge_features,
        hidden_channels=model.hidden_channels,
        num_layers=model.num_layers,
        use_edge_attr=True,
        use_z_coord=model.use_z_coord,
        use_rotations=model.use_rotations,
        prediction_type=model.prediction_type,
        pooling_layer=model.pooling_layer,
        dropout_rate=model.dropout_rate,
        model_name=model.model_name,
    )
