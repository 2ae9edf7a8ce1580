"""Block-banded SAGE aggregation (port of buckgnn_tpu/ops/banded.py:40-335).

Under a locality-preserving node order the edges concentrate near the
adjacency diagonal, so the sum over in-neighbours is

    agg = blockdiag(Band_t) @ x + spill + spill2 + supernode stars

with int8 counts ``Band_t`` [T, T+W] per node tile (the slab of candidate
senders starts at clip(t*T - W/2, 0, N - (T+W))), the out-of-band edges
(`spill`, and `spill2`, the per-tile overflow of the spill window) as
gathers and scatter-adds, and each supernode's star computed from
per-graph sums.

`make_agg_context` builds one `AggContext` per forward (the pack-time int8
band, or the device build of `build_band_matrix` for batches packed with
``materialize_band=False``; or, partitioned, the batch's ``part`` shards of
parallel/partitioned.py) and the fused layer (ops/sage_layer.py) and
`banded_sage_aggregate`, the unfused layers' aggregation, share it.

The band product with its spill window is TPU kernel #4 where the JAX
package takes it (``use_pallas`` and H % 128 == 0): on CUDA tensors
ops/banded_matmul.py::banded_matmul launches a hand-written kernel, the
product engine's (bf16 at H in {128, 256, 512}) or sage_simple.cu's
(float32 at any H % 128 == 0, bf16 at the other widths), by the static rule
`kernel_variant`; on CPU tensors the same wrapper runs its plain version.
Elsewhere the band product is the slab product, a batched matmul (an XLA
dot_general in the JAX package).

The aggregation's VJP uses the symmetry of the total adjacency (every edge
source materializes both directions, the star and the dead row's pad loops
are symmetric): the backward is the same aggregation applied to the
cotangent (`_SymSum`).
"""

from __future__ import annotations

import dataclasses

import torch

from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.ops import segment
from buckgnn_tpu_torch.ops.banded_matmul import (
    banded_matmul, banded_matmul_plain, kernel_variant, slab_starts,
)


@dataclasses.dataclass(frozen=True)
class AggContext:
    """Per-forward aggregation context: build once, reuse across layers."""

    batch: GraphBatch
    band: torch.Tensor | None  # [n_tiles, T, T+W] int8 counts
    degree: torch.Tensor | None = None  # [N] float32 in-degree (mean)
    super_gather_mask: torch.Tensor | None = None  # [N] float32
    use_pallas: bool = False
    # the edge-partitioned multi-device operator's shards
    # (parallel/partitioned.py::PartitionedBatch)
    part: object | None = None


def build_band_matrix(batch: GraphBatch) -> torch.Tensor:
    """[n_tiles, T, T+W] int8 counts of the in-band edge lists, built on the
    batch's device as the pack-time band (graph/batch.py::
    _host_band_matrix): the dead row's pad self-loops stack on one cell and
    are clipped to 127; any other count above 127 is an error."""
    n, tile, width = batch.n_node_cap, batch.band_tile, batch.band_width
    slab = tile + width
    r = batch.band_receivers.long()
    s = batch.band_senders.long()
    start = slab_starts(n, tile, width, r.device)[r // tile]
    flat = r * slab + (s - start)
    counts = torch.bincount(flat, minlength=n * slab)
    dead = n - 1
    dead_cell = dead * slab + dead - int(slab_starts(
        n, tile, width, "cpu")[dead // tile])
    live = counts.clone()
    live[dead_cell] = 0
    if int(live.max()) > 127:
        raise ValueError(
            "band overflow: >127 duplicate edges between one (sender, "
            "receiver) pair cannot be represented in the int8 band")
    return counts.clamp_max(127).to(torch.int8).reshape(n // tile, tile,
                                                          slab)


def make_agg_context(batch: GraphBatch, use_pallas: bool = False,
                     need_degree: bool = False,
                     partitioned: bool = False) -> AggContext:
    """The context of one forward. ``need_degree``: the in-degree over the
    real edges (band, spill, star; the pad loops masked out, as the JAX
    package counts them), which only the mean aggregation divides by.
    ``partitioned``: the edge-partitioned multi-device operator
    (parallel/partitioned.py) over ``batch.part``, which it needs."""
    if partitioned:
        if getattr(batch, "part", None) is None:
            raise ValueError(
                "partitioned aggregation needs batch.part "
                "(parallel.partitioned.partition_batch)")
        return AggContext(batch=batch, band=None, part=batch.part)
    if batch.band_senders is None:
        return AggContext(batch=batch, band=None)
    n, tile = batch.n_node_cap, batch.band_tile
    if batch.band is not None:
        band = batch.band.reshape(n // tile, tile, -1)
    else:
        band = build_band_matrix(batch)
    degree = None
    if need_degree:
        degree = segment.segment_count(batch.receivers, n,
                                       mask=batch.edge_mask)
    super_gather_mask = None
    if batch.has_supernode_edges:
        if batch.super_mask is not None:
            super_gather_mask = batch.super_mask
        else:
            has_super = batch.supernode_index < n - 1
            is_super = torch.zeros(n, dtype=torch.bool, device=band.device)
            is_super[batch.supernode_index.long()] = has_super
            member = (has_super[batch.node_graph.long()] & batch.node_mask
                      & ~is_super)
            super_gather_mask = member.float()
    return AggContext(batch=batch, band=band, degree=degree,
                      super_gather_mask=super_gather_mask,
                      use_pallas=use_pallas)


def band_route(device_type: str, dtype: torch.dtype, h: int,
               use_pallas: bool) -> bool:
    """Whether the band product takes kernel #4 (else the slab product):
    the JAX package's rule, ``use_pallas`` and H % 128 == 0
    (ops/banded.py:304-307). On the card one of kernel #4's two variants
    takes every float32 or bf16 width of that rule (`kernel_variant`); a
    route to it in another dtype raises here rather than take the slab
    product quietly."""
    if not (use_pallas and h % 128 == 0):
        return False
    if device_type == "cuda":
        try:
            kernel_variant(dtype, h)
        except NotImplementedError as e:
            raise NotImplementedError(
                f"banded_pallas on the card: kernel #4 {e}") from None
    return True


def _scatter_add(agg: torch.Tensor, rows: torch.Tensor,
                 msgs: torch.Tensor) -> torch.Tensor:
    """agg[rows] += msgs, accumulated in float32 and cast back once (the
    port's scatter-adds sum in float32, ops/segment.py)."""
    out = agg.to(torch.float32, copy=True)
    out.index_add_(0, rows.long(), msgs.float())
    return out.to(agg.dtype)


def _sym_sum_impl(x: torch.Tensor, ctx: AggContext,
                  kernel: bool) -> torch.Tensor:
    """Sum over band + spill + spill2 + supernode stars, in x's dtype
    (ops/banded.py:141-216 of the JAX package). On the kernel route the
    main spill list rides in the kernel's spill window; spill2 (and the
    spill list on the slab route) is scatter-added."""
    batch = ctx.batch
    n = x.shape[0]
    tile, width = batch.band_tile, batch.band_width
    spill_s = batch.spill_senders.long()
    if kernel:
        kw = {}
        if batch.has_spill_edges:
            kw = dict(spill_offsets=batch.spill_offsets,
                      spill_lo=batch.spill_lo, spill_hi=batch.spill_hi,
                      spill_messages=x[spill_s].contiguous())
        agg = banded_matmul(ctx.band, x.contiguous(), tile=tile, width=width,
                            out_dtype=x.dtype, **kw)
    else:
        agg = banded_matmul_plain(ctx.band, x, tile=tile, width=width,
                                  out_dtype=x.dtype)
        if batch.has_spill_edges:
            agg = _scatter_add(agg, batch.spill_receivers, x[spill_s])
    if batch.has_spill2_edges:
        agg = _scatter_add(agg, batch.spill2_receivers,
                           x[batch.spill2_senders.long()])
    if batch.has_supernode_edges:
        sn = batch.supernode_index.long()
        graph = batch.node_graph.long()
        super_mask = (ctx.super_gather_mask.to(x.dtype)
                      if ctx.super_gather_mask is not None
                      else torch.zeros(n, dtype=x.dtype, device=x.device))
        agg = agg + x[sn][graph] * super_mask[:, None]
        graph_sum = segment.segment_sum_dense(x, batch.node_graph,
                                              batch.n_graph_cap,
                                              keep=batch.node_mask)
        has_super = (sn < n - 1).to(x.dtype)
        contrib = (graph_sum - x[sn]) * has_super[:, None]
        agg = agg.index_add(0, sn, contrib)
    return agg


class _SymSum(torch.autograd.Function):
    """The banded sum with the symmetric VJP: dx = the same aggregation of
    the cotangent cast to x's dtype (ops/banded.py:219-272)."""

    @staticmethod
    def forward(fctx, x, ctx: AggContext, kernel: bool):
        fctx.ctx, fctx.kernel, fctx.x_dtype = ctx, kernel, x.dtype
        return _sym_sum_impl(x, ctx, kernel)

    @staticmethod
    def backward(fctx, g):
        dx = _sym_sum_impl(g.to(fctx.x_dtype), fctx.ctx, fctx.kernel)
        return dx.to(fctx.x_dtype), None, None


def banded_sage_aggregate(x: torch.Tensor, ctx: AggContext,
                          aggr: str = "add",
                          dtype: torch.dtype | None = None) -> torch.Tensor:
    """Neighbour aggregation equal to `sage_aggregate` over the full
    (symmetric) edge set: 'add'/'sum' over the band, spill, spill2 and the
    stars; 'mean' that sum over the true in-degree (float32 out, as bf16 /
    f32 promotes in the JAX package); 'max' (and a context without a band)
    by the gather path.

    ``dtype``: the calling conv's compute dtype. On kernel #4's route the
    band product takes x in that dtype: a bf16 model whose batch norms
    promoted its activations to float32 (as the JAX package's do) feeds the
    kernel bf16 rows (its bf16 variant), where the JAX route sums the
    float32 rows and its Dense rounds the sum to bf16 after."""
    batch = ctx.batch
    if ctx.part is not None:
        # node rows sharded over the mesh's 'model' dim: halo exchange,
        # spill all_to_all and the star all_reduce
        from buckgnn_tpu_torch.parallel.partitioned import (
            partitioned_sage_aggregate,
        )

        return partitioned_sage_aggregate(x, ctx.part, aggr=aggr)
    if ctx.band is None or aggr == "max":
        from buckgnn_tpu_torch.ops.sage import sage_aggregate

        return sage_aggregate(x, batch.senders, batch.receivers,
                              batch.n_node_cap, aggr=aggr)
    if aggr not in ("add", "sum", "mean"):
        raise ValueError(f"Unsupported banded aggregation: {aggr}")
    if dtype is not None and ctx.use_pallas and x.shape[1] % 128 == 0:
        x = x.to(dtype)
    kernel = band_route(x.device.type, x.dtype, x.shape[1], ctx.use_pallas)
    agg = _SymSum.apply(x, ctx, kernel)
    if aggr == "mean":
        degree = ctx.degree
        if degree is None:
            degree = segment.segment_count(batch.receivers,
                                           batch.n_node_cap,
                                           mask=batch.edge_mask)
        return agg / degree.clamp_min(1.0)[:, None]
    return agg
