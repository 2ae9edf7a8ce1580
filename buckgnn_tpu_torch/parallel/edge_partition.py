"""Edge-partitioned neighbour aggregation over the ``model`` mesh dim.

The port of buckgnn_tpu/parallel/edge_partition.py. Each batch's
block-diagonal edge set is split into contiguous chunks, one per rank of
the ``model`` dim; every rank gather-scatters its own edges into a
full-size node accumulator and the partial aggregations are summed with
``all_reduce`` (the JAX package's ``psum`` inside ``shard_map``).

One process per card: a rank holds only its own chunk of the edge arrays
(`shard_edge_arrays`), and x is replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from buckgnn_tpu_torch.parallel.mesh import model_dim, sum_grads, sum_partials


def partition_edges(senders, receivers, edges, n_shards: int):
    """Host-side: contiguous split of the (receiver-sorted) edge arrays
    into ``n_shards`` equal chunks (already padded to a multiple)."""
    e = senders.shape[0]
    if e % n_shards:
        raise ValueError(f"edge capacity {e} not divisible by {n_shards}")
    k = e // n_shards
    return (
        senders.reshape(n_shards, k),
        receivers.reshape(n_shards, k),
        edges.reshape(n_shards, k, -1),
    )


def shard_edge_arrays(mesh, senders, receivers, edges):
    """This rank's chunk of the edge arrays along the ``model`` dim of
    ``mesh`` (the JAX package places the whole arrays with that sharding;
    here each process keeps only its own)."""
    _, size, rank = model_dim(mesh)
    s, r, e = partition_edges(senders, receivers, edges, size)
    return s[rank], r[rank], e[rank]


def edge_partitioned_aggregate(x: torch.Tensor, senders: torch.Tensor,
                               receivers: torch.Tensor, mesh,
                               aggr: str = "add") -> torch.Tensor:
    """aggr over all edges, each rank holding its chunk of them.

    x: [N, F], replicated; senders/receivers: this rank's chunk
    (`shard_edge_arrays`). Returns the [N, F] aggregation over every
    rank's edges, replicated, equal to the single-device op. 'add'/'sum'
    and 'mean' are differentiable in x (the partial sums' cotangent is the
    replicated one; x's gradient is summed over the ranks); 'max' is not.
    """
    group, size, _ = model_dim(mesh)
    n = x.shape[0]
    s, r = senders.long(), receivers.long()

    def total(t):
        return sum_partials(t, group) if size > 1 else t

    if aggr == "max":
        partial = torch.full((n, x.shape[1]), -torch.inf, dtype=x.dtype,
                             device=x.device)
        partial = partial.index_reduce(0, r, x.detach()[s], "amax")
        if size > 1:
            dist.all_reduce(partial, op=dist.ReduceOp.MAX, group=group)
        return torch.where(torch.isfinite(partial), partial,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    xs = sum_grads(x, group) if size > 1 else x
    partial = torch.zeros_like(x).index_add(0, r, xs[s])
    if aggr in ("add", "sum"):
        return total(partial)
    if aggr == "mean":
        cnt = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
            0, r, torch.ones_like(r, dtype=x.dtype))
        count = cnt.clone()
        if size > 1:
            dist.all_reduce(count, group=group)
        return total(partial) / count.clamp_min(1.0)[:, None]
    raise ValueError(aggr)
