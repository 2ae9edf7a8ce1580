"""Node/edge-partitioned banded aggregation with boundary halo exchange.

The port of buckgnn_tpu/parallel/partitioned.py. Each batch's
block-diagonal graph is split across the ranks of the ``model`` mesh dim:

- node rows split into D contiguous ranges; rank d owns rows [d*Nl,
  (d+1)*Nl);
- in-band edges stay local except for a width/2-row halo at each range
  boundary: each rank sends its first and last width/2 rows to its
  neighbours (``batch_isend_irecv``, the JAX package's ``ppermute``; the
  edge ranks get zeros) and runs the banded slab products against the
  halo-extended local block. The band is re-packed with UNCLAMPED slab
  starts (tile t reads x_ext[t*tile : t*tile+slab]). The products are
  PyTorch batched matmuls, as the JAX package computes them with
  ``dot_general`` outside any Pallas kernel;
- out-of-band (spill) edges route sender rows point to point: a host
  routing table says which local rows each rank sends to each other rank,
  one ``all_to_all_single`` moves the fixed-capacity [D, S_cap, H] blocks,
  a precomputed permutation restores receiver order and a segment sum
  applies them;
- supernode stars: per-rank partial graph sums are ``all_reduce``'d into
  the [2G, H] table, then applied locally;
- the backward is the same operator applied to the cotangent (the total
  adjacency is symmetric), collectives included.

One process per card: the model around the aggregation runs replicated on
every rank of the ``model`` group, so `partitioned_sage_aggregate` takes
the whole [N, H] x and returns the whole aggregation (each rank computes
its rows, then one ``all_gather``), and its backward does the same to the
replicated cotangent. With one shard nothing is exchanged (the JAX
package's ``n_shards == 1`` branches).

`partition_batch` and `pad_partitioned` are NumPy copies of the JAX
package's, equal to them bit for bit; a `PartitionedBatch` holds torch
tensors with the shard axis D leading (`to` moves them to a device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from buckgnn_tpu_torch.ops import segment
from buckgnn_tpu_torch.parallel.mesh import all_gather_rows, model_dim

_ARRAYS = ("band", "send_idx", "recv_perm", "recv_receivers", "node_graph",
           "node_mask", "is_super", "gcode")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PartitionedBatch:
    """Per-shard arrays for the partitioned aggregation (leading axis D)."""

    band: torch.Tensor            # [D, nt_l, T, S] int8, unclamped starts
    send_idx: torch.Tensor        # [D, D, S_cap] int32 local sender rows
    recv_perm: torch.Tensor       # [D, E_cap] int32 into the flat [D*S_cap]
    recv_receivers: torch.Tensor  # [D, E_cap] int32 local receiver (pad Nl)
    node_graph: torch.Tensor      # [D, Nl] int32
    node_mask: torch.Tensor       # [D, Nl] float32
    is_super: torch.Tensor        # [D, Nl] float32
    gcode: torch.Tensor           # [D, Nl] int32 apply codes (sentinel tg)
    # static geometry
    tile: int = 256
    width: int = 128
    n_shards: int = 1
    g_cap: int = 1
    tg: int = 8
    has_super: bool = False
    has_spill: bool = False

    def to(self, device) -> "PartitionedBatch":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _ARRAYS})


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def partition_batch(batch, n_shards: int, spill_cap: int | None = None,
                    recv_cap: int | None = None,
                    force_spill: bool | None = None) -> PartitionedBatch:
    """Host-side: split a banded GraphBatch into per-shard arrays.

    ``spill_cap``/``recv_cap`` fix the all_to_all block / received-list
    capacities so every batch of a run shares one shape (pass the run's
    maxima); defaults size them for this batch alone. ``force_spill`` pins
    the has_spill flag (OR it across a run's batches)."""
    if batch.band_tile is None:
        raise ValueError("partition_batch needs a banded GraphBatch")
    tile, width = batch.band_tile, batch.band_width
    n = batch.n_node_cap
    if n % (n_shards * tile):
        raise ValueError(
            f"n_node_cap {n} must divide into {n_shards} tile-aligned shards"
        )
    nl = n // n_shards
    slab = tile + width
    if width // 2 > nl:
        raise ValueError("halo width exceeds shard size")

    senders = _np(batch.senders)
    receivers = _np(batch.receivers)
    valid = _np(batch.edge_mask)
    node_graph = _np(batch.node_graph)
    node_mask = _np(batch.node_mask)
    sn = _np(batch.supernode_index)
    g_cap = batch.n_graph_cap
    tg = _round_up(2 * g_cap, 8)
    dead = n - 1

    is_super = np.zeros(n, dtype=bool)
    real_super = sn < dead
    is_super[sn[real_super]] = True
    star = np.zeros_like(valid)
    if batch.has_supernode_edges:
        star = valid & (is_super[senders] | is_super[receivers])

    cand = valid & ~star
    t = receivers // tile
    k = senders - (t * tile - width // 2)  # UNCLAMPED slab offset
    inband = cand & (k >= 0) & (k < slab)
    spill = cand & ~inband

    flat = np.zeros(n * slab, dtype=np.int32)
    np.add.at(
        flat,
        receivers[inband].astype(np.int64) * slab + k[inband],
        1,
    )
    assert flat.max(initial=0) <= 127, "band overflow (>127 duplicate edges)"
    band = flat.astype(np.int8).reshape(n_shards, nl // tile, tile, slab)

    # ---- spill routing tables ----
    sp_s, sp_r = senders[spill], receivers[spill]
    src_dev = sp_s // nl
    dst_dev = sp_r // nl
    counts = np.zeros((n_shards, n_shards), dtype=np.int64)
    np.add.at(counts, (src_dev, dst_dev), 1)
    s_cap = spill_cap or max(int(counts.max(initial=0)), 1)
    s_cap = _round_up(s_cap, 8)
    if counts.max(initial=0) > s_cap:
        raise ValueError(
            f"spill_cap {s_cap} < max per-device-pair count {counts.max()}"
        )
    recv_counts = counts.sum(axis=0)
    e_cap = recv_cap or max(int(recv_counts.max(initial=0)), 1)
    e_cap = _round_up(e_cap, 8)
    if recv_counts.max(initial=0) > e_cap:
        raise ValueError(
            f"recv_cap {e_cap} < max per-device received count"
        )

    send_idx = np.zeros((n_shards, n_shards, s_cap), dtype=np.int32)
    recv_perm = np.zeros((n_shards, e_cap), dtype=np.int32)
    recv_receivers = np.full((n_shards, e_cap), nl, dtype=np.int32)
    slot = np.zeros(len(sp_s), dtype=np.int64)  # position in flat recv buf
    fill = np.zeros((n_shards, n_shards), dtype=np.int64)
    order = np.lexsort((sp_r, dst_dev, src_dev))
    for e in order:
        sd, dd = src_dev[e], dst_dev[e]
        p = fill[sd, dd]
        send_idx[sd, dd, p] = sp_s[e] - sd * nl
        slot[e] = sd * s_cap + p
        fill[sd, dd] += 1
    for d in range(n_shards):
        mine = np.nonzero(dst_dev == d)[0]
        mine = mine[np.argsort(sp_r[mine], kind="stable")]
        recv_perm[d, : len(mine)] = slot[mine]
        recv_receivers[d, : len(mine)] = sp_r[mine] - d * nl

    # ---- per-shard supernode metadata ----
    graph_has = np.zeros(g_cap, dtype=bool)
    graph_has[np.nonzero(real_super)[0]] = True
    member = graph_has[node_graph] & node_mask & ~is_super
    g = node_graph.astype(np.int64)
    gcode = np.where(member, g, np.where(is_super, g_cap + g, tg))

    return PartitionedBatch(
        band=torch.from_numpy(band),
        send_idx=torch.from_numpy(send_idx),
        recv_perm=torch.from_numpy(recv_perm),
        recv_receivers=torch.from_numpy(recv_receivers),
        node_graph=torch.from_numpy(node_graph.reshape(n_shards, nl).copy()),
        node_mask=torch.from_numpy(
            node_mask.reshape(n_shards, nl).astype(np.float32)),
        is_super=torch.from_numpy(
            is_super.reshape(n_shards, nl).astype(np.float32)),
        gcode=torch.from_numpy(gcode.astype(np.int32).reshape(n_shards, nl)),
        tile=tile, width=width, n_shards=n_shards, g_cap=g_cap, tg=tg,
        has_super=bool(batch.has_supernode_edges),
        has_spill=(bool(np.any(spill)) if force_spill is None
                   else bool(force_spill)),
    )


def pad_partitioned(pb: PartitionedBatch, spill_cap: int, recv_cap: int,
                    force_spill: bool | None = None) -> PartitionedBatch:
    """Widen a PartitionedBatch's spill capacities to run-uniform values
    (array padding, without re-running partition_batch's host loop). Pad
    send slots gather arbitrary rows that no recv_perm entry selects; pad
    recv slots keep the receiver sentinel nl."""
    d, _, s0 = pb.send_idx.shape
    e0 = pb.recv_perm.shape[1]
    i32 = torch.int32
    dev = pb.send_idx.device
    send_idx, recv_perm, recv_recv = pb.send_idx, pb.recv_perm, \
        pb.recv_receivers
    if spill_cap > s0:
        send_idx = torch.cat(
            [send_idx, torch.zeros((d, d, spill_cap - s0), dtype=i32,
                                   device=dev)], dim=2)
        # recv_perm indexes the flat [D * S_cap] received buffer:
        # re-derive it for the widened capacity
        src = torch.div(pb.recv_perm, s0, rounding_mode="floor")
        off = pb.recv_perm % s0
        recv_perm = (src * spill_cap + off).to(i32)
    if recv_cap > e0:
        recv_perm = torch.cat(
            [recv_perm, torch.zeros((d, recv_cap - e0), dtype=i32,
                                    device=dev)], dim=1)
        nl = pb.node_graph.shape[1]
        recv_recv = torch.cat(
            [recv_recv, torch.full((d, recv_cap - e0), nl, dtype=i32,
                                   device=dev)], dim=1)
    return dataclasses.replace(
        pb, send_idx=send_idx, recv_perm=recv_perm, recv_receivers=recv_recv,
        has_spill=(pb.has_spill if force_spill is None
                   else bool(force_spill)))


# --------------------------------------------------------------------- #
# the per-rank operator
# --------------------------------------------------------------------- #


def _halos(x: torch.Tensor, w2: int, group, d: int, n_shards: int):
    """(lo, hi): the last w2 rows of rank d-1 and the first w2 rows of rank
    d+1 (zeros at the ends), exchanged point to point."""
    lo = torch.zeros((w2, x.shape[1]), dtype=x.dtype, device=x.device)
    hi = torch.zeros_like(lo)
    ranks = dist.get_process_group_ranks(group)
    ops = []
    if d > 0:
        ops += [dist.P2POp(dist.isend, x[:w2].contiguous(), ranks[d - 1],
                           group=group),
                dist.P2POp(dist.irecv, lo, ranks[d - 1], group=group)]
    if d < n_shards - 1:
        ops += [dist.P2POp(dist.isend, x[-w2:].contiguous(), ranks[d + 1],
                           group=group),
                dist.P2POp(dist.irecv, hi, ranks[d + 1], group=group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return lo, hi


def _local_agg(x: torch.Tensor, pb: PartitionedBatch, d: int,
               group) -> torch.Tensor:
    """Rank d's rows of A @ x (band + spill + supernode stars) from its
    rows ``x`` [Nl, H] (the JAX package's ``_local_agg``)."""
    tile, width, n_shards = pb.tile, pb.width, pb.n_shards
    nl, h = x.shape
    w2 = width // 2
    band = pb.band[d]
    nt_l = band.shape[0]
    slab = tile + width

    if n_shards > 1:
        lo, hi = _halos(x, w2, group, d, n_shards)
    else:
        lo = torch.zeros((w2, h), dtype=x.dtype, device=x.device)
        hi = lo
    x_ext = torch.cat([lo, x, hi])  # [Nl + width, H]

    # the local banded slab products, float32 sums of x.dtype products
    idx = (torch.arange(nt_l, device=x.device)[:, None] * tile
           + torch.arange(slab, device=x.device)[None, :])
    xs = x_ext[idx]  # [nt_l, slab, H]
    b = band.to(torch.float32).to(x.dtype)
    agg = torch.bmm(b.float(), xs.float()).reshape(nl, h)

    if pb.has_spill:
        msgs_out = x[pb.send_idx[d].long()]  # [D, S_cap, H]
        if n_shards > 1:
            flat = msgs_out.reshape(-1, h).contiguous()
            got = torch.empty_like(flat)
            dist.all_to_all_single(got, flat, group=group)
            msgs_out = got
        msgs = msgs_out.reshape(-1, h)[pb.recv_perm[d].long()]
        spill = torch.zeros((nl + 1, h), dtype=torch.float32,
                            device=x.device)
        spill.index_add_(0, pb.recv_receivers[d].long(), msgs.float())
        agg = agg + spill[:nl]

    if pb.has_super:
        graph = pb.node_graph[d]
        t1 = segment.segment_sum_dense(x, graph, pb.g_cap,
                                       keep=pb.is_super[d] > 0)
        gsum = segment.segment_sum_dense(x, graph, pb.g_cap,
                                         keep=pb.node_mask[d] > 0)
        if n_shards > 1:
            t1, gsum = t1.contiguous(), gsum.contiguous()
            dist.all_reduce(t1, group=group)
            dist.all_reduce(gsum, group=group)
        table = torch.cat([t1, gsum - t1])  # [2G, H]
        gc = pb.gcode[d].long()
        sel = (gc < 2 * pb.g_cap)[:, None]
        corr = torch.where(
            sel, table[gc.clamp(0, 2 * pb.g_cap - 1)].float(),
            torch.zeros((), dtype=torch.float32, device=x.device))
        agg = agg + corr
    return agg.to(x.dtype)


def _psym(x: torch.Tensor, pb: PartitionedBatch, group, d: int):
    """The whole [N, H] aggregation: rank d's rows, then all_gather."""
    if pb.n_shards == 1:
        return _local_agg(x, pb, 0, None)
    nl = x.shape[0] // pb.n_shards
    out = _local_agg(x[d * nl:(d + 1) * nl], pb, d, group)
    return all_gather_rows(out, group)


class _PSymSum(torch.autograd.Function):
    """The partitioned sum with the symmetric VJP: the backward is the same
    operator, collectives included, on the cotangent cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, pb, group, d):
        ctx.pb, ctx.group, ctx.d, ctx.x_dtype = pb, group, d, x.dtype
        return _psym(x, pb, group, d)

    @staticmethod
    def backward(ctx, g):
        dx = _psym(g.to(ctx.x_dtype).contiguous(), ctx.pb, ctx.group, ctx.d)
        return dx, None, None, None


def partitioned_sage_aggregate(x: torch.Tensor, pb: PartitionedBatch,
                               mesh=None, aggr: str = "add") -> torch.Tensor:
    """Sum aggregation over the full edge set with node rows sharded over
    the ``model`` dim of ``mesh`` (default: the current mesh, `set_mesh`).
    x: the replicated [N, H]; returns the replicated [N, H], equal to
    `banded_sage_aggregate` on the same batch. Differentiable in x through
    the symmetric VJP."""
    if aggr not in ("add", "sum"):
        raise ValueError(
            f"partitioned aggregation supports add/sum only, got {aggr}"
        )
    group, size, d = model_dim(mesh)
    if pb.n_shards > 1 and size != pb.n_shards:
        raise ValueError(
            f"partitioned aggregation over {pb.n_shards} shards needs a "
            f"current mesh whose 'model' dim has {pb.n_shards} ranks "
            f"(have {size})")
    return _PSymSum.apply(x, pb, group, d)
