"""Tile-sharded model parallelism for the fused EA GraphNetBlock stack.

The port of buckgnn_tpu/parallel/ea_shard.py, the EA counterpart of
parallel/partitioned.py. The edge windows, the dominant memory term of the
edge-dense family ([T, W, h] per layer against [N, h] of node state), are
split by receiver tile over the ranks of the ``model`` mesh dim, and each
rank runs the fused block kernels (ops/ea_block.py, kernels #5 and #6) on
its own tile range:

- each rank holds the raw edge windows, sender/receiver codes and [T_l, W,
  h] edge activations of its tiles only; a block's ze stays on its rank
  and feeds the next block there;
- node activations are replicated: after each block the ranks' [Nl, h]
  node outputs are gathered (one ``all_gather``). Senders at interior
  tiles are the rank's own rows; those that cross a shard boundary and the
  out-of-band senders come through the kernels' far rows, which carry
  GLOBAL ids into the replicated x (`shard_ea_batch` re-codes them);
- backward: each block runs in ``far_grad='hybrid'`` mode, its far zone
  laid out [shard-local senders | remote senders] (``cf_local`` splits
  it): the local zone's gradient folds into the rank's dx, and only the
  remote rows' gradients go back into the replicated x.

Who sums what, one process per card: the model around the stack runs
replicated on every rank of the ``model`` group, so its gradients are
whole on every rank. Inside the stack a rank's gradients are partial: its
blocks' weight gradients, its edge encoder's, and its share of x's (its
own rows and the remote rows it read). `sum_grads` sums each of those over
the ``model`` group at the stack's inputs; the gather after a block passes
each rank its rows of the summed gradient (all_reduce, then its slice),
and the gather after the last block its rows of the whole one. This is
what ``shard_map``'s autodiff gives the JAX package (``out_specs=P()``,
the all_gather's reduce_scatter transpose, the weight grads' psum).

`shard_ea_batch`, `shard_caps` and `pad_ea_shards` are NumPy copies of the
JAX package's, equal to them bit for bit; an `EAShards` holds torch
tensors with the shard axis D leading (`to` moves them to a device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from buckgnn_tpu_torch.graph.batch import FAR_SLOT_SENTINEL
from buckgnn_tpu_torch.parallel.mesh import (
    all_gather_rows, model_dim, sum_grads,
)

_ARRAYS = ("sidx", "ridx", "far", "row_off", "edges", "fs_src", "fs_lidx")


@dataclasses.dataclass
class EAShards:
    """Per-shard windowed-EA geometry (leading axis D)."""

    sidx: torch.Tensor      # [D, T_l, W] int32 re-coded slab/far codes
    ridx: torch.Tensor      # [D, T_l, W] int32 tile-local receivers
    # GLOBAL sender rows (pad: dead), zone layout [local 0..Cl | remote
    # Cl..Cl+Cr)
    far: torch.Tensor       # [D, T_l, Cl + Cr] int32
    row_off: torch.Tensor   # [D, Nl + 1] int32 (absolute; differenced)
    edges: torch.Tensor     # [D, T_l, W, Fe] raw edge-feature windows
    # sender-sorted view of the LOCAL far zone (per SENDER tile): fs_src =
    # flat t_recv*Cf + rank, fs_lidx = the sender's tile-local row (tile
    # for pads), as GraphBatch.win_fs_*
    fs_src: torch.Tensor    # [D, T_l, Cs] int32
    fs_lidx: torch.Tensor   # [D, T_l, Cs] int32
    tile: int = 128
    width: int = 64
    n_shards: int = 1
    cf_local: int = 0

    def to(self, device) -> "EAShards":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _ARRAYS})


class _ShardView:
    """Stand-in for a GraphBatch holding one shard: exactly the attributes
    `make_ea_context` and the block read."""

    def __init__(self, shards: EAShards, d: int):
        self.band_tile = shards.tile
        self.band_width = shards.width
        self.win_sidx = shards.sidx[d]
        self.win_ridx = shards.ridx[d]
        self.win_far_tsend = shards.far[d]
        self.row_offsets = shards.row_off[d]
        self.win_fs_src = shards.fs_src[d]
        self.win_fs_lidx = shards.fs_lidx[d]
        self.win_edges = shards.edges[d]
        self.n_node_cap = shards.row_off.shape[1] - 1
        self.device = shards.sidx.device


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def shard_ea_batch(batch, n_shards: int, local_cap: int | None = None,
                   remote_cap: int | None = None,
                   fs_cap: int | None = None) -> EAShards:
    """Host-side: split a windowed banded batch into D tile ranges.

    In-slab sender codes are re-based onto each shard's LOCAL slab-start
    formula (slabs clamp at [0, Nl] as they clamp at [0, N] globally);
    senders outside a shard's local slab (boundary crossers) join the
    out-of-band rows in the per-tile far list, which keeps GLOBAL row ids.
    The caps pin the local/remote far-zone and fs-table capacities so
    every batch of a run shares one shape (`shard_caps`' run maxima)."""
    tile, width = batch.band_tile, batch.band_width
    assert batch.win_sidx is not None and batch.win_far_tsend is not None
    n = batch.n_node_cap
    assert n % (n_shards * tile) == 0, (n, n_shards, tile)
    nl = n // n_shards
    assert nl >= tile + width, (
        f"tile sharding needs >= {tile + width} rows (one slab) per "
        f"shard; got {nl} — grow n_node_cap or lower n_shards")
    t_l = nl // tile
    t_total = n // tile
    slab = tile + width
    w2 = width // 2
    dead = n - 1
    sent = int(FAR_SLOT_SENTINEL)

    sidx = _np(batch.win_sidx)
    ridx = _np(batch.win_ridx)
    far_g = _np(batch.win_far_tsend)
    ro = _np(batch.row_offsets)
    edges = _np(batch.win_edges)
    w_cap = sidx.shape[1]

    s_glob = np.clip(np.arange(t_total) * tile - w2, 0, max(n - slab, 0))
    s_loc = np.clip((np.arange(t_total) % t_l) * tile - w2, 0,
                    max(nl - slab, 0))

    # ---- phase 1: classify every window slot; per-tile far rows split
    # into LOCAL senders (this shard's rows: folded in-shard) and REMOTE
    # ones (their gradient goes back into the replicated x) ----
    new_sidx = np.full_like(sidx, sent)
    tile_slots: list = []
    far_loc: list[np.ndarray] = []
    far_rem: list[np.ndarray] = []
    for t in range(t_total):
        d = t // t_l
        codes = sidx[t]
        in_slab = codes < slab
        g_rows = s_glob[t] + np.where(in_slab, codes, 0)
        l_rows = g_rows - d * nl
        ok = in_slab & (l_rows >= s_loc[t]) & (l_rows < s_loc[t] + slab)
        new_sidx[t, ok] = (l_rows[ok] - s_loc[t]).astype(np.int32)
        crossers = in_slab & ~ok
        was_far = (codes >= slab) & (codes != sent)
        rows = np.concatenate([
            g_rows[crossers],
            far_g[t, codes[was_far] - slab],
        ])
        slots = np.concatenate([np.nonzero(crossers)[0],
                                np.nonzero(was_far)[0]])
        uniq = np.unique(rows)
        is_loc = (uniq >= d * nl) & (uniq < (d + 1) * nl)
        far_loc.append(uniq[is_loc])
        far_rem.append(uniq[~is_loc])
        tile_slots.append((slots, rows))

    cl = max((len(u) for u in far_loc), default=0)
    cr = max((len(u) for u in far_rem), default=0)
    cl = ((max(cl, 8) + 7) // 8) * 8
    cr = ((max(cr, 0) + 7) // 8) * 8  # 0 allowed (single shard)
    if local_cap is not None:
        assert local_cap >= cl, (local_cap, cl)
        cl = local_cap
    if remote_cap is not None:
        assert remote_cap >= cr, (remote_cap, cr)
        cr = remote_cap
    cf = cl + cr

    # ---- phase 2: extended-slab codes against the [local | remote] zone
    # layout; the sender-sorted fs tables over the LOCAL zone ----
    far = np.full((t_total, cf), dead, np.int32)
    fs_entries: list[list] = [[] for _ in range(t_total)]  # per SENDER tile
    for t in range(t_total):
        d = t // t_l
        loc, rem = far_loc[t], far_rem[t]
        far[t, : len(loc)] = loc
        far[t, cl: cl + len(rem)] = rem
        slots, rows = tile_slots[t]
        if len(slots):
            in_l = np.isin(rows, loc)
            pos_l = np.searchsorted(loc, rows)
            pos_r = np.searchsorted(rem, rows)
            code = np.where(in_l, pos_l, cl + pos_r)
            new_sidx[t, slots] = (slab + code).astype(np.int32)
        t_loc = t % t_l
        for rank, g in enumerate(loc):
            lrow = int(g) - d * nl
            ts = d * t_l + lrow // tile
            fs_entries[ts].append((t_loc * cf + rank, lrow % tile))

    cs = max((len(e) for e in fs_entries), default=0)
    cs = ((max(cs, 8) + 7) // 8) * 8
    if fs_cap is not None:
        assert fs_cap >= cs, (fs_cap, cs)
        cs = fs_cap
    fs_src = np.zeros((t_total, cs), np.int32)
    fs_lidx = np.full((t_total, cs), tile, np.int32)
    for ts, entries in enumerate(fs_entries):
        for c, (src, lidx) in enumerate(entries):
            fs_src[ts, c] = src
            fs_lidx[ts, c] = lidx

    fe = edges.shape[2]
    row_off = np.stack([ro[d * nl: (d + 1) * nl + 1]
                        for d in range(n_shards)])
    return EAShards(
        sidx=torch.from_numpy(new_sidx.reshape(n_shards, t_l, w_cap)),
        ridx=torch.from_numpy(ridx.reshape(n_shards, t_l, w_cap).copy()),
        far=torch.from_numpy(far.reshape(n_shards, t_l, cf)),
        row_off=torch.from_numpy(row_off.astype(np.int32)),
        edges=torch.from_numpy(
            edges.reshape(n_shards, t_l, w_cap, fe).copy()),
        fs_src=torch.from_numpy(fs_src.reshape(n_shards, t_l, cs)),
        fs_lidx=torch.from_numpy(fs_lidx.reshape(n_shards, t_l, cs)),
        tile=tile, width=width, n_shards=n_shards, cf_local=cl,
    )


def shard_caps(s: EAShards) -> tuple[int, int, int]:
    """(local_cap, remote_cap, fs_cap) of a built EAShards: feed the run
    maxima back into `shard_ea_batch` or `pad_ea_shards` so every batch of
    a run shares one shape."""
    cf = s.far.shape[-1]
    return s.cf_local, cf - s.cf_local, s.fs_src.shape[-1]


def pad_ea_shards(s: EAShards, local_cap: int, remote_cap: int,
                  fs_cap: int) -> EAShards:
    """Widen a built EAShards to run-unified caps without re-running the
    host classification loops; equal to ``shard_ea_batch(b, D, local_cap,
    remote_cap, fs_cap)`` on the same batch:

    - the far table's [local | remote] zones pad independently with the
      dead row, the remote zone sliding out to start at ``local_cap``;
    - window codes pointing into the remote zone (``>= slab + cl_old``,
      sentinel excluded) shift by the local zone's growth;
    - fs_src entries re-base from ``t_loc*cf_old + rank`` to the new ``cf``
      stride."""
    cl_old = s.cf_local
    cf_old = int(s.far.shape[-1])
    cr_old = cf_old - cl_old
    cs_old = int(s.fs_src.shape[-1])
    assert local_cap >= cl_old and remote_cap >= cr_old and \
        fs_cap >= cs_old, ((local_cap, remote_cap, fs_cap),
                           (cl_old, cr_old, cs_old))
    if (local_cap, remote_cap, fs_cap) == (cl_old, cr_old, cs_old):
        return s
    cf = local_cap + remote_cap
    d_sh, t_l = s.far.shape[0], s.far.shape[1]
    nl = int(s.row_off.shape[1]) - 1
    dead = nl * s.n_shards - 1
    slab = s.tile + s.width
    sent = int(FAR_SLOT_SENTINEL)

    sidx = _np(s.sidx).copy()
    remote = (sidx != sent) & (sidx >= slab + cl_old)
    sidx[remote] += local_cap - cl_old

    far = np.full((d_sh, t_l, cf), dead, np.int32)
    far_old = _np(s.far)
    far[:, :, :cl_old] = far_old[:, :, :cl_old]
    far[:, :, local_cap: local_cap + cr_old] = far_old[:, :, cl_old:]

    src_old = _np(s.fs_src)
    fs_src = np.zeros((d_sh, t_l, fs_cap), np.int32)
    fs_src[:, :, :cs_old] = (src_old // cf_old) * cf + (src_old % cf_old)
    fs_lidx = np.full((d_sh, t_l, fs_cap), s.tile, np.int32)
    fs_lidx[:, :, :cs_old] = _np(s.fs_lidx)

    dev = s.sidx.device
    return dataclasses.replace(
        s, sidx=torch.from_numpy(sidx).to(dev),
        far=torch.from_numpy(far).to(dev),
        fs_src=torch.from_numpy(fs_src).to(dev),
        fs_lidx=torch.from_numpy(fs_lidx).to(dev), cf_local=local_cap)


def _encode_edges(edges, encoder, dtype, param):
    """The 3-layer edge encoder (Models/BuckGNN.py:67-82) as plain ops on a
    shard's raw windows, each parameter through ``param`` first."""
    e = edges.to(dtype)
    lins = [getattr(encoder, k) for k in sorted(
        name for name, _ in encoder.named_children())]
    for i, lin in enumerate(lins):
        e = (e @ param(lin.weight).t().to(dtype)
             + param(lin.bias).to(dtype))
        if i + 1 < len(lins):
            e = torch.relu(e)
    return e


class _GatherRows(torch.autograd.Function):
    """all_gather of the ranks' [Nl, h] rows. Backward: this rank's rows of
    the cotangent, summed over the ranks first when ``partial`` (the
    gathered x feeds the next block, whose ranks each hold a share of its
    gradient) and as they are otherwise (the gathered x feeds the
    replicated rest of the model). all_reduce and a slice run on gloo and
    NCCL alike."""

    @staticmethod
    def forward(ctx, zx, group, d, partial):
        ctx.group, ctx.d, ctx.partial = group, d, partial
        return all_gather_rows(zx, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.partial:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        nl = g.shape[0] // dist.get_world_size(ctx.group)
        return g[ctx.d * nl:(ctx.d + 1) * nl], None, None, None


def layer_seed(seed, layer: int, shard: int):
    """The dropout seed words of one (layer, shard) from the stack's two
    words, as the JAX package derives them (ea_shard.py:352-359); None when
    nothing drops."""
    if seed is None:
        return None
    return ((int(seed[0]) + layer) & 0xFFFFFFFF,
            (int(seed[1]) + shard * 7919) & 0xFFFFFFFF)


def ea_tp_stack(x: torch.Tensor, shards: EAShards, blocks: list, encoder, *,
                rate: float, seed, deterministic: bool,
                mesh=None) -> torch.Tensor:
    """Run the fused EA block stack tile-sharded over the ``model`` dim of
    ``mesh`` (default: the current mesh; one shard without one).

    ``x``: the replicated [N, h] node state; ``blocks``: one GraphNetBlock
    per layer (the same module L times for EA_GNN_Shared); ``encoder``: the
    model's edge_encoder, run on this rank's raw windows. Returns the final
    node state [N, h], replicated."""
    from buckgnn_tpu_torch.ops.ea_block import (
        block_weights, fused_ea_block, make_ea_context,
    )

    group, size, d = model_dim(mesh)
    n_shards = shards.n_shards
    if size != n_shards:
        raise ValueError(
            f"EA tile sharding over {n_shards} shards needs a current mesh "
            f"whose 'model' dim has {n_shards} ranks (have {size})")
    nl = x.shape[0] // n_shards
    n_layers = len(blocks)
    view = _ShardView(shards, d)
    ctx = make_ea_context(view, far_grad="hybrid",
                          far_local=shards.cf_local)
    # each parameter and x enter the stack once: their gradients from this
    # rank's tiles are partial and are summed over the group there
    entered: dict = {}

    def param(p):
        if n_shards == 1:
            return p
        if id(p) not in entered:
            entered[id(p)] = sum_grads(p, group)
        return entered[id(p)]

    if n_shards > 1:
        x = sum_grads(x, group)
    x_loc = x[d * nl:(d + 1) * nl]
    e = _encode_edges(view.win_edges, encoder, x.dtype, param)
    for i in range(n_layers):
        zx, e = fused_ea_block(
            x_loc, e, blocks[i], ctx, skip=0 < i < n_layers - 1, rate=rate,
            seed=layer_seed(seed, i, d), deterministic=deterministic,
            far_grad="hybrid", far_local=shards.cf_local, x_full=x,
            weights=block_weights(blocks[i], x.dtype, param=param))
        x_loc = zx
        if n_shards > 1:
            x = _GatherRows.apply(zx, group, d, i < n_layers - 1)
        else:
            x = zx
    return x
