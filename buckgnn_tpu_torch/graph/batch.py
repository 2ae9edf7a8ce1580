"""Fixed-capacity graph batching for the banded SAGE path, as torch tensors.

The port of buckgnn_tpu/graph/batch.py. Packing is host NumPy exactly as
there; only the array type at the batch boundary changes: a `GraphBatch`
holds torch tensors on one device, with the same field names and the same
static fields as the JAX pytree. Padding follows the same contract:

- the last graph slot (``G_cap - 1``) is a reserved padding graph;
- the last node slot (``N_cap - 1``) is a reserved dead node; padding edges
  are dead-node self-loops, so aggregation over them only touches the dead
  row.

Carried: the core arrays, the banded decomposition (band / spill / spill2
lists, fused-spill geometry, the materialized int8 band), the supernode
star codes (``gcode``/``gacc``/``super_mask`` and the local windows
``gwin``/``lcode``/``lacc``) and the per-receiver-tile edge windows of the
edge-augmented models (``win_*``, graph/batch.py:588-684 of the JAX
package).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from buckgnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GraphData:
    """One host-side graph (NumPy). The unit produced by the data pipeline.

    ``senders``/``receivers`` already contain both directions of each
    undirected edge (the reference emits both directions,
    GraphCreate.py:417-422).
    """

    x: np.ndarray          # [n, F] float32 node features
    senders: np.ndarray    # [e] int32
    receivers: np.ndarray  # [e] int32
    edge_attr: np.ndarray  # [e, Fe] float32
    y: np.ndarray          # [Ty] graph target or [n, Ty] node target
    # Flat local index of the supernode (== n-1 when present), else -1.
    supernode: int = -1
    eigenvalue: float | None = None
    mode_shapes: np.ndarray | None = None
    file_path: str | None = None

    @property
    def n_node(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_edge(self) -> int:
        return int(self.senders.shape[0])


# tensor fields in declaration order; None marks an absent optional field
_TENSOR_FIELDS = (
    "nodes", "edges", "senders", "receivers", "node_graph", "node_mask",
    "edge_mask", "graph_mask", "y", "supernode_index", "row_offsets",
    "n_real_node", "band_senders", "band_receivers", "spill_senders",
    "spill_receivers", "spill2_senders", "spill2_receivers",
    "spill_offsets", "spill_lo", "spill_hi", "band", "gcode", "gacc",
    "super_mask", "gwin", "lcode", "lacc", "win_edges", "win_sidx",
    "win_ridx", "win_far_pos", "win_far_send", "win_far_tsend", "win_fs_src",
    "win_fs_lidx",
)


@dataclasses.dataclass
class GraphBatch:
    """Device-side fixed-capacity batch of torch tensors (field meanings as
    in buckgnn_tpu/graph/batch.py::GraphBatch)."""

    nodes: torch.Tensor            # [N_cap, F] float32
    edges: torch.Tensor            # [E_cap, Fe] float32
    senders: torch.Tensor          # [E_cap] int32
    receivers: torch.Tensor        # [E_cap] int32 (ascending)
    node_graph: torch.Tensor       # [N_cap] int32 (pad nodes -> G_cap-1)
    node_mask: torch.Tensor        # [N_cap] bool
    edge_mask: torch.Tensor        # [E_cap] bool
    graph_mask: torch.Tensor       # [G_cap] bool
    y: torch.Tensor                # [G_cap, Ty] or [N_cap, Ty]
    supernode_index: torch.Tensor  # [G_cap] int32 (dead node for absent)
    row_offsets: torch.Tensor      # [N_cap+1] int32 CSR offsets
    n_real_node: torch.Tensor      # [G_cap] int32
    band_senders: torch.Tensor | None = None     # [Eb] in-band edges
    band_receivers: torch.Tensor | None = None   # [Eb]
    spill_senders: torch.Tensor | None = None    # [Es] out-of-band edges
    spill_receivers: torch.Tensor | None = None  # [Es]
    spill2_senders: torch.Tensor | None = None   # [E2] per-tile overflow
    spill2_receivers: torch.Tensor | None = None  # [E2]
    spill_offsets: torch.Tensor | None = None    # [n_tiles+1] int32
    spill_lo: torch.Tensor | None = None         # [n_tiles, T, 1] int32
    spill_hi: torch.Tensor | None = None         # [n_tiles, T, 1] int32
    # [N_cap, T+W] int8 adjacency counts (stored 2D like the JAX batch;
    # row block t*T:(t+1)*T is node tile t's [T, T+W] band)
    band: torch.Tensor | None = None
    gcode: torch.Tensor | None = None       # [n_tiles, T, 1] int32
    gacc: torch.Tensor | None = None        # [n_tiles, 1, T] int32
    super_mask: torch.Tensor | None = None  # [N] float32
    gwin: torch.Tensor | None = None        # [n_tiles] int32
    lcode: torch.Tensor | None = None       # [n_tiles, T, 1] int32
    lacc: torch.Tensor | None = None        # [n_tiles, 1, T] int32
    # per-receiver-tile edge windows (edge-augmented models): edges are
    # receiver-sorted, so node tile t owns one contiguous run of them,
    # reshaped into W slots. win_sidx is the sender's code in the tile's
    # EXTENDED slab: its x-slab offset, slab + rank for an out-of-band
    # ("far") sender whose global id is win_far_tsend[t, rank], and
    # FAR_SLOT_SENTINEL for pads; win_ridx the receiver's offset in the
    # tile (T for pads). win_far_pos/send are the flat [t*W + w]
    # positions and senders of the far edges; win_fs_src/lidx the same far
    # rows grouped by sender tile (flat index t*Ct + rank, sender's local
    # row; T for pads).
    win_edges: torch.Tensor | None = None      # [n_tiles, W, Fe]
    win_sidx: torch.Tensor | None = None       # [n_tiles, W] int32
    win_ridx: torch.Tensor | None = None       # [n_tiles, W] int32
    win_far_pos: torch.Tensor | None = None    # [F_cap] int32
    win_far_send: torch.Tensor | None = None   # [F_cap] int32
    win_far_tsend: torch.Tensor | None = None  # [n_tiles, Ct] int32
    win_fs_src: torch.Tensor | None = None     # [n_tiles, Cs] int32
    win_fs_lidx: torch.Tensor | None = None    # [n_tiles, Cs] int32
    # static metadata
    band_tile: int | None = None
    band_width: int | None = None
    has_supernode_edges: bool = False
    has_spill_edges: bool = True
    has_spill2_edges: bool = True
    # the multi-device shards (parallel/partitioned.py::PartitionedBatch,
    # parallel/ea_shard.py::EAShards) that train_gnn attaches for
    # segment_impl="banded_partitioned"; packing never sets them
    part: object | None = None
    ea_part: object | None = None

    @property
    def n_node_cap(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_edge_cap(self) -> int:
        return self.senders.shape[0]

    @property
    def n_graph_cap(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        device = torch.device(device)
        shards = {f: getattr(self, f).to(device) for f in ("part", "ea_part")
                  if getattr(self, f) is not None}
        return self.replace(**{
            f: getattr(self, f).to(device)
            for f in _TENSOR_FIELDS if getattr(self, f) is not None
        }, **shards)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def capacity_for(
    graphs: Sequence[GraphData],
    node_multiple: int = 8,
    edge_multiple: int = 128,
) -> tuple[int, int, int]:
    """Pick (N_cap, E_cap, G_cap) for a list of graphs (+1 dead node, +1
    padding graph)."""
    n = sum(g.n_node for g in graphs) + 1
    e = sum(g.n_edge for g in graphs)
    return (
        _round_up(n, node_multiple),
        max(_round_up(e, edge_multiple), edge_multiple),
        len(graphs) + 1,
    )


# Fused-spill geometry (same constants as the JAX package: per node tile
# one SPILL_CHUNK-row window of receiver-sorted spill messages, start
# aligned down to SPILL_ALIGN rows).
SPILL_CHUNK = 256
SPILL_ALIGN = 16

# Rows per half of the per-tile local star-table window (gwin/lcode/lacc).
LOCAL_STAR_ROWS = 16

# win_sidx code of a pad slot: no slab + far extension reaches it, so
# widening W or Ct across a run never turns a pad into a real slot.
FAR_SLOT_SENTINEL = np.int32(1 << 30)


def star_table_geometry(g_cap: int) -> tuple[int, int]:
    """(T0, tg) for the supernode star correction table: broadcast rows at
    [0, g_cap), star-sum rows at [T0, T0 + g_cap), T0 = round8(g_cap);
    tg = 2*T0 doubles as the sentinel code that selects nothing."""
    t0 = ((g_cap + 7) // 8) * 8
    return t0, 2 * t0


_SPILL_TILE_CAP = SPILL_CHUNK - SPILL_ALIGN + 1
_SPILL_TILE_CAP_LAST = _SPILL_TILE_CAP - 127


def _band_split(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_valid: np.ndarray,
    supernode_index: np.ndarray,
    n_real_node: np.ndarray,
    node_graph: np.ndarray,
    n_node_cap: int,
    tile: int,
    width: int,
    analytic_supernode: bool = True,
):
    """Split edges into (band, spill, spill-overflow, supernode-star)
    classes. Returns (band_s, band_r, spill_s, spill_r, spill2_s, spill2_r,
    has_super_edges), every list padded to a multiple of 128 with dead-node
    self-loops (the main spill list to at least SPILL_CHUNK)."""
    dead = n_node_cap - 1
    slab = tile + width
    is_super = np.zeros(n_node_cap, dtype=bool)
    real_super = supernode_index < dead
    is_super[supernode_index[real_super]] = True

    touches_super = is_super[senders] | is_super[receivers]
    has_super_edges = False
    super_edge = np.zeros_like(touches_super)
    if analytic_supernode and touches_super.any():
        # only a FULL star (2*(n_g - 1) directed edges) takes the analytic
        # path
        count = np.zeros(len(supernode_index), dtype=np.int64)
        gids = node_graph[
            np.where(is_super[senders], receivers, senders)
        ]
        np.add.at(count, gids[touches_super & edge_valid], 1)
        expected = np.where(real_super, 2 * (n_real_node - 1), 0)
        if np.array_equal(count, expected):
            has_super_edges = True
            super_edge = touches_super & edge_valid

    cand = edge_valid & ~super_edge
    t = receivers // tile
    start = np.clip(t * tile - width // 2, 0, max(n_node_cap - slab, 0))
    k = senders - start
    inband = cand & (k >= 0) & (k < slab)
    spill = cand & ~inband

    def pad_sorted(s, r, k=None, min_len=128):
        order = (np.argsort(r, kind="stable") if k is None
                 else np.lexsort((k, r)))
        s, r = s[order], r[order]
        n = len(s)
        m = max(_round_up(n, 128), min_len)
        ps = np.full(m, dead, np.int32)
        pr = np.full(m, dead, np.int32)
        ps[:n], pr[:n] = s, r
        return ps, pr

    band_s, band_r = pad_sorted(senders[inband], receivers[inband],
                                k[inband])

    sp_s, sp_r = senders[spill], receivers[spill]
    order = np.argsort(sp_r, kind="stable")
    sp_s, sp_r = sp_s[order], sp_r[order]
    tiles = sp_r // tile
    n_tiles = n_node_cap // tile
    caps = np.full(n_tiles, _SPILL_TILE_CAP, np.int64)
    caps[n_tiles - 1] = _SPILL_TILE_CAP_LAST
    first = np.searchsorted(tiles, np.arange(n_tiles))
    rank = np.arange(len(sp_r)) - first[tiles]
    main = rank < caps[tiles]
    spill_s, spill_r = pad_sorted(sp_s[main], sp_r[main],
                                  min_len=SPILL_CHUNK)
    spill2_s, spill2_r = pad_sorted(sp_s[~main], sp_r[~main])
    return (band_s, band_r, spill_s, spill_r, spill2_s, spill2_r,
            has_super_edges)


def _host_spill_ranges(spill_r: np.ndarray, n_node_cap: int, tile: int):
    """Window offsets + per-node [lo, hi) column ranges of the fused spill."""
    n_tiles = n_node_cap // tile
    es = len(spill_r)
    off = np.searchsorted(
        spill_r, np.arange(n_tiles + 1) * tile
    ).astype(np.int32)
    win = np.clip((off[:-1] // SPILL_ALIGN) * SPILL_ALIGN,
                  0, es - SPILL_CHUNK)
    # every tile's REAL spill rows must fit its window (dead-node padding
    # rows sort last and are exempt)
    real_stop = np.searchsorted(spill_r, n_node_cap - 1, "left")
    assert np.all(np.minimum(off[1:], real_stop) - win <= SPILL_CHUNK), (
        "spill window overflow: a tile's spill rows exceed its window"
    )
    ids = np.arange(n_node_cap)
    lo = np.searchsorted(spill_r, ids, "left").reshape(n_tiles, tile)
    hi = np.searchsorted(spill_r, ids, "right").reshape(n_tiles, tile)
    lo = np.clip(lo - win[:, None], 0, SPILL_CHUNK)
    hi = np.clip(hi - win[:, None], 0, SPILL_CHUNK)
    return (off, lo.astype(np.int32)[..., None],
            hi.astype(np.int32)[..., None])


def _host_band_matrix(band_s: np.ndarray, band_r: np.ndarray,
                      n_node_cap: int, tile: int, width: int) -> np.ndarray:
    """[n_tiles, T, S] int8 adjacency counts. Pad self-loops all stack on
    one dead-node cell and are clipped to 127 (the dead row is never read
    back); any other count above 127 fails loudly."""
    slab = tile + width
    n_tiles = n_node_cap // tile
    t = band_r // tile
    start = np.clip(t * tile - width // 2, 0, max(n_node_cap - slab, 0))
    k = band_s - start
    band = np.zeros(n_node_cap * slab, dtype=np.int32)
    np.add.at(band, band_r.astype(np.int64) * slab + k, 1)
    dead_cell = (n_node_cap - 1) * slab + ((n_node_cap - 1) - np.clip(
        ((n_node_cap - 1) // tile) * tile - width // 2,
        0, max(n_node_cap - slab, 0)))
    live = band > 127
    live[dead_cell] = False
    assert not live.any(), (
        "band overflow: >127 duplicate edges between one (sender, receiver) "
        "pair cannot be represented in the int8 band"
    )
    return np.minimum(band, 127).astype(np.int8).reshape(n_tiles, tile, slab)


def _star_codes(node_graph, node_mask, supernode_index, n_node_cap,
                n_graph_cap, band_tile) -> dict:
    """Supernode star codes (gcode/gacc/super_mask) and, when every tile's
    graph span fits LOCAL_STAR_ROWS, the local windows gwin/lcode/lacc."""
    dead = n_node_cap - 1
    t0, tg = star_table_geometry(n_graph_cap)
    is_super = np.zeros(n_node_cap, dtype=bool)
    real_super = supernode_index < dead
    is_super[supernode_index[real_super]] = True
    graph_has = np.zeros(n_graph_cap, dtype=bool)
    graph_has[np.nonzero(real_super)[0]] = True
    member = graph_has[node_graph] & node_mask & ~is_super
    g = node_graph.astype(np.int64)
    gcode = np.where(member, g, np.where(is_super, t0 + g, tg))
    gacc = np.where(is_super, g, np.where(node_mask, t0 + g, tg))
    n_tiles = n_node_cap // band_tile
    out = dict(
        gcode=gcode.astype(np.int32).reshape(n_tiles, band_tile, 1),
        gacc=gacc.astype(np.int32).reshape(n_tiles, 1, band_tile),
        super_mask=member.astype(np.float32),
    )
    gw = min(LOCAL_STAR_ROWS, t0)
    coded = (gcode != tg) | (gacc != tg)
    gv = np.where(coded, g, np.iinfo(np.int64).max).reshape(
        n_tiles, band_tile)
    gx = np.where(coded, g, -1).reshape(n_tiles, band_tile)
    gmin, gmax = gv.min(axis=1), gx.max(axis=1)
    nonempty = gmax >= 0
    base = np.where(nonempty, (np.minimum(gmin, gmax) // 8) * 8, 0)
    span = np.where(nonempty, gmax - base + 1, 0)
    if int(span.max(initial=0)) <= gw:
        wb = np.clip(base, 0, t0 - gw).astype(np.int64)
        rel = g - np.repeat(wb, band_tile)
        lcode = np.where(member, rel, np.where(is_super, gw + rel, 2 * gw))
        lacc = np.where(is_super, rel, np.where(node_mask, gw + rel, 2 * gw))
        out.update(
            gwin=wb.astype(np.int32),
            lcode=lcode.astype(np.int32).reshape(n_tiles, band_tile, 1),
            lacc=lacc.astype(np.int32).reshape(n_tiles, 1, band_tile),
        )
    return out


def _edge_windows(senders, receivers, edges, edge_mask, n_node_cap,
                  band_tile, band_width, np_dtype) -> dict:
    """The ``win_*`` fields: receiver-tile windows of W slots (W the
    largest tile's valid-edge count, rounded up to 8), extended-slab sender
    codes, the flat far list, the far rows tiled by receiver under a cap
    Ct and grouped by sender tile under a cap Cs."""
    assert band_width <= band_tile, (
        f"edge windows need band_width <= band_tile ({band_width} > "
        f"{band_tile}): a slab then overlaps only its neighbour tiles")
    n_tiles = n_node_cap // band_tile
    slab = band_tile + band_width
    dead = n_node_cap - 1
    tile_of = receivers // band_tile
    counts = np.bincount(tile_of[edge_mask], minlength=n_tiles)
    w_cap = ((max(int(counts.max(initial=0)), 8) + 7) // 8) * 8
    w_edges = np.zeros((n_tiles, w_cap, edges.shape[1]), dtype=np_dtype)
    w_sidx = np.full((n_tiles, w_cap), FAR_SLOT_SENTINEL, dtype=np.int32)
    w_ridx = np.full((n_tiles, w_cap), band_tile, dtype=np.int32)
    starts = np.clip(np.arange(n_tiles) * band_tile - band_width // 2,
                     0, max(n_node_cap - slab, 0))
    idx_v = np.nonzero(edge_mask)[0]  # receiver-ascending by packing
    t_val = tile_of[idx_v]
    off = np.zeros(n_tiles + 1, dtype=np.int64)
    off[1:] = np.cumsum(counts)
    pos = np.arange(len(idx_v)) - off[t_val]
    w_edges[t_val, pos] = edges[idx_v]
    loc = senders[idx_v].astype(np.int64) - starts[t_val]
    inb = (loc >= 0) & (loc < slab)
    w_sidx[t_val, pos] = np.where(inb, loc, slab).astype(np.int32)
    w_ridx[t_val, pos] = (receivers[idx_v] - t_val * band_tile).astype(
        np.int32)
    far = ~inb
    f_cnt = int(far.sum())
    f_cap = ((max(f_cnt, 8) + 511) // 512) * 512
    # pad positions lie past the window buffer on purpose
    far_pos = np.full((f_cap,), n_tiles * w_cap, dtype=np.int32)
    far_send = np.full((f_cap,), dead, dtype=np.int32)
    far_pos[:f_cnt] = (t_val[far] * w_cap + pos[far]).astype(np.int32)
    far_send[:f_cnt] = senders[idx_v][far]
    # far rows per receiver tile (rank within the tile), re-coded in
    # win_sidx as slab + rank; t_val[far] ascends
    t_far = t_val[far]
    per_tile = np.bincount(t_far, minlength=n_tiles)
    ct_cap = ((max(int(per_tile.max(initial=0)), 8) + 7) // 8) * 8
    far_tsend = np.full((n_tiles, ct_cap), dead, np.int32)
    cs_cap = 8
    fs_src = np.zeros((n_tiles, cs_cap), np.int32)
    fs_lidx = np.full((n_tiles, cs_cap), band_tile, np.int32)
    if f_cnt:
        ranks = np.arange(f_cnt) - np.searchsorted(t_far, t_far)
        far_tsend[t_far, ranks] = senders[idx_v][far]
        w_sidx[t_far, pos[far]] = (slab + ranks).astype(np.int32)
        f_send = senders[idx_v][far]
        k_flat = (t_far * ct_cap + ranks).astype(np.int64)
        s_tile_of = f_send // band_tile
        order = np.argsort(s_tile_of, kind="stable")
        fs_k = k_flat[order]
        fs_t = s_tile_of[order]
        fs_l = f_send[order] - fs_t * band_tile
        cnt_s = np.bincount(fs_t, minlength=n_tiles)
        cs_cap = ((max(int(cnt_s.max(initial=0)), 8) + 7) // 8) * 8
        fs_src = np.zeros((n_tiles, cs_cap), np.int32)
        fs_lidx = np.full((n_tiles, cs_cap), band_tile, np.int32)
        ranks_s = np.arange(len(fs_t)) - np.searchsorted(fs_t, fs_t)
        fs_src[fs_t, ranks_s] = fs_k.astype(np.int32)
        fs_lidx[fs_t, ranks_s] = fs_l.astype(np.int32)
    return dict(win_fs_src=fs_src, win_fs_lidx=fs_lidx, win_edges=w_edges,
                win_sidx=w_sidx, win_ridx=w_ridx, win_far_pos=far_pos,
                win_far_send=far_send, win_far_tsend=far_tsend)


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in arrays.items()}


def pack_graphs(
    graphs: Sequence[GraphData],
    n_node_cap: int,
    n_edge_cap: int,
    n_graph_cap: int,
    np_dtype=np.float32,
    band_width: int | None = None,
    band_tile: int = 256,
    materialize_band: bool = True,
    analytic_supernode: bool = True,
    device=None,
) -> GraphBatch:
    """Pack host graphs into one fixed-capacity `GraphBatch` on ``device``
    (the CUDA card unless ``device="cpu"``)."""
    device = resolve_device(device)
    n_real = sum(g.n_node for g in graphs)
    e_real = sum(g.n_edge for g in graphs)
    if n_real + 1 > n_node_cap:
        raise ValueError(
            f"node overflow: {n_real} real nodes + dead node > cap {n_node_cap}"
        )
    if e_real > n_edge_cap:
        raise ValueError(f"edge overflow: {e_real} > cap {n_edge_cap}")
    if len(graphs) + 1 > n_graph_cap:
        raise ValueError(f"graph overflow: {len(graphs)} + pad > cap {n_graph_cap}")

    f_dim = graphs[0].x.shape[1]
    fe_dim = graphs[0].edge_attr.shape[1] if graphs[0].edge_attr.ndim == 2 else 0
    node_level_y = graphs[0].y.ndim == 2

    dead = n_node_cap - 1
    pad_graph = n_graph_cap - 1

    nodes = np.zeros((n_node_cap, f_dim), dtype=np_dtype)
    edges = np.zeros((n_edge_cap, fe_dim), dtype=np_dtype)
    senders = np.full((n_edge_cap,), dead, dtype=np.int32)
    receivers = np.full((n_edge_cap,), dead, dtype=np.int32)
    node_graph = np.full((n_node_cap,), pad_graph, dtype=np.int32)
    node_mask = np.zeros((n_node_cap,), dtype=bool)
    edge_mask = np.zeros((n_edge_cap,), dtype=bool)
    graph_mask = np.zeros((n_graph_cap,), dtype=bool)
    supernode_index = np.full((n_graph_cap,), dead, dtype=np.int32)
    n_real_node = np.zeros((n_graph_cap,), dtype=np.int32)

    ty = graphs[0].y.shape[-1] if graphs[0].y.ndim >= 1 else 1
    if node_level_y:
        y = np.zeros((n_node_cap, ty), dtype=np_dtype)
    else:
        y = np.zeros((n_graph_cap, ty), dtype=np_dtype)

    node_off = 0
    edge_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.n_node, g.n_edge
        nodes[node_off: node_off + n] = g.x
        node_graph[node_off: node_off + n] = gi
        node_mask[node_off: node_off + n] = True
        graph_mask[gi] = True
        n_real_node[gi] = n
        if g.supernode >= 0:
            supernode_index[gi] = node_off + g.supernode
        if e:
            senders[edge_off: edge_off + e] = g.senders + node_off
            receivers[edge_off: edge_off + e] = g.receivers + node_off
            if fe_dim:
                edges[edge_off: edge_off + e] = g.edge_attr
            edge_mask[edge_off: edge_off + e] = True
        if node_level_y:
            y[node_off: node_off + n] = np.reshape(g.y, (n, ty))
        else:
            y[gi] = np.reshape(np.asarray(g.y, dtype=np_dtype), (ty,))
        node_off += n
        edge_off += e

    # receiver-sort all edges (padding targets the dead node, sorted last)
    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]
    edges = edges[order]
    edge_mask = edge_mask[order]
    row_offsets = np.zeros((n_node_cap + 1,), dtype=np.int32)
    np.cumsum(np.bincount(receivers, minlength=n_node_cap), out=row_offsets[1:])

    arrays = dict(
        nodes=nodes, edges=edges, senders=senders, receivers=receivers,
        node_graph=node_graph, node_mask=node_mask, edge_mask=edge_mask,
        graph_mask=graph_mask, y=y, supernode_index=supernode_index,
        row_offsets=row_offsets, n_real_node=n_real_node,
    )
    static: dict = {}
    if band_width is not None:
        if n_node_cap % band_tile:
            raise ValueError(
                f"banded packing needs n_node_cap % {band_tile} == 0"
            )
        if n_node_cap < band_tile + band_width:
            raise ValueError("n_node_cap smaller than one slab")
        bs, br, ss, sr, ss2, sr2, has_super = _band_split(
            senders, receivers, edge_mask, supernode_index, n_real_node,
            node_graph, n_node_cap, band_tile, band_width,
            analytic_supernode=analytic_supernode,
        )
        s_off, s_lo, s_hi = _host_spill_ranges(sr, n_node_cap, band_tile)
        if has_super:
            arrays.update(_star_codes(node_graph, node_mask,
                                      supernode_index, n_node_cap,
                                      n_graph_cap, band_tile))
        arrays.update(
            band_senders=bs, band_receivers=br,
            spill_senders=ss, spill_receivers=sr,
            spill2_senders=ss2, spill2_receivers=sr2,
            spill_offsets=s_off, spill_lo=s_lo, spill_hi=s_hi,
        )
        if fe_dim:
            arrays.update(_edge_windows(senders, receivers, edges, edge_mask,
                                        n_node_cap, band_tile, band_width,
                                        np_dtype))
        if materialize_band:
            arrays["band"] = _host_band_matrix(
                bs, br, n_node_cap, band_tile, band_width,
            ).reshape(n_node_cap, band_tile + band_width)
        static = dict(
            band_tile=band_tile,
            band_width=band_width,
            has_supernode_edges=has_super,
            has_spill_edges=bool(np.any(sr != n_node_cap - 1)),
            has_spill2_edges=bool(np.any(sr2 != n_node_cap - 1)),
        )
    return GraphBatch(**_tensors(arrays, device), **static)


def _pad_spill_to(b: GraphBatch, es_cap: int, e2_cap: int,
                  eb_cap: int = 0) -> GraphBatch:
    """Grow a batch's band / spill / spill2 edge lists to run-uniform
    capacities with dead-node self-loop rows, recomputing the fused-spill
    window geometry. Padding rows are inert."""
    kw = {}
    dead = b.n_node_cap - 1
    dev = b.device

    def grown(t: torch.Tensor, cap: int) -> np.ndarray:
        out = np.full(cap, dead, np.int32)
        out[: t.shape[0]] = t.cpu().numpy()
        return out

    if eb_cap > int(b.band_senders.shape[0]):
        kw.update(_tensors(dict(
            band_senders=grown(b.band_senders, eb_cap),
            band_receivers=grown(b.band_receivers, eb_cap)), dev))
    if es_cap > int(b.spill_senders.shape[0]):
        sr = grown(b.spill_receivers, es_cap)
        off, lo, hi = _host_spill_ranges(sr, b.n_node_cap, b.band_tile)
        kw.update(_tensors(dict(
            spill_senders=grown(b.spill_senders, es_cap),
            spill_receivers=sr, spill_offsets=off, spill_lo=lo,
            spill_hi=hi), dev))
    if e2_cap > int(b.spill2_senders.shape[0]):
        kw.update(_tensors(dict(
            spill2_senders=grown(b.spill2_senders, e2_cap),
            spill2_receivers=grown(b.spill2_receivers, e2_cap)), dev))
    return b.replace(**kw) if kw else b


def batch_iterator(
    dataset: Sequence[GraphData],
    batch_size: int,
    n_node_cap: int,
    n_edge_cap: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    band_width: int | None = None,
    band_tile: int = 256,
    rcm: bool = False,
    materialize_band: bool = True,
    analytic_supernode: bool = True,
    min_win_cap: int = 0,
    min_far_cap: int = 0,
    min_far_tile_cap: int = 0,
    min_fs_cap: int = 0,
    min_spill_cap: int = 0,
    min_spill2_cap: int = 0,
    min_band_cap: int = 0,
    local_star_windows: bool = True,
    device=None,
) -> Iterator[GraphBatch]:
    """Yield fixed-shape GraphBatches on ``device`` (the DataLoader role).

    ``rcm=True`` relabels each graph with a reverse Cuthill-McKee order
    before packing. With ``band_width`` set the whole dataset is packed
    first: spill flags and edge-list capacities are made run-uniform, and
    the local star windows are kept only if every batch has them, and the
    edge windows' caps (W, F, Ct, Cs) are padded to the run's maxima (or
    the ``min_*_cap`` floors).
    """
    device = resolve_device(device)
    if rcm:
        from buckgnn_tpu_torch.graph.build import rcm_reorder

        dataset = [rcm_reorder(g) for g in dataset]
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    def pack(cur):
        return pack_graphs(cur, n_node_cap, n_edge_cap, batch_size + 1,
                           band_width=band_width, band_tile=band_tile,
                           materialize_band=materialize_band,
                           analytic_supernode=analytic_supernode,
                           device=device)

    def packed():
        cur: list[GraphData] = []
        cur_nodes = 0
        cur_edges = 0
        for i in idx:
            g = dataset[int(i)]
            if g.n_node + 1 > n_node_cap or g.n_edge > n_edge_cap:
                raise ValueError(
                    f"graph with {g.n_node} nodes / {g.n_edge} edges exceeds "
                    f"capacity ({n_node_cap}, {n_edge_cap})"
                )
            would_overflow = (
                len(cur) == batch_size
                or cur_nodes + g.n_node + 1 > n_node_cap
                or cur_edges + g.n_edge > n_edge_cap
            )
            if cur and would_overflow:
                yield pack(cur)
                cur, cur_nodes, cur_edges = [], 0, 0
            cur.append(g)
            cur_nodes += g.n_node
            cur_edges += g.n_edge
        if cur and not drop_remainder:
            yield pack(cur)

    if band_width is None:
        yield from packed()
        return
    batches = list(packed())
    any_spill = any(b.has_spill_edges for b in batches)
    any_spill2 = any(b.has_spill2_edges for b in batches)
    es_cap = max(max(int(b.spill_senders.shape[0]) for b in batches),
                 min_spill_cap)
    e2_cap = max(max(int(b.spill2_senders.shape[0]) for b in batches),
                 min_spill2_cap)
    eb_cap = max(max(int(b.band_senders.shape[0]) for b in batches),
                 min_band_cap)
    batches = [_pad_spill_to(b, es_cap, e2_cap, eb_cap) for b in batches]
    # local star windows are all-or-nothing across the run
    if not local_star_windows or any(
        b.gcode is not None and b.gwin is None for b in batches
    ):
        batches = [
            b.replace(gwin=None, lcode=None, lacc=None) for b in batches
        ]
    caps = None
    if batches and batches[0].win_edges is not None:
        caps = (
            max(max(b.win_edges.shape[1] for b in batches), min_win_cap),
            max(max(b.win_far_pos.shape[0] for b in batches), min_far_cap),
            max(max(b.win_far_tsend.shape[1] for b in batches),
                min_far_tile_cap),
            max(max(b.win_fs_src.shape[1] for b in batches), min_fs_cap),
        )
    for b in batches:
        if caps is not None:
            b = _pad_windows_to(b, *caps)
        yield b.replace(has_spill_edges=any_spill,
                        has_spill2_edges=any_spill2)


def _pad_windows_to(b: GraphBatch, w_max: int, f_max: int, ct_max: int,
                    cs_max: int) -> GraphBatch:
    """Grow a batch's edge windows to run-uniform caps: W slots and F far
    entries with inert pads, Ct far rows per tile (dead-node senders; the
    flat win_fs_src indices re-strided to the new Ct) and Cs sender-tile
    rows (local row T)."""
    kw = {}
    nt = b.win_edges.shape[0]
    dead = b.n_node_cap - 1
    i32 = dict(dtype=torch.int32, device=b.device)
    ct_old = b.win_far_tsend.shape[1]
    if ct_old < ct_max:
        kw["win_far_tsend"] = torch.cat(
            [b.win_far_tsend, torch.full((nt, ct_max - ct_old), dead, **i32)],
            dim=1)
        kw["win_fs_src"] = ((b.win_fs_src // ct_old) * ct_max
                            + b.win_fs_src % ct_old).to(torch.int32)
    cs_old = b.win_fs_src.shape[1]
    if cs_old < cs_max:
        src = kw.get("win_fs_src", b.win_fs_src)
        kw["win_fs_src"] = torch.cat(
            [src, torch.zeros((nt, cs_max - cs_old), **i32)], dim=1)
        kw["win_fs_lidx"] = torch.cat(
            [b.win_fs_lidx,
             torch.full((nt, cs_max - cs_old), b.band_tile, **i32)], dim=1)
    w_old = b.win_edges.shape[1]
    if w_old < w_max:
        dw = w_max - w_old
        kw.update(
            win_edges=torch.cat([b.win_edges, b.win_edges.new_zeros(
                (nt, dw, b.win_edges.shape[2]))], dim=1),
            win_sidx=torch.cat([b.win_sidx, torch.full(
                (nt, dw), int(FAR_SLOT_SENTINEL), **i32)], dim=1),
            win_ridx=torch.cat([b.win_ridx, torch.full(
                (nt, dw), b.band_tile, **i32)], dim=1))
        # flat far positions re-derived for the wider W; pads stay past
        # the buffer
        fp = b.win_far_pos
        pad = b.win_far_send == dead
        kw["win_far_pos"] = torch.where(
            pad, torch.full_like(fp, nt * w_max),
            (fp // w_old) * w_max + fp % w_old).to(torch.int32)
    f_old = b.win_far_pos.shape[0]
    if f_old < f_max:
        fp = kw.get("win_far_pos", b.win_far_pos)
        kw["win_far_pos"] = torch.cat(
            [fp, torch.full((f_max - f_old,), nt * w_max, **i32)])
        kw["win_far_send"] = torch.cat(
            [b.win_far_send, torch.full((f_max - f_old,), dead, **i32)])
    return b.replace(**kw) if kw else b


def select_band_geometry(
    dataset: Sequence[GraphData],
    tile: int = 256,
    widths: Sequence[int] = (64, 128, 256),
    target_spill: float = 0.05,
    sample: int = 64,
    seed: int = 0,
    rcm: bool = True,
    analytic_supernode: bool = True,
) -> tuple[int, int]:
    """Pick (band_tile, band_width): the smallest width whose mesh-edge
    spill fraction over a sample of (RCM-ordered) graphs stays within
    ``target_spill``, else the largest."""
    from buckgnn_tpu_torch.graph.build import _virtual_edge_mask, rcm_reorder
    from buckgnn_tpu_torch.utils import native

    if not len(dataset):
        return tile, widths[-1]
    rng_ = np.random.default_rng(seed)
    idx = rng_.permutation(len(dataset))[: min(sample, len(dataset))]
    graphs = [dataset[int(i)] for i in idx]
    if rcm:
        graphs = [rcm_reorder(g) for g in graphs]
    for width in widths:
        total = in_band = 0
        for g in graphs:
            s = np.asarray(g.senders, dtype=np.int64)
            r = np.asarray(g.receivers, dtype=np.int64)
            # random virtual edges spill at any width: size the band for
            # the mesh edges
            mesh_only = ~_virtual_edge_mask(g)
            s, r = s[mesh_only], r[mesh_only]
            if analytic_supernode and g.supernode >= 0:
                # full supernode stars never enter the band
                touches = (s == g.supernode) | (r == g.supernode)
                if int(touches.sum()) == 2 * (g.n_node - 1):
                    s, r = s[~touches], r[~touches]
            if not len(s):
                continue
            pos = np.arange(g.n_node, dtype=np.int64)
            frac = native.band_fraction(s, r, pos, g.n_node, tile, width)
            in_band += frac * len(s)
            total += len(s)
        if total == 0 or in_band / total >= 1.0 - target_spill:
            return tile, int(width)
    return tile, int(widths[-1])


def suggest_capacities(
    dataset: Sequence[GraphData], batch_size: int, slack: float = 1.05
) -> tuple[int, int]:
    """Choose (N_cap, E_cap) so that a typical batch of `batch_size` fits."""
    mean_nodes = float(np.mean([g.n_node for g in dataset]))
    mean_edges = float(np.mean([g.n_edge for g in dataset]))
    max_nodes = max(g.n_node for g in dataset)
    max_edges = max(g.n_edge for g in dataset)
    n_cap = max(int(mean_nodes * batch_size * slack) + 1, max_nodes + 1)
    e_cap = max(int(mean_edges * batch_size * slack), max_edges)
    return _round_up(n_cap, 8), _round_up(e_cap, 128)
