"""The port's EA edge windows (buckgnn_tpu_torch.graph.batch, win_*) and
window geometry (ops/ea_windowed.py, ops/ea_block.py::make_ea_context).

Packing is NumPy on both sides, so every window field must equal the JAX
`pack_graphs` / `batch_iterator` output exactly, including the run-wide
regrowth of the caps W, F, Ct (with the re-strided ``win_fs_src``) and
Cs. The flattened context the fused block reads is checked against a
direct walk over the windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops import ea_windowed as j_eaw
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.build import rcm_reorder
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import ea_windowed as eaw
from buckgnn_tpu_torch.ops.ea_block import make_ea_context

TILE, WIDTH = 128, 64
WIN_FIELDS = ("win_edges", "win_sidx", "win_ridx", "win_far_pos",
              "win_far_send", "win_far_tsend", "win_fs_src", "win_fs_lidx")


def _graphs(n_graphs, seed, supernode=False, side=(8, 11)):
    ds = generate_dataset(n_graphs, seed=seed, min_side=side[0],
                          max_side=side[1], use_super_node=supernode,
                          use_virtual_edges=True)
    return [rcm_reorder(g) for g in normalize_dataset(ds)[0]]


def _assert_equal(ours, ref):
    for f in tb._TENSOR_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("supernode", [False, True])
def test_pack_graphs_windows_match(supernode):
    graphs = _graphs(16, 2, supernode)
    n = sum(g.n_node for g in graphs) + 1
    ncap = ((n + 2 * TILE - 1) // (2 * TILE)) * 2 * TILE
    ecap = ((sum(g.n_edge for g in graphs) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(graphs, ncap, ecap, 17, device="cpu", **kw)
    ref = jb.pack_graphs(graphs, ncap, ecap, 17, **kw)
    assert ncap // TILE >= 4
    assert int((ours.win_far_tsend != ncap - 1).sum()) > 0, "far senders"
    _assert_equal(ours, ref)


@pytest.mark.parametrize("floors", [False, True])
def test_batch_iterator_window_caps_match(floors):
    """Several batches padded to the run's caps; with ``floors`` every cap
    (W, F, Ct, Cs) grows past the run's own maxima, so W widening re-derives
    the far positions and Ct widening re-strides win_fs_src."""
    graphs = _graphs(15, 5)
    kw = dict(band_width=WIDTH, band_tile=TILE, rcm=False)
    if floors:
        kw.update(min_win_cap=640, min_far_cap=1024, min_far_tile_cap=40,
                  min_fs_cap=48)
    ours = list(tb.batch_iterator(graphs, 5, 1024, 8192, device="cpu", **kw))
    ref = list(jb.batch_iterator(graphs, 5, 1024, 8192, **kw))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        _assert_equal(o, r)
    if floors:
        b = ours[0]
        assert (b.win_edges.shape[1], b.win_far_pos.shape[0],
                b.win_far_tsend.shape[1], b.win_fs_src.shape[1]) == (
            640, 1024, 40, 48)


def test_windows_need_width_within_tile():
    graphs = _graphs(2, 1)
    with pytest.raises(AssertionError, match="band_width <= band_tile"):
        tb.pack_graphs(graphs, 512, 4096, 3, band_width=256, band_tile=128,
                       device="cpu")


def test_window_geometry_matches():
    graphs = _graphs(6, 3)
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(graphs, 768, 4096, 7, device="cpu", **kw)
    ref = jb.pack_graphs(graphs, 768, 4096, 7, **kw)
    assert eaw.window_geometry(ours) == j_eaw.window_geometry(ref)
    assert eaw.supports_windowed(ours) and j_eaw.supports_windowed(ref)
    np.testing.assert_array_equal(eaw.window_degree(ours).numpy(),
                                  np.asarray(j_eaw.window_degree(ref)))
    np.testing.assert_array_equal(eaw.window_count(ours).numpy(),
                                  np.diff(np.asarray(ref.row_offsets)))
    # the slab starts of the JAX gather_senders (ea_windowed.py:60-62)
    tile, width, slab, n_tiles, n = j_eaw.window_geometry(ref)
    np.testing.assert_array_equal(
        eaw.slab_starts(ours).numpy(),
        np.clip(np.arange(n_tiles) * tile - width // 2, 0, max(n - slab, 0)))
    np.testing.assert_array_equal(eaw.window_edge_features(ours).numpy(),
                                  np.asarray(jnp.asarray(
                                      j_eaw.window_edge_features(ref))))


def test_ea_context_walks_the_windows():
    """Every slot's global sender (slab start + offset, the far table's
    sender, or -1 for a pad) and receiver, each node's receiver run and its
    sender-sorted slots, from a direct walk over the window fields."""
    graphs = _graphs(16, 2)
    b = tb.pack_graphs(graphs, 1536, 8192, 17, band_width=WIDTH,
                       band_tile=TILE, device="cpu")
    ctx = make_ea_context(b)
    n = b.n_node_cap
    sidx, ridx = b.win_sidx.numpy(), b.win_ridx.numpy()
    tsend = b.win_far_tsend.numpy()
    n_tiles, w = sidx.shape
    slab = TILE + WIDTH
    send = np.full(n_tiles * w, -1)
    recv = np.full(n_tiles * w, -1)
    for t in range(n_tiles):
        start = min(max(t * TILE - WIDTH // 2, 0), n - slab)
        for k in range(w):
            c = sidx[t, k]
            if c < slab:
                send[t * w + k] = start + c
            elif c < slab + tsend.shape[1]:
                send[t * w + k] = tsend[t, c - slab]
            if ridx[t, k] < TILE:
                recv[t * w + k] = t * TILE + ridx[t, k]
    np.testing.assert_array_equal(ctx.send.numpy(), send)
    np.testing.assert_array_equal(ctx.recv.numpy(), recv)
    # the valid slots are exactly the packed edges, by (receiver, sender)
    em = b.edge_mask.numpy()
    pairs = sorted(zip(b.receivers.numpy()[em], b.senders.numpy()[em]))
    valid = recv >= 0
    assert sorted(zip(recv[valid], send[valid])) == pairs
    rlo, rhi = ctx.rlo.numpy(), ctx.rhi.numpy()
    for v in range(n):
        np.testing.assert_array_equal(np.nonzero(recv == v)[0],
                                      np.arange(rlo[v], rhi[v]))
    sorder, soff = ctx.sorder.numpy(), ctx.soff.numpy()
    for v in range(n):
        np.testing.assert_array_equal(sorder[soff[v]:soff[v + 1]],
                                      np.nonzero(send == v)[0])
    assert soff[n] == valid.sum()
    cnt = np.diff(b.row_offsets.numpy()).astype(np.float32)
    np.testing.assert_array_equal(ctx.cnt.numpy(), cnt)
    assert all(t.dtype == torch.int32 for t in (
        ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.sorder, ctx.soff))
