"""The CUDA fused-layer kernel against its plain PyTorch version, on the card.

This file imports only the port (no JAX), so it runs on a machine with a
card and no JAX. The repo's conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Here, with no card, every case skips: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context

TILE, WIDTH = 128, 64
# The gates, with their reasons, are sl.KERNEL_Z_TOL (z against the plain
# z) and sl.KERNEL_TABLE_TOL (the emitted table against the plain emission
# of the kernel's own z).
Z_ATOL, Z_RTOL = sl.KERNEL_Z_TOL
TAB_ATOL, TAB_RTOL = sl.KERNEL_TABLE_TOL


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(dev, supernode=True):
    ds = generate_dataset(12, seed=4, min_side=5, max_side=9,
                          use_super_node=supernode, use_virtual_edges=False)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, 13, band_width=WIDTH, band_tile=TILE,
                       device="cpu")
    assert not b.has_spill_edges and b.has_supernode_edges == supernode
    return b.to(dev)


def _inputs(n, h, dev, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    w_l = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    # a bias as large as x @ W_r's entries, so a dropped b_l fails the gate
    b_l = rng.normal(size=(h,)).astype(np.float32)
    w_r = (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32)
    return [torch.from_numpy(a).to(dev, torch.bfloat16)
            for a in (x, w_l, b_l, w_r)]


@pytest.mark.parametrize("h", [128, 256, 512])
@pytest.mark.parametrize("star", ["local_emit", "local", "full", "none"])
@pytest.mark.parametrize("skip", [False, True])
def test_kernel_matches_plain_on_cuda(h, star, skip):
    dev = _card()
    b = _batch(dev, supernode=star != "none")
    if star == "full":
        b = b.replace(gwin=None, lcode=None, lacc=None)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, h, dev, seed=h)
    emit = star == "local_emit"
    kw = dict(tile=TILE, width=WIDTH, skip=skip, emit=emit)
    if star != "none":
        code, gwin, gw, acc = sl.star_codes(b)
        t0, tg = tb.star_table_geometry(b.n_graph_cap)
        table = sl._super_tables(x, b.node_graph, b.node_mask,
                                 b.supernode_index, b.n_graph_cap, tg)
        kw.update(table=table, code=code, gwin=gwin, gw=gw, t0=t0,
                  acc_code=acc if emit else None)
    band = make_agg_context(b).band
    before = sl.LAUNCHES["sage_layer_fwd"]
    z, tab = sl.sage_layer_fwd(x, w_l, b_l, w_r, band, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["sage_layer_fwd"] == before + 1
    zp, _ = sl.sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    m = b.node_mask
    torch.testing.assert_close(z[m].float(), zp[m].float(), atol=Z_ATOL,
                               rtol=Z_RTOL)
    assert (tab is None) == (not emit)
    if emit:
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], TILE)
        torch.testing.assert_close(tab, tabp, atol=TAB_ATOL, rtol=TAB_RTOL)


def test_kernel_rejects_what_it_does_not_take():
    """A CUDA tensor the kernel cannot take raises; it never falls back."""
    dev = _card()
    b = _batch(dev, supernode=False)
    x, w_l, b_l, w_r = _inputs(b.n_node_cap, 128, dev, seed=0)
    band = make_agg_context(b).band
    with pytest.raises(ValueError, match="bfloat16"):
        sl.sage_layer_fwd(x.float(), w_l, b_l, w_r, band, tile=TILE,
                          width=WIDTH)
    with pytest.raises(ValueError, match="H in"):
        sl.sage_layer_fwd(x[:, :64].contiguous(), w_l[:64, :64].contiguous(),
                          b_l[:64].contiguous(), w_r[:64, :64].contiguous(),
                          band, tile=TILE, width=WIDTH)
