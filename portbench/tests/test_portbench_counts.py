"""The operation and byte counts against hand counts, and their
independence of how a call is computed."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.metrics import counts


def test_sage_layer_by_hand():
    n, e, h = 10, 36, 128
    c = counts.sage_layer(n, e, h)
    # aggregation 2 e h; [agg | x] @ [W_l; W_r]: 2 n (2h) h
    assert c["fwd_flops"] == 2 * 36 * 128 + 2 * 10 * 256 * 128
    assert c["bwd_flops"] == 2 * c["fwd_flops"]
    w = 2 * h * h + h
    assert c["fwd_bytes"] == 4 * (n * h + w + 2 * e + n * h)


def test_ea_block_by_hand():
    n, e, h = 6, 20, 128
    c = counts.ea_block(n, e, h)
    hh = h * h
    hand = (2 * n * h * 3 * h + 3 * 2 * e * hh + 2 * e * h + 2 * n * hh
            + 2 * n * 2 * hh + 2 * n * hh + 2 * n * 2 * hh)
    assert c["fwd_flops"] == hand
    enc = counts.ea_block(n, e, h, raw_edge_features=5)
    assert enc["fwd_flops"] - hand == 2 * e * (5 * 64 + 64 * h)


def test_model_forward_by_hand():
    from portbench.reference import sage

    cfg = dict(hidden_channels=128, num_layers=2)
    shape = dict(nodes=10, edges=36, graphs=2, node_features=16,
                 edge_features=5)
    enc = 2 * 10 * (16 * 64 + 64 * 128)
    layer = counts.sage_layer(10, 36, 128)["fwd_flops"]
    dec = 2 * 2 * (128 * 64 + 64 * 1)
    assert counts.model_forward_flops(sage, cfg, shape) == (
        enc + 2 * layer + 2 * 10 * 128 + dec)
    assert counts.model_flops(sage, cfg, [shape], {0: 3}, "train") == (
        9 * counts.model_forward_flops(sage, cfg, shape))


def test_least_seconds_selects_the_layer_kind():
    """A roofline counts only its own layer's calls: the EA model makes no
    SAGE call, and its first block call runs the edge encoder."""
    from portbench.reference import ea

    cfg = dict(hidden_channels=128, num_layers=3)
    shape = dict(nodes=10, edges=36, graphs=2, node_features=16,
                 edge_features=5)
    calls = ea.layer_calls(cfg, shape)
    assert [c["kind"] for c in calls] == ["ea"] * 3
    assert calls[0]["fwd_flops"] > calls[1]["fwd_flops"] == \
        calls[2]["fwd_flops"]
    args = (cfg, [shape], {0: 2}, "serve")
    assert counts.least_seconds(ea, *args, "sage", 1e12, 1e12) == 0.0
    assert counts.least_seconds(ea, *args, "ea", 1e30, 1.0) == 2 * sum(
        c["fwd_bytes"] for c in calls)


def _graph(n=64, deg=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    recv = torch.arange(n).repeat_interleave(deg)
    send = (recv + torch.randint(1, 8, (n * deg,), generator=g)) % n
    return send, recv


def _split(v):
    """3xTF32's operands: hi = tf32(v), lo = tf32(v - hi)."""
    from portbench.reference.common import tf32

    hi = tf32(v)
    return hi, tf32(v - hi)


def sage_edges(x, w, send, recv):
    agg = torch.zeros_like(x).index_add_(0, recv, x[send])
    return torch.cat([agg, x], 1) @ w


def sage_dense_band(x, w, send, recv):
    """The same call as a dense adjacency product (a band that holds every
    edge) and products in 3xTF32."""
    n = x.shape[0]
    a = torch.zeros(n, n).index_put_((recv, send), torch.ones(len(send)),
                                     accumulate=True)
    agg = a @ x
    lhs = torch.cat([agg, x], 1)
    (lh, ll), (wh, wl) = _split(lhs), _split(w)
    return lh @ wh + lh @ wl + ll @ wh


def test_count_is_independent_of_the_implementation():
    n, h = 64, 128
    send, recv = _graph(n)
    x = torch.randn(n, h)
    w = torch.randn(2 * h, h) / 16
    seen = []
    for impl in (sage_edges, sage_dense_band):
        with FlopCounterMode(display=False) as fc:
            out = impl(x, w, send, recv)
        seen.append((fc.get_total_flops(), out))
    torch.testing.assert_close(seen[0][1], seen[1][1], rtol=1e-4,
                               atol=1e-3)
    # the implementations run different amounts of product work ...
    assert seen[1][0] > 3 * seen[0][0]
    # ... the edge-list one exactly the model's dense products ...
    assert seen[0][0] == 2 * n * (2 * h) * h
    # ... and the count of the call is the same whichever runs: it takes
    # only the call's shape
    c = counts.sage_layer(n, len(send), h)
    assert c["fwd_flops"] == seen[0][0] + 2 * len(send) * h
