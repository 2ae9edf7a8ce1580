"""Plain reference of ``EA_GNN_Shared`` (Models/BuckGNN.py:103-106,
326-336, 528-566): the edge-augmented model with one shared block.

Node and edge encoders (3 layers each); L applications of the shared
GraphNetBlock over the flat edge list:
    e'  = edge_mlp([x_recv, x_send, e])
    m   = phi([x_send, e'])
    agg = mean of m over the node's in-edges
    x'  = gamma([x, agg]);  x' = x' + beta(x')
then x = dropout(x' (+ x)), e = dropout(e' (+ e)), the skips when
0 < i < L-1; mean pooling and a 3-layer decoder. Each first Dense over a
concatenation is taken part by part, the gathers after the products (the
same sums); float32 (common.py), no kernel.
"""

from __future__ import annotations

import torch

from portbench.metrics import counts
from portbench.reference import common

_BLOCK = "shared_gn_block"
# dropout of an edge is keyed by its window slot (ops/ea_block.py)
EDGE_SLOTS = True


def layer_calls(cfg: dict, shape: dict) -> list[dict]:
    """The counts of each block call of one forward, in order: the first
    runs the edge encoder from the raw edge features."""
    return [counts.ea_block(shape["nodes"], shape["edges"],
                            cfg["hidden_channels"],
                            shape["edge_features"] if i == 0 else 0)
            for i in range(cfg["num_layers"])]


def spec(cfg: dict, n_node_features: int, n_edge_features: int) -> dict:
    h = cfg["hidden_channels"]
    out = {**common.mlp_spec("node_encoder", n_node_features,
                             common.encoder_widths(h)),
           **common.mlp_spec("edge_encoder", n_edge_features,
                             common.encoder_widths(h))}
    for name, fin in (("edge_mlp", 3 * h), ("node_mlp_phi", 2 * h),
                      ("node_mlp_gamma", 2 * h), ("node_mlp_beta", h)):
        out.update(common.mlp_spec(f"{_BLOCK}.{name}", fin, (h, h)))
    out.update(common.mlp_spec("decoder", h, common.decoder_widths(h)))
    return out


def _w(p, name, i):
    return (p[f"{_BLOCK}.{name}.lin_{i}.weight"],
            p[f"{_BLOCK}.{name}.lin_{i}.bias"])


def forward(p: dict, d: dict, rate: float, seeds, prec: str):
    """Predictions [G] of the batch ``d`` (reference/layout.py)."""
    h = d["hidden"]
    lin = common.linear
    n_enc = len(common.encoder_widths(h))
    x = common.mlp(p, "node_encoder", n_enc, d["x"], prec)
    e = common.mlp(p, "edge_encoder", n_enc, d["edge_attr"], prec)
    send, recv, n = d["send"], d["recv"], x.shape[0]
    layers = len(seeds) if seeds is not None else d["layers"]
    for i in range(layers):
        we0, be0 = _w(p, "edge_mlp", 0)
        we1, be1 = _w(p, "edge_mlp", 1)
        e1 = torch.relu(lin(x, we0[:, :h], None, prec)[recv]
                        + lin(x, we0[:, h:2 * h], None, prec)[send]
                        + lin(e, we0[:, 2 * h:], be0, prec))
        e2 = lin(e1, we1, be1, prec)
        wp0, bp0 = _w(p, "node_mlp_phi", 0)
        wp1, bp1 = _w(p, "node_mlp_phi", 1)
        m1 = torch.relu(lin(x, wp0[:, :h], None, prec)[send]
                        + lin(e2, wp0[:, h:], bp0, prec))
        agg = common.segment_mean(lin(m1, wp1, bp1, prec), recv, n)
        wg0, bg0 = _w(p, "node_mlp_gamma", 0)
        wg1, bg1 = _w(p, "node_mlp_gamma", 1)
        g1 = torch.relu(lin(x, wg0[:, :h], None, prec)
                        + lin(agg, wg0[:, h:], bg0, prec))
        x1 = lin(g1, wg1, bg1, prec)
        wb0, bb0 = _w(p, "node_mlp_beta", 0)
        wb1, bb1 = _w(p, "node_mlp_beta", 1)
        x2 = x1 + lin(torch.relu(lin(x1, wb0, bb0, prec)), wb1, bb1, prec)
        if 0 < i < layers - 1:
            x2, e2 = x2 + x, e2 + e
        if rate > 0.0:
            e2 = common.dropout(e2, seeds[i], rate, d["slots"])
            x2 = common.dropout(x2, seeds[i], rate, d["n_slots"] + d["rows"])
        x, e = x2, e2
    pooled = common.segment_mean(x, d["graph"], d["n_graphs"])
    n_dec = len(common.decoder_widths(h))
    return common.mlp(p, "decoder", n_dec, pooled, prec).squeeze(-1)
