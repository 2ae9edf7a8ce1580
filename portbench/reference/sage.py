"""Plain reference of ``GraphSage_addAggr_Shared`` (Models/BuckGNN.py:
113-119, 338-352): the thesis model.

A 3-layer node encoder; L weight-tied GraphSAGE layers, each
    agg = sum of x_j over the node's in-edges
    y   = l2_normalize(agg W_l^T + b_l + x W_r^T)
    x   = dropout(relu(y) (+ x when 0 < i < L-1))
mean pooling of every node of a panel (its supernode too), and a 3-layer
decoder to one eigenvalue. Float32 (common.py), no kernel.

The harness reads two more names of a reference module: ``EDGE_SLOTS``
(whether dropout is keyed by an edge's window slot, so that the packed
batch's windows must be read and checked: reference/layout.py) and
``layer_calls`` (the operation and byte counts of each layer call,
portbench/metrics/counts.py).
"""

from __future__ import annotations

import torch

from portbench.metrics import counts
from portbench.reference import common

# dropout is keyed by a node's packed row alone
EDGE_SLOTS = False


def layer_calls(cfg: dict, shape: dict) -> list[dict]:
    """The counts of each layer call of one forward, in order: one
    weight-tied SAGE layer a layer."""
    return [counts.sage_layer(shape["nodes"], shape["edges"],
                              cfg["hidden_channels"])
            for _ in range(cfg["num_layers"])]


def spec(cfg: dict, n_node_features: int, n_edge_features: int) -> dict:
    """name -> shape of every parameter, as the port names them."""
    h = cfg["hidden_channels"]
    return {
        **common.mlp_spec("node_encoder", n_node_features,
                          common.encoder_widths(h)),
        "shared_graphsage_block.lin_l.weight": (h, h),
        "shared_graphsage_block.lin_l.bias": (h,),
        "shared_graphsage_block.lin_r.weight": (h, h),
        **common.mlp_spec("decoder", h, common.decoder_widths(h)),
    }


def forward(p: dict, d: dict, rate: float, seeds, prec: str):
    """Predictions [G] of the batch ``d`` (reference/layout.py)."""
    n_enc = len(common.encoder_widths(d["hidden"]))
    x = common.mlp(p, "node_encoder", n_enc, d["x"], prec)
    wl = p["shared_graphsage_block.lin_l.weight"]
    bl = p["shared_graphsage_block.lin_l.bias"]
    wr = p["shared_graphsage_block.lin_r.weight"]
    layers = len(seeds) if seeds is not None else d["layers"]
    for i in range(layers):
        agg = torch.zeros_like(x).index_add_(0, d["recv"], x[d["send"]])
        out = (common.linear(agg, wl, bl, prec)
               + common.linear(x, wr, None, prec))
        y = out * torch.rsqrt((out * out).sum(-1, keepdim=True)
                              .clamp_min(1e-24))
        r = torch.relu(y)
        if 0 < i < layers - 1:
            r = r + x
        if rate > 0.0:
            r = common.dropout(r, seeds[i], rate, d["rows"])
        x = r
    pooled = common.segment_mean(x, d["graph"], d["n_graphs"])
    n_dec = len(common.decoder_widths(d["hidden"]))
    return common.mlp(p, "decoder", n_dec, pooled, prec).squeeze(-1)
