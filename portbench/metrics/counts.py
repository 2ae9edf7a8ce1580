"""Operations and bytes of the work the models need, from their shapes.

The count is of the model's own mathematics, never of how the port
computes it, so that another implementation of the same call (3xTF32 or
one pass, a dense band or only its nonzero blocks, a product recomputed or
kept) leaves it unchanged:

- each multiply-add of a dense product counts 2 operations, once, at the
  real node, edge and panel counts (no padding, no dead node);
- a product whose input is gathered from nodes (x[sender] @ W) counts at
  the node count, since the product comes before the gather for free;
  a product after a sum over a node's edges likewise at the node count;
- a sum over the edges of a node counts 2 operations per (edge, channel);
- a backward counts twice its forward's operations; recomputation,
  normalization, activations, dropout and Adam count nothing;
- a call reads each input once and writes each output once, four bytes a
  float32 value or index.

A shape is a dict: ``nodes``, ``edges`` (directed), ``graphs``,
``node_features``, ``edge_features``. Which layer calls a model makes is
its reference module's to say (``portbench/reference/<name>.py``, the
configuration's ``reference``): its ``layer_calls(cfg, shape)`` lists the
count of each call of one forward, built from the functions here, each
with the ``kind`` of layer that a roofline metric selects. A new model
brings its reference module and needs no edit here.
"""

from __future__ import annotations

from portbench.reference.common import decoder_widths, encoder_widths

F32 = 4


def mlp_flops(rows: int, fin: int, widths) -> int:
    total = 0
    for w in widths:
        total += 2 * rows * fin * w
        fin = w
    return total


def mlp_params(fin: int, widths) -> int:
    total = 0
    for w in widths:
        total += fin * w + w
        fin = w
    return total


def sage_layer(n: int, e: int, h: int) -> dict:
    """One weight-tied SAGE layer call (agg, [agg | x] @ [W_l; W_r] + b):
    forward and backward operations and bytes."""
    fwd = 2 * e * h + 2 * n * (2 * h) * h
    weights = 2 * h * h + h
    fwd_bytes = F32 * (n * h + weights + 2 * e + n * h)
    # reads dz, x, the edges and the weights; writes dx and the weights'
    # gradients
    bwd_bytes = F32 * (2 * n * h + 2 * e + weights + n * h + weights)
    return dict(kind="sage", fwd_flops=fwd, bwd_flops=2 * fwd,
                fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes)


def ea_block(n: int, e: int, h: int, raw_edge_features: int = 0) -> dict:
    """One shared GraphNetBlock call: e' = edge_mlp([x_r, x_s, e]),
    m = phi([x_s, e']), agg = mean of m, x' = gamma([x, agg]) + beta;
    ``raw_edge_features`` > 0 adds the edge encoder that the first call
    runs from the raw features."""
    hh = h * h
    fwd = (2 * n * h * 3 * h      # x @ [W_er | W_es | W_px], per node
           + 2 * e * hh           # e @ W_ee
           + 2 * e * hh           # edge_mlp's second layer
           + 2 * e * hh           # e' @ W_pe
           + 2 * e * h            # the sum over a node's edges
           + 2 * n * hh           # phi's second layer, after the sum
           + 2 * n * 2 * h * h    # gamma's first layer
           + 2 * n * hh           # gamma's second layer
           + 2 * n * 2 * hh)      # beta's two layers
    weights = 12 * hh + 8 * h
    e_in = h
    if raw_edge_features:
        fwd += mlp_flops(e, raw_edge_features, encoder_widths(h))
        weights += mlp_params(raw_edge_features, encoder_widths(h))
        e_in = raw_edge_features
    fwd_bytes = F32 * (n * h + e * e_in + 2 * e + weights + n * h + e * h)
    bwd_bytes = F32 * (n * h + e * h + n * h + e * e_in + 2 * e + weights
                       + n * h + e * e_in + weights)
    return dict(kind="ea", fwd_flops=fwd, bwd_flops=2 * fwd,
                fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes)


def model_forward_flops(ref, cfg: dict, shape: dict) -> int:
    """Operations of one forward of the whole model on a batch: the node
    encoder, the layer calls of ``ref`` (the reference module), mean
    pooling and the decoder."""
    n, g, h = shape["nodes"], shape["graphs"], cfg["hidden_channels"]
    total = mlp_flops(n, shape["node_features"], encoder_widths(h))
    total += sum(c["fwd_flops"] for c in ref.layer_calls(cfg, shape))
    total += 2 * n * h  # mean pooling: a sum over each panel's nodes
    total += mlp_flops(g, h, decoder_widths(h))
    return total


def model_flops(ref, cfg: dict, shapes: list, calls: dict,
                passes: str) -> int:
    """Operations of ``calls`` (batch index -> count) forwards ("serve") or
    train steps ("train": forward and backward)."""
    per = 3 if passes == "train" else 1
    return sum(per * k * model_forward_flops(ref, cfg, shapes[b])
               for b, k in calls.items())


def least_seconds(ref, cfg: dict, shapes: list, calls: dict, passes: str,
                  kind: str, peak_flops: float, peak_bytes: float) -> float:
    """The least time of every layer call of ``kind`` that ``calls`` ran:
    each call's operations over the peak or its bytes over the bandwidth,
    whichever is longer (0 where the model makes no such call)."""
    total = 0.0
    for b, k in calls.items():
        for c in ref.layer_calls(cfg, shapes[b]):
            if c["kind"] != kind:
                continue
            t = max(c["fwd_flops"] / peak_flops, c["fwd_bytes"] / peak_bytes)
            if passes == "train":
                t += max(c["bwd_flops"] / peak_flops,
                         c["bwd_bytes"] / peak_bytes)
            total += k * t
    return total
