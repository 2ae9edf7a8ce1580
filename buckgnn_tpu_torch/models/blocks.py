"""Building blocks of the BuckGNN model (port of buckgnn_tpu/models/blocks.py).

Parameters are float32 and follow flax's names (``lin_0``, ``lin_l``,
``lin_r``) so `buckgnn_tpu_torch.convert.params_from_flax` maps a flax tree
onto them one to one. A block computes in its ``dtype`` the way a flax
``Dense(dtype=...)`` does: inputs, weight and bias are cast to it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


# std of a standard normal truncated to [-2, 2]: flax's lecun_normal
# (variance_scaling, "truncated_normal") divides its std by it, so the
# truncated draw keeps the variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``, initialised from an explicit
    generator as flax's Dense: a lecun-normal weight (a normal of std
    s = 1/sqrt(fan_in)/0.8796 truncated to +-2s) and a zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        s = 1.0 / math.sqrt(in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=s, a=-2 * s, b=2 * s,
                                  generator=generator)
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class _L2Normalize(torch.autograd.Function):
    """The residual form of `l2_normalize` and its VJP (models/blocks.py:
    37-52 of the JAX package)."""

    @staticmethod
    def forward(ctx, v):
        sq = (v * v).sum(-1, keepdim=True)
        inv = torch.rsqrt(sq.clamp_min(1e-24))
        y = v * inv
        ctx.save_for_backward(y, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        y, inv = ctx.saved_tensors
        # s = rowsum(g * y): f32 sums of the products in g's dtype, rounded
        # to g's dtype (the JAX package's ones-matvec, :46-49)
        s = (g * y).float().sum(-1, keepdim=True).to(g.dtype)
        return (g - y * s) * inv


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    """Row-wise F.normalize (norm clamped at 1e-12), in v's dtype: the
    plain ``v / sqrt(max(sum(v*v), 1e-24))`` without autograd, and under
    autograd the residual form ``v * rsqrt(...)`` with the JAX package's
    VJP (finite on exactly-zero padding rows)."""
    if torch.is_grad_enabled() and v.requires_grad:
        return _L2Normalize.apply(v)
    sq = (v * v).sum(-1, keepdim=True)
    return v / torch.sqrt(sq.clamp_min(1e-24))


class MLP(nn.Module):
    """Plain ReLU MLP: Linear-ReLU-...-Linear (no activation after last)."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n = len(widths)
        for i, w in enumerate(widths):
            self.add_module(f"lin_{i}", Dense(in_features, w, dtype=dtype,
                                              generator=generator))
            in_features = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"lin_{i}")(x)
            if i + 1 < self.n:
                x = torch.relu(x)
        return x


def encoder_widths(hidden_channels: int) -> tuple[int, ...]:
    """2-layer (in->64->h) for hidden<=128 (Models/BuckGNN.py:41-52),
    3-layer (in->64->128->h) above (Models/BuckGNN.py:67-82)."""
    if hidden_channels <= 128:
        return (64, hidden_channels)
    return (64, 128, hidden_channels)


def decoder_widths(hidden_channels: int, output_dim: int) -> tuple[int, ...]:
    """Decoder: h(->128)->64->out (Models/BuckGNN.py:54-65, 84-100)."""
    if hidden_channels <= 128:
        return (64, output_dim)
    return (128, 64, output_dim)


class SAGEConv(nn.Module):
    """Shared GraphSAGE convolution (PyG semantics, aggr='add',
    normalize=True): out_i = W_l · sum_{j in N(i)} x_j + b_l + W_r · x_i,
    then L2 norm. `forward` runs it as the fused layer with relu, the
    optional skip and dropout (ops/sage_layer.py); `unfused` as the
    aggregation, the two Dense layers and `l2_normalize` (models/blocks.py:
    152-166 of the JAX package), whose caller adds the epilogue."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.lin_l = Dense(features, features, bias=True, dtype=dtype,
                           generator=generator)
        self.lin_r = Dense(features, features, bias=False, dtype=dtype,
                           generator=generator)

    def fused_weights(self, dtype: torch.dtype):
        """(W_l [in, out], b_l [out], W_r [in, out]) in ``dtype``, the
        kernel's layout (flax's kernel layout)."""
        return (self.lin_l.weight.t().to(dtype).contiguous(),
                self.lin_l.bias.to(dtype).contiguous(),
                self.lin_r.weight.t().to(dtype).contiguous())

    def unfused(self, x, senders, receivers, impl: str, csr=None):
        """l2_normalize(lin_l(agg) + lin_r(x)) in the block's dtype, agg by
        ops/sage.py::sage_aggregate with ``impl`` ('xla', 'sorted' or
        'pallas'; ``csr`` the forward's CSR context for 'pallas')."""
        from buckgnn_tpu_torch.ops.sage import sage_aggregate

        agg = sage_aggregate(x, senders, receivers, x.shape[0], aggr="add",
                             impl=impl, csr=csr)
        return l2_normalize(self.lin_l(agg) + self.lin_r(x))

    def forward(self, x, agg_ctx, *, skip: bool, weights=None,
                rate: float = 0.0, seed=None, deterministic: bool = True,
                star_in=None, star_next: bool = False, table_in=None,
                emit_table: bool = False):
        """The fused layer (ops/sage_layer.py::fused_sage_layer, arguments
        and results as there). ``weights``: the (W_l, b_l, W_r) of
        `fused_weights`, cast once by the caller; None casts them here, in
        every call, so that under autograd each call's weight gradient
        reaches the float32 parameters before the tied calls are summed
        (the JAX package casts in every layer call too)."""
        from buckgnn_tpu_torch.ops.sage_layer import fused_sage_layer

        w_l, b_l, w_r = weights or self.fused_weights(x.dtype)
        return fused_sage_layer(x, w_l, b_l, w_r, agg_ctx, skip=skip,
                                rate=rate, seed=seed,
                                deterministic=deterministic, star_in=star_in,
                                star_next=star_next, table_in=table_in,
                                emit_table=emit_table)


class GraphNetBlock(nn.Module):
    """Edge-augmented message-passing block (Models/BuckGNN.py:528-566),
    run as the fused block (ops/ea_block.py):
    e' = edge_mlp([x_recv, x_send, e]), m = phi([x_send, e']),
    agg = scatter_mean(m over receivers), x' = gamma([x, agg]),
    x' = x' + beta(x'). The parameters are those of the JAX package's
    GraphNetBlock, whose first Dense of edge_mlp / phi / gamma is one
    [sum(in), h] kernel over the concatenation (``_SplitDense``): here an
    `MLP` of the same widths. The edge input is h wide on the fused path
    (the encoded window, or the encoder output in encoder mode)."""

    def __init__(self, hidden_channels: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.edge_mlp = MLP(3 * h, (h, h), **kw)
        self.node_mlp_phi = MLP(2 * h, (h, h), **kw)
        self.node_mlp_gamma = MLP(2 * h, (h, h), **kw)
        self.node_mlp_beta = MLP(h, (h, h), **kw)

    def forward(self, x, e_win, ea_ctx, *, skip: bool, rate: float = 0.0,
                seed=None, deterministic: bool = True, encoder=None):
        """``(x', e')`` of the fused block with the stack's skip and dropout
        (ops/ea_block.py::fused_ea_block, arguments as there)."""
        from buckgnn_tpu_torch.ops.ea_block import fused_ea_block

        return fused_ea_block(x, e_win, self, ea_ctx, skip=skip, rate=rate,
                              seed=seed, deterministic=deterministic,
                              encoder=encoder)
