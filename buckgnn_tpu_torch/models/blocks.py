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


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``, initialised from an explicit
    generator (lecun-normal weight, zero bias, as flax's Dense)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        with torch.no_grad():
            self.weight.copy_(torch.randn(out_features, in_features,
                                          generator=generator)
                              / math.sqrt(in_features))
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


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
    normalize=True), run as the fused layer:
    out_i = W_l · sum_{j in N(i)} x_j + b_l + W_r · x_i, then L2 norm,
    relu and the optional skip (ops/sage_layer.py)."""

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

    def forward(self, x, agg_ctx, *, skip: bool, weights=None,
                table_in=None, emit_table: bool = False):
        from buckgnn_tpu_torch.ops.sage_layer import fused_sage_layer

        w_l, b_l, w_r = weights or self.fused_weights(x.dtype)
        return fused_sage_layer(x, w_l, b_l, w_r, agg_ctx, skip=skip,
                                table_in=table_in, emit_table=emit_table)
