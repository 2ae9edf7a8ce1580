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
    """GraphSAGE convolution, PyG semantics (Models/BuckGNN.py:113-180):
    out_i = W_l · aggr_{j in N(i)} x_j + b_l + W_r · x_i (lin_r bias-free),
    then the L2 norm when ``normalize``. `forward` runs the weight-tied
    flagship layer (aggr 'add', normalized) as the fused layer with relu,
    the optional skip and dropout (ops/sage_layer.py); `unfused` runs any
    ``aggr`` and ``normalize`` as the aggregation, the two Dense layers and
    `l2_normalize` (models/blocks.py:152-166 of the JAX package), whose
    caller adds the epilogue. ``in_features`` defaults to ``features``
    (the SAG score conv maps h features to 1)."""

    def __init__(self, features: int, aggr: str = "add",
                 normalize: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 in_features: int | None = None):
        super().__init__()
        self.aggr = aggr
        self.normalize = normalize
        self.dtype = dtype
        fin = features if in_features is None else in_features
        self.lin_l = Dense(fin, features, bias=True, dtype=dtype,
                           generator=generator)
        self.lin_r = Dense(fin, features, bias=False, dtype=dtype,
                           generator=generator)

    def fused_weights(self, dtype: torch.dtype):
        """(W_l [in, out], b_l [out], W_r [in, out]) in ``dtype``, the
        kernel's layout (flax's kernel layout)."""
        return (self.lin_l.weight.t().to(dtype).contiguous(),
                self.lin_l.bias.to(dtype).contiguous(),
                self.lin_r.weight.t().to(dtype).contiguous())

    def unfused(self, x, senders, receivers, impl: str, csr=None,
                agg_ctx=None):
        """lin_l(agg) + lin_r(x) in the block's dtype (then l2-normalized
        when ``normalize``). agg: with a banded ``impl`` and an
        ``agg_ctx`` (a banded batch), ops/banded.py::banded_sage_aggregate;
        otherwise ops/sage.py::sage_aggregate with ``impl`` ('xla' for a
        banded impl; ``csr`` the forward's CSR context for 'pallas')."""
        if agg_ctx is not None and impl.startswith("banded"):
            from buckgnn_tpu_torch.ops.banded import banded_sage_aggregate

            agg = banded_sage_aggregate(x, agg_ctx, aggr=self.aggr,
                                        dtype=self.dtype)
        else:
            from buckgnn_tpu_torch.ops.sage import sage_aggregate

            agg = sage_aggregate(
                x, senders, receivers, x.shape[0], aggr=self.aggr,
                impl="xla" if impl.startswith("banded") else impl, csr=csr)
        out = self.lin_l(agg) + self.lin_r(x)
        return l2_normalize(out) if self.normalize else out

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


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with padding-aware statistics (models/blocks.py:169-216
    of the JAX package; Models/BuckGNN.py:133, 184). Training normalizes by
    the masked batch mean and biased variance and moves the running
    statistics with the unbiased variance (n - 1 clamped at 1; momentum
    0.1, eps 1e-5); ``use_running_average`` normalizes by the running
    statistics. The caller says which (the model's ``deterministic``), not
    ``nn.Module.training``. Parameters ``scale`` and ``bias``; the running
    ``mean`` and ``var`` are float32 buffers. Padding rows are normalized
    like any row but never enter the statistics. The arithmetic promotes
    as the JAX module's: a bf16 x meets float32 statistics, so the result
    is float32."""

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            w = mask.float()[:, None]
            n = w.sum().clamp_min(1.0)
            mean = (x * w).sum(0) / n
            var = ((x - mean).square() * w).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                m = self.momentum
                self.mean.copy_((1.0 - m) * self.mean + m * mean)
                self.var.copy_((1.0 - m) * self.var + m * unbiased)
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (x - mean) * inv * self.scale + self.bias


def split_first_mlp(mlp: MLP, parts, posts) -> torch.Tensor:
    """A two-layer `MLP` whose first Dense (kernel over the concatenation
    of ``parts``) runs part by part: each part times its slice of the
    weight, then ``posts[i]`` (a gather, or None) on that product, summed
    in order with the bias, then relu and the second Dense (the JAX
    package's ``_SplitDense`` / ``SplitFirstMLP``, models/blocks.py:219-273:
    the gather after the product)."""
    lin0 = mlp.lin_0
    dt = lin0.compute_dtype
    w = lin0.weight.to(dt)
    out, off = None, 0
    for p, post in zip(parts, posts):
        d = p.shape[-1]
        t = F.linear(p.to(dt), w[:, off:off + d])
        off += d
        if post is not None:
            t = post(t)
        out = t if out is None else out + t
    return mlp.lin_1(torch.relu(out + lin0.bias.to(dt)))


class GraphNetBlock(nn.Module):
    """Edge-augmented message-passing block (Models/BuckGNN.py:528-566),
    run as the fused block (ops/ea_block.py):
    e' = edge_mlp([x_recv, x_send, e]), m = phi([x_send, e']),
    agg = scatter_mean(m over receivers), x' = gamma([x, agg]),
    x' = x' + beta(x'). The parameters are those of the JAX package's
    GraphNetBlock, whose first Dense of edge_mlp / phi / gamma is one
    [sum(in), h] kernel over the concatenation (``_SplitDense``): here an
    `MLP` of the same widths. The edge input is h wide on the fused path
    (the encoded window, or the encoder output in encoder mode).
    `unfused` runs the same block as plain tensor ops, flat over the edge
    list or over the windows (models/blocks.py:356-392 of the JAX
    package)."""

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

    def unfused(self, x, e, senders, receivers, windows=None):
        """``(x', e')`` of the block without the stack's skip and dropout.
        ``windows`` None: ``e`` [E, h] over the flat edge list (gathers by
        index, the scatter-mean over receivers); else ``(geom, sidx, ridx,
        far_pos, far_send, degree)`` and ``e`` in window layout [n_tiles,
        W, h] (ops/ea_windowed.py's one-hot products)."""
        if windows is None:
            def g_recv(p):
                return p[receivers.long()]

            def g_send(p):
                return p[senders.long()]
        else:
            from buckgnn_tpu_torch.ops import ea_windowed as eaw

            geom, sidx, ridx, far_pos, far_send, degree = windows

            def g_recv(p):
                return eaw.gather_receivers(p, ridx, geom)

            def g_send(p):
                return eaw.gather_senders(p, sidx, far_pos, far_send, geom)

        e = split_first_mlp(self.edge_mlp, [x, x, e], [g_recv, g_send, None])
        msg = split_first_mlp(self.node_mlp_phi, [x, e], [g_send, None])
        if windows is None:
            from buckgnn_tpu_torch.ops import segment

            agg = segment.segment_mean(msg, receivers, x.shape[0])
        else:
            agg = eaw.scatter_mean_messages(msg, ridx, degree, geom)
        x = split_first_mlp(self.node_mlp_gamma, [x, agg], [None, None])
        return x + self.node_mlp_beta(x), e
