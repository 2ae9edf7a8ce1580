"""What the plain reference models share: their parameters, dense layers,
dropout, loss, one Adam step, and the precision they compute in.

Plain PyTorch in float32 with TF32 off. ``prec="tf32"`` is the control:
every dense product takes its operands rounded to TF32 (10 mantissa bits,
to nearest) and sums in float32, as the tensor cores do when TF32 is
allowed; sums of messages are not products and stay float32.

The dropout keep mask is a frozen copy of the port's keyed hash
(``buckgnn_tpu_torch/ops/dropout.py``: a murmur3-finalizer chain of two
seed words, the row and the column), drawn at the rows the packed batch
put each node and edge in; the seed words are drawn as the port draws
them (``models/buckgnn.py::draw_seed``), two 32-bit words a layer from a
CPU ``torch.Generator``. Nothing here imports the program.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

_M32 = 0xFFFFFFFF
_ROW_MUL, _COL_MUL = 0x9E3779B1, 0x85EBCA77
_FMIX1, _FMIX2 = 0x85EBCA6B, 0xC2B2AE35


def encoder_widths(h: int) -> tuple[int, ...]:
    return (64, h) if h <= 128 else (64, 128, h)


def decoder_widths(h: int, out: int = 1) -> tuple[int, ...]:
    return (64, out) if h <= 128 else (128, 64, out)


def mlp_spec(prefix: str, fin: int, widths) -> dict:
    spec = {}
    for i, w in enumerate(widths):
        spec[f"{prefix}.lin_{i}.weight"] = (w, fin)
        spec[f"{prefix}.lin_{i}.bias"] = (w,)
        fin = w
    return spec


def tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to TF32's 10 mantissa bits, to nearest."""
    bits = v.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """x @ w.T + b whose three products, forward and backward, take
    operands rounded to TF32."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = tf32(x), tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = b is not None
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = tf32(g)
        db = g.sum(0) if ctx.has_bias else None
        return gr @ wr, gr.t() @ xr, db


def linear(x, w, b, prec: str):
    """x @ w.T (+ b) in float32, operands rounded to TF32 under "tf32"."""
    if prec == "tf32":
        return _TF32Linear.apply(x, w, b)
    return F.linear(x, w, b)


def mlp(p: dict, prefix: str, n: int, x, prec: str):
    for i in range(n):
        x = linear(x, p[f"{prefix}.lin_{i}.weight"],
                   p[f"{prefix}.lin_{i}.bias"], prec)
        if i + 1 < n:
            x = torch.relu(x)
    return x


def draw_seed(gen: torch.Generator) -> tuple[int, int]:
    words = torch.randint(0, 2**32, (2,), generator=gen, dtype=torch.int64)
    return int(words[0]), int(words[1])


def _mul32(a, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def dropout(v: torch.Tensor, seed, rate: float, rows: torch.Tensor):
    """where(keep, v * scale, 0) with the keep mask of the keyed hash at
    ``rows`` (int64 [len(v)]) and columns 0..H-1; the keep probability is
    quantized to thr / 2**32 and the scale is its exact inverse."""
    s0, s1 = (int(s) & _M32 for s in seed)
    cols = torch.arange(v.shape[1], device=v.device)[None, :]
    h = _fmix32((_mul32(rows.long()[:, None], _ROW_MUL) + s0) & _M32)
    bits = _fmix32(h ^ ((_mul32(cols, _COL_MUL) + s1) & _M32))
    thr = max(1, min(2**32 - 1, int(round((1.0 - rate) * 2.0**32))))
    scale = torch.tensor(2.0**32 / thr, dtype=torch.float32, device=v.device)
    return torch.where(bits < thr, v * scale, torch.zeros((), device=v.device))


def segment_mean(v, ids, n: int):
    """Mean of the rows of v by ids over n segments (0 where empty)."""
    s = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
    s.index_add_(0, ids, v)
    cnt = torch.zeros(n, dtype=v.dtype, device=v.device)
    cnt.index_add_(0, ids, torch.ones_like(ids, dtype=v.dtype))
    return s / cnt.clamp_min(1.0)[:, None]


def relative_error(pred, y, stats):
    """The buckling loss: mean over the panels of |p - t| / (|t| + 1e-8)
    on denormalized eigenvalues (Losses.py:755-761)."""
    scale, center = stats
    p = pred * scale + center
    t = y * scale + center
    return (torch.abs(p - t) / (torch.abs(t) + 1e-8)).mean()


class Adam:
    """torch.optim.Adam's update with weight decay added to the gradient
    (the JAX package's optax chain): the moments and one step."""

    def __init__(self, params: dict, opt: dict):
        self.lr, self.wd = opt["lr"], opt["weight_decay"]
        self.b1, self.b2 = opt["betas"]
        self.eps, self.t = opt["eps"], 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """One update; returns each leaf's gradient as the moments take
        it (the gradient plus weight decay times the parameter)."""
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return taken


def train_steps(forward, params: dict, data: dict, cfg: dict, steps: int,
                gen: torch.Generator, prec: str) -> dict:
    """``steps`` train steps of ``forward(params, data, seeds, prec)`` from
    ``params`` (updated in place): each step's loss, the first step's
    gradient as Adam takes it, the parameters after the last step."""
    opt = Adam(params, cfg["optimizer"])
    losses, first = [], None
    for _ in range(steps):
        seeds = [draw_seed(gen) for _ in range(cfg["num_layers"])]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        pred = forward(leaves, data, cfg["dropout_rate"], seeds, prec)
        loss = relative_error(pred, data["y"], data["stats"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        taken = opt.step(params, dict(zip(leaves, grads)))
        losses.append(float(loss.detach()))
        first = taken if first is None else first
    return dict(losses=losses, grad=first, params=params)
