"""Dropout numbers and the port's counter-based keep mask.

`dropout_threshold` and `dropout_scale` are copies of
buckgnn_tpu/ops/dropout.py:31-48: the keep probability is quantized to
``thr / 2**bits`` and the scale is its exact inverse, so E[dropout(x)] == x.
The fused kernels compare 32-bit words (``DROPOUT_BITS``, as
ops/pallas_sage_layer.py:136 of the JAX package).

The TPU kernels draw their words from the chip's hardware generator, which
a GPU does not have. The port draws them from a counter-based hash of
(two seed words, global row, column) instead: a keyed murmur3-finalizer
chain, so the forward and the backward of a layer regenerate the same mask
from the seeds alone, and nothing but the seeds is stored. `dropout_bits`
below is the plain version; ``csrc/sage_common.cuh::dropout_bits`` is the
same function, bit for bit, in the CUDA kernels. The words are not the
TPU's, so the port matches the JAX package only at rate 0.

torch has no uint32 multiply, so the plain version carries 32-bit words in
int64 tensors and multiplies by a constant in two 16-bit halves, which
never leave int64's range.
"""

from __future__ import annotations

import torch

DROPOUT_BITS = 32

_M32 = 0xFFFFFFFF
# hash constants (csrc/sage_common.cuh uses the same)
ROW_MUL, COL_MUL = 0x9E3779B1, 0x85EBCA77
_FMIX1, _FMIX2 = 0x85EBCA6B, 0xC2B2AE35


def dropout_threshold(rate: float, bits: int = DROPOUT_BITS) -> int:
    """Unsigned ``bits``-wide threshold for a keep probability of
    ``1 - rate`` (a word below it keeps its element)."""
    thr = int(round((1.0 - rate) * 2.0**bits))
    return max(1, min(2**bits - 1, thr))


def dropout_scale(rate: float, bits: int = DROPOUT_BITS) -> float:
    """Exact inverse of the quantized keep probability."""
    return 2.0**bits / dropout_threshold(rate, bits)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def dropout_bits(seed, rows: torch.Tensor, cols: torch.Tensor):
    """32-bit words (int64 tensor) for the broadcast of ``rows`` [R, 1]
    and ``cols`` [1, C] under ``seed`` = (s0, s1), two ints in [0, 2**32)."""
    s0, s1 = (int(s) & _M32 for s in seed)
    h = _fmix32((_mul32(rows.long(), ROW_MUL) + s0) & _M32)
    return _fmix32(h ^ ((_mul32(cols.long(), COL_MUL) + s1) & _M32))


def keep_mask(seed, n: int, h: int, rate: float, device,
              row0: int = 0) -> torch.Tensor:
    """[n, h] bool keep mask of rows row0..row0+n-1 at ``rate``."""
    rows = torch.arange(row0, row0 + n, device=device)[:, None]
    cols = torch.arange(h, device=device)[None, :]
    return dropout_bits(seed, rows, cols) < dropout_threshold(rate)


def apply_dropout(r: torch.Tensor, seed, rate: float,
                  row0: int = 0) -> torch.Tensor:
    """where(keep, r * scale, 0) on an [N, H] float32 tensor, as the fused
    kernels apply it (scale in float32); its rows are rows row0.. of the
    hash."""
    keep = keep_mask(seed, r.shape[0], r.shape[1], rate, r.device, row0)
    scale = torch.tensor(dropout_scale(rate), dtype=torch.float32)
    return torch.where(keep, r * scale.to(r.device), torch.zeros((), device=r.device))


def xla_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Inverted dropout outside the epilogue (the JAX package's
    ``ops/dropout.py::dropout``): zero with probability ``rate``, the
    survivors scaled in float32 by the exact inverse of the quantized keep
    probability and rounded once to x's dtype. The keep mask is the port's
    keyed hash over x seen as [rows, last dim] under ``seed`` (two words
    the caller draws from its generator), so it matches the JAX package
    only at rate 0."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    h = x.shape[-1]
    keep = keep_mask(seed, x.numel() // h, h, rate, x.device).reshape(
        x.shape)
    scaled = (x.float() * dropout_scale(rate)).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
