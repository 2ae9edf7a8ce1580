"""Flat losses (port of buckgnn_tpu/train/losses.py, buckling default).

``loss(pred, target, mask)`` over per-graph scalars with a validity mask;
masked graphs contribute exactly zero. The rest of the 27-name registry
comes with the training slice.
"""

from __future__ import annotations

import math

import torch


def _masked_mean_strict(v, mask):
    """Mean of v over elements whose leading-dim mask is True."""
    m = mask.to(v.dtype)
    trailing = math.prod(v.shape[mask.ndim:])
    while m.ndim < v.ndim:
        m = m[..., None]
    return (v * m).sum() / torch.clamp_min(m.sum() * trailing, 1.0)


def relative_error_loss(pred, target, mask, epsilon=1e-8):
    """The buckling default (RelativeErrorLoss, Losses.py:755-761)."""
    return _masked_mean_strict(
        torch.abs(pred - target) / (torch.abs(target) + epsilon), mask
    )


def get_loss_function(loss_name: str):
    if loss_name == "relative_error":
        return relative_error_loss
    raise NotImplementedError(
        f"loss {loss_name!r}: only relative_error is ported "
        "(the full registry: ROADMAP queue 1, item 8)")
