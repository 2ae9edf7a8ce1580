"""Buckling metrics (port of buckgnn_tpu/train/metrics.py:24-50)."""

from __future__ import annotations

import torch


def masked_mape(pred, target, mask):
    """mean(|(t - p)/t|) * 100 over valid entries (Metrics.py:10-12)."""
    m = mask.to(pred.dtype)
    rel = torch.abs((target - pred) / target)
    return (rel * m).sum() / torch.clamp_min(m.sum(), 1.0) * 100.0


def MAPE_error(predictions, targets, mask, prediction_type: str = "buckling",
               eigen_scale=None, eigen_center=None):
    """Metrics.MAPE_error parity for buckling: denormalize with the
    eigenvalue scaler stats, then the masked MAPE."""
    if prediction_type != "buckling":
        raise NotImplementedError(
            f"MAPE_error({prediction_type!r}): only buckling is ported "
            "(node-level metrics: ROADMAP queue 1, item 8)")
    if eigen_scale is not None:
        predictions = predictions * eigen_scale + eigen_center
        targets = targets * eigen_scale + eigen_center
    return masked_mape(predictions, targets, mask)
