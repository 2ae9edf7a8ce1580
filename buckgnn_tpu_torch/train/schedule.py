"""Learning-rate schedules with torch semantics (a copy of
buckgnn_tpu/train/schedule.py).

The reference uses torch.optim.lr_scheduler.CosineAnnealingLR(T_max=500,
eta_min=lr/100) — whose closed form is *periodic*, so over the reference's
1501 epochs the LR oscillates through 1.5 cycles (TRAIN_FINAL.py:199-205) —
and CosineAnnealingWarmRestarts(T_0=500, T_mult=2) (:192-198). Both stepped
once per epoch (:311-312).
"""

from __future__ import annotations

import math

from buckgnn_tpu_torch.config import TrainConfig


def cosine_annealing(epoch: int, base_lr: float, t_max: int, eta_min: float):
    """torch CosineAnnealingLR closed form (periodic beyond t_max)."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


def cosine_warm_restarts(
    epoch: int, base_lr: float, t_0: int, t_mult: int, eta_min: float
):
    """torch CosineAnnealingWarmRestarts closed form."""
    if t_mult == 1:
        t_cur = epoch % t_0
        t_i = t_0
    else:
        # cycle i spans [t_0 (t_mult^i - 1)/(t_mult - 1), ...)
        n = int(
            math.floor(
                math.log(epoch / t_0 * (t_mult - 1) + 1, t_mult)
            )
        ) if epoch > 0 else 0
        start = t_0 * (t_mult**n - 1) // (t_mult - 1)
        t_cur = epoch - start
        t_i = t_0 * t_mult**n
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


def lr_for_epoch(cfg: TrainConfig, epoch: int) -> float:
    if not cfg.use_lr_scheduler:
        return cfg.lr
    if cfg.scheduler == "restart":
        return cosine_warm_restarts(epoch, cfg.lr, cfg.t_0, cfg.t_mult, cfg.eta_min)
    return cosine_annealing(epoch, cfg.lr, cfg.t_0, cfg.eta_min)
