"""Model construction, the optimizer, loss/metric assembly and the steps.

The port of buckgnn_tpu/train/trainer.py:43-76, 96-208. `TrainState` holds
the model (its parameters), the optimizer (its moments) and the epoch: the
JAX ``TrainState``'s role. `make_train_step` gives one eager optimization
step, `train_step(batch, lr, generator)`: a forward with dropout seeds
drawn from ``generator``, the loss on denormalized targets, the backward
through the fused layers' kernels, and an Adam step at ``lr``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.graph.batch import GraphBatch
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.train.metrics import MAPE_error
from buckgnn_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg: TrainConfig, num_node_features: int,
                num_edge_features: int, device=None) -> BuckGNN:
    """The model on ``device`` (the CUDA card unless ``device="cpu"``),
    weights drawn from a ``torch.Generator`` seeded with ``cfg.seed``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = BuckGNN(
        num_node_features=num_node_features,
        num_edge_features=num_edge_features,
        hidden_channels=cfg.hidden_channels,
        num_layers=cfg.num_layers,
        pooling_layer=cfg.pooling_layer,
        prediction_type=cfg.prediction_type,
        dropout_rate=cfg.dropout_rate,
        model_name=cfg.model_name,
        dtype=_DTYPES[cfg.compute_dtype],
        impl=cfg.segment_impl,
        remat=cfg.remat,
        generator=gen,
    )
    return model.to(device).eval()


@dataclasses.dataclass
class TrainState:
    model: BuckGNN
    optimizer: torch.optim.Optimizer
    epoch: int = 0


def make_optimizer(cfg: TrainConfig, model: BuckGNN) -> torch.optim.Adam:
    """Adam with the JAX package's optax chain semantics: weight decay adds
    wd * param to the gradient before the moments (torch's Adam
    weight_decay, as the reference uses it); the learning rate is set by
    each train step (the per-epoch schedule, train/schedule.py)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def init_state(model: BuckGNN,
               optimizer: torch.optim.Optimizer) -> TrainState:
    """The state of a new run: the model's weights are the ones
    `build_model` drew from ``cfg.seed``, the optimizer has no moments."""
    return TrainState(model=model, optimizer=optimizer)


def make_loss_and_metrics(criterion, cfg: TrainConfig,
                          normalizer: DatasetNormalizer | None):
    """Shared per-batch loss/metric assembly (buckling): loss on
    denormalized eigenvalues, MAPE with the scaler stats."""
    if cfg.prediction_type != "buckling":
        raise NotImplementedError(
            "only the buckling head is ported (ROADMAP queue 1, item 8)")
    stats = normalizer.device_stats() if normalizer is not None else {}
    ev_scale = float(stats.get("eigenvalue_scale", np.float32(1.0)))
    ev_center = float(stats.get("eigenvalue_center", np.float32(0.0)))

    def denorm(v):
        return v.float() * ev_scale + ev_center

    def compute_loss(pred, aux, batch: GraphBatch):
        y = batch.y[:, 0]
        return criterion(denorm(pred), denorm(y), batch.graph_mask)

    def compute_metrics(pred, aux, batch: GraphBatch):
        return {"mape": MAPE_error(pred.float(), batch.y[:, 0],
                                   batch.graph_mask, "buckling",
                                   ev_scale, ev_center)}

    return compute_loss, compute_metrics


def make_train_step(model: BuckGNN, optimizer: torch.optim.Optimizer,
                    criterion, cfg: TrainConfig,
                    normalizer: DatasetNormalizer | None):
    """``(train_step, eval_step)``. ``train_step(batch, lr, generator)``
    runs one optimization step in place on the model and the optimizer and
    returns the metrics (``loss``, ``mape``) as detached device scalars,
    without waiting for the device."""
    compute_loss, compute_metrics = make_loss_and_metrics(criterion, cfg,
                                                          normalizer)

    def train_step(batch: GraphBatch, lr: float,
                   generator: torch.Generator | None):
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        optimizer.zero_grad(set_to_none=True)
        pred, aux = model(batch, deterministic=False, generator=generator)
        loss = compute_loss(pred, aux, batch)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            metrics = compute_metrics(pred.detach(), aux, batch)
        metrics["loss"] = loss.detach()
        return metrics

    return train_step, make_eval_step(model, criterion, cfg, normalizer)


def make_eval_step(model: BuckGNN, criterion, cfg: TrainConfig,
                   normalizer: DatasetNormalizer | None):
    """``eval_step(batch) -> (metrics, (pred, aux))``: one deterministic
    forward with its loss and metrics (the JAX eval_step)."""
    compute_loss, compute_metrics = make_loss_and_metrics(criterion, cfg,
                                                          normalizer)

    @torch.no_grad()
    def eval_step(batch: GraphBatch):
        pred, aux = model(batch, deterministic=True)
        metrics = compute_metrics(pred, aux, batch)
        metrics["loss"] = compute_loss(pred, aux, batch)
        return metrics, (pred, aux)

    return eval_step
