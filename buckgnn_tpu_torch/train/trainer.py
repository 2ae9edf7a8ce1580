"""Model construction, loss/metric assembly and the eval step (serving).

The port of buckgnn_tpu/train/trainer.py:51-67, 96-146, 182-191. The model
object carries its parameters (the JAX ``TrainState`` role); the optimizer
and the train step come with the training slice.
"""

from __future__ import annotations

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
        generator=gen,
    )
    return model.to(device).eval()


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
