"""Model construction, the optimizer, loss/metric assembly and the steps.

The port of buckgnn_tpu/train/trainer.py:43-235. `TrainState` holds the
model (its parameters, and the batch norms' running statistics as
buffers), the optimizer (its moments, over the parameters only) and the
epoch: the JAX ``TrainState``'s role. `make_train_step` gives one eager
optimization step, `train_step(batch, lr, generator)`: a forward with
dropout seeds drawn from ``generator`` (the batch norms normalize by the
batch and move their running statistics), the loss on denormalized
targets, the backward, and an Adam step at ``lr``; `eval_step` normalizes
by the running statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.graph.batch import GraphBatch, GraphData
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.train.losses import GRAPH_FAMILY
from buckgnn_tpu_torch.train.metrics import MAPE_error, stress_errors
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
        use_z_coord=cfg.use_z_coord,
        use_rotations=cfg.use_rotations,
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


def _denorm_fns(normalizer: DatasetNormalizer | None, prediction_type: str):
    """``(denorm, (scale, center))`` of the prediction type's targets: the
    eigenvalue (floats), displacement or stress scaler stats (float32,
    moved to each tensor's device on first use); mode shapes stay
    normalized."""
    stats = normalizer.device_stats() if normalizer is not None else {}
    if prediction_type == "buckling":
        scale = float(stats.get("eigenvalue_scale", np.float32(1.0)))
        center = float(stats.get("eigenvalue_center", np.float32(0.0)))
        return (lambda v: v.float() * scale + center), (scale, center)
    if prediction_type not in ("static_disp", "static_stress"):
        return (lambda v: v), (1.0, 0.0)
    key, n = (("displacement", 2) if prediction_type == "static_disp"
              else ("gp_stress", 3))
    scale = stats.get(f"{key}_scale", np.ones(n, np.float32))
    center = stats.get(f"{key}_center", np.zeros(n, np.float32))
    on_device = {}

    def denorm(v):
        if v.device not in on_device:
            on_device[v.device] = (torch.as_tensor(scale, device=v.device),
                                   torch.as_tensor(center, device=v.device))
        s, c = on_device[v.device]
        return v.float() * s + c

    return denorm, (scale, center)


def make_loss_and_metrics(criterion, cfg: TrainConfig,
                          normalizer: DatasetNormalizer | None):
    """``(compute_loss, compute_metrics)`` of (pred, aux, batch), one
    source for the train and eval steps (trainer.py:96-146 of the JAX
    package). buckling: the loss on denormalized eigenvalues, MAPE with
    the scaler stats; static types: the loss on denormalized node targets
    over aux['real_node_mask'] (graph-family losses per graph) and the
    ``static/`` aggregates of `stress_errors`; mode_shape: the loss on
    normalized values, no metric."""
    prediction_type = cfg.prediction_type
    is_graph_loss = cfg.loss_function in GRAPH_FAMILY
    denorm, (ev_scale, ev_center) = _denorm_fns(normalizer, prediction_type)

    def compute_loss(pred, aux, batch: GraphBatch):
        if prediction_type == "buckling":
            y = batch.y[:, 0]
            return criterion(denorm(pred), denorm(y), batch.graph_mask)
        mask = aux["real_node_mask"]
        if "static" in prediction_type:
            p, y = denorm(pred), denorm(batch.y)
        else:  # mode_shape (TRAIN_FINAL.py:293-294)
            p, y = pred.float(), batch.y
        if is_graph_loss:
            return criterion(p, y, batch.node_graph, mask, batch.graph_mask,
                             batch.nodes)
        return criterion(p, y, mask)

    def compute_metrics(pred, aux, batch: GraphBatch):
        if prediction_type == "buckling":
            return {"mape": MAPE_error(pred.float(), batch.y[:, 0],
                                       batch.graph_mask, "buckling",
                                       ev_scale, ev_center)}
        if "static" in prediction_type:
            threshold = 0.0001 if prediction_type == "static_disp" else 0.2
            d = stress_errors(denorm(pred), denorm(batch.y),
                              batch.node_graph, aux["real_node_mask"],
                              batch.graph_mask, prediction_type, threshold)
            return {f"static/{k}": v for k, v in d.items()}
        return {}

    return compute_loss, compute_metrics


def make_train_step(model: BuckGNN, optimizer: torch.optim.Optimizer,
                    criterion, cfg: TrainConfig,
                    normalizer: DatasetNormalizer | None):
    """``(train_step, eval_step)``. ``train_step(batch, lr, generator)``
    runs one optimization step in place on the model (its parameters and
    its batch norms' running statistics) and the optimizer and returns the
    metrics (``loss`` and those of `make_loss_and_metrics`) as detached
    device scalars, without waiting for the device."""
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
    forward with its loss and metrics (the JAX eval_step); batch norms
    take their running statistics."""
    compute_loss, compute_metrics = make_loss_and_metrics(criterion, cfg,
                                                          normalizer)

    @torch.no_grad()
    def eval_step(batch: GraphBatch):
        pred, aux = model(batch, deterministic=True)
        metrics = compute_metrics(pred, aux, batch)
        metrics["loss"] = compute_loss(pred, aux, batch)
        return metrics, (pred, aux)

    return eval_step


def slice_static_targets(dataset: Sequence[GraphData],
                         prediction_type: str) -> list[GraphData]:
    """Target slicing for static runs (TRAIN_FINAL.py:1268-1279): the
    graph builder emits [disp | stress] node targets; static_disp keeps the
    first block, static_stress the last 3 columns."""
    if "static" not in prediction_type:
        return list(dataset)
    disp_dim = dataset[0].y.shape[1] - 3
    out = []
    for d in dataset:
        y = (d.y[:, disp_dim:] if prediction_type == "static_stress"
             else d.y[:, :disp_dim])
        out.append(dataclasses.replace(d, y=y))
    return out
