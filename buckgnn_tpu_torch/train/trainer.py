"""Model construction, the optimizer, loss/metric assembly, the steps and
the epoch loop.

The port of buckgnn_tpu/train/trainer.py. `TrainState` holds the model
(its parameters, and the batch norms' running statistics as buffers), the
optimizer (its moments, over the parameters only) and the epoch: the JAX
``TrainState``'s role. `make_train_step` gives one eager optimization
step, `train_step(batch, lr, generator)`: a forward with dropout seeds
drawn from ``generator`` (the batch norms normalize by the batch and move
their running statistics), the loss on denormalized targets, the
backward, and an Adam step at ``lr``; `eval_step` normalizes by the
running statistics. `train_gnn` is the training run (TRAIN_FINAL.py:
168-455): packing, the per-epoch schedule, metrics fetched from the device
once per epoch, last/best checkpoints that truly resume, results.txt.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Sequence

import numpy as np
import torch

from buckgnn_tpu_torch.config import TrainConfig, checkpoint_config_dict
from buckgnn_tpu_torch.graph.batch import (
    GraphBatch, GraphData, batch_iterator, select_band_geometry,
    suggest_capacities,
)
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.train import checkpoint as ckpt
from buckgnn_tpu_torch.train.losses import GRAPH_FAMILY, get_loss_function
from buckgnn_tpu_torch.train.metrics import MAPE_error, stress_errors
from buckgnn_tpu_torch.train.schedule import lr_for_epoch
from buckgnn_tpu_torch.utils import profiling
from buckgnn_tpu_torch.utils.device import resolve_device
from buckgnn_tpu_torch.utils.logging import MetricsWriter, ResultsFile
from buckgnn_tpu_torch.utils.profiling import StepTimer, span

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
        with span("train.step"):
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                pred, aux = model(batch, deterministic=False,
                                  generator=generator)
            with span("train.loss"):
                loss = compute_loss(pred, aux, batch)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                optimizer.step()
            with span("train.metrics"), torch.no_grad():
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
        with span("eval.step"):
            with span("eval.forward"):
                pred, aux = model(batch, deterministic=True)
            with span("eval.loss"):
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


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_val_mape: float
    history: list
    log_dir: str


def _fetch(acc: dict) -> dict:
    """The epoch's metric sums, device scalars, as host floats in one
    transfer (which waits for the device)."""
    keys = list(acc)
    values = torch.stack([acc[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def attach_shards(batches: list, model_name: str, floors: dict,
                  device) -> list:
    """The batches with the current mesh's ``model``-dim shards attached
    (one shard without a mesh), as the JAX trainer's pack: EA models
    tile-shard the edge windows (``ea_part``, parallel/ea_shard.py), the
    others partition the banded aggregation's node rows (``part``,
    parallel/partitioned.py). Caps and flags are the run's: each batch's
    shards are built once at its own caps and padded to the largest, with
    the EA caps sticky across repacks through ``floors``."""
    from buckgnn_tpu_torch.parallel.mesh import model_dim

    n_shards = model_dim()[1]
    if model_name.startswith("EA_GNN"):
        from buckgnn_tpu_torch.parallel.ea_shard import (
            pad_ea_shards, shard_caps, shard_ea_batch,
        )

        built = [shard_ea_batch(b, n_shards) for b in batches]
        needed = [shard_caps(s) for s in built]
        for i, k in enumerate(("ea_cl", "ea_cr", "ea_cs")):
            floors[k] = max(max(n[i] for n in needed), floors[k])
        caps = floors["ea_cl"], floors["ea_cr"], floors["ea_cs"]
        return [b.replace(ea_part=pad_ea_shards(s, *caps).to(device))
                for b, s in zip(batches, built)]
    from buckgnn_tpu_torch.parallel.partitioned import (
        pad_partitioned, partition_batch,
    )

    pbs = [partition_batch(b, n_shards) for b in batches]
    s_cap = max(int(pb.send_idx.shape[-1]) for pb in pbs)
    e_cap = max(int(pb.recv_perm.shape[-1]) for pb in pbs)
    any_spill = any(pb.has_spill for pb in pbs)
    return [b.replace(part=pad_partitioned(pb, s_cap, e_cap,
                                           force_spill=any_spill).to(device))
            for b, pb in zip(batches, pbs)]


def train_gnn(
    cfg: TrainConfig,
    train_data: Sequence[GraphData],
    val_data: Sequence[GraphData],
    normalizer: DatasetNormalizer | None,
    output_dir: str,
    trial_id: str | None = None,
    n_node_cap: int | None = None,
    n_edge_cap: int | None = None,
    resume_from: str | None = None,
    report_fn=None,
    verbose: bool = True,
    device=None,
) -> TrainResult:
    """The train_gnn orchestration (TRAIN_FINAL.py:168-455), as the JAX
    package runs it (buckgnn_tpu/train/trainer.py:237-535), on ``device``
    (the CUDA card unless ``device="cpu"``).

    Writes ``output_dir/tensorboard_logs/<trial_id>/``: the scalars,
    ``results.txt``, and ``weights/last`` every epoch and ``weights/best``
    by val MAPE (train/checkpoint.py). ``resume_from``, a checkpoint
    directory of either package, continues its run from its epoch with its
    weights and Adam moments. Dropout seeds come from a
    ``torch.Generator`` seeded with ``cfg.seed + 1``, seeded afresh on
    resume as the JAX package's key is, so a resumed run equals an
    uninterrupted one exactly at dropout rate 0 only. ``report_fn(entry)``
    gets each epoch's history entry and stops the run by returning False.

    ``segment_impl="banded_partitioned"`` shards each batch over the
    ``model`` dim of the current mesh (parallel/mesh.py::set_mesh; one
    shard without one): every rank of that dim runs this function on the
    same data, each with its own ``output_dir``.
    """
    device = resolve_device(device)
    train_data = slice_static_targets(train_data, cfg.prediction_type)
    val_data = slice_static_targets(val_data, cfg.prediction_type)
    trial_id = trial_id or f"manual_run_{int(time.time())}"
    log_dir = os.path.join(output_dir, "tensorboard_logs", trial_id)
    writer = MetricsWriter(log_dir)
    results = ResultsFile(
        os.path.join(log_dir, "results.txt"),
        header={"trial_id": trial_id, **dataclasses.asdict(cfg)},
    )
    wdir = os.path.join(log_dir, "weights")
    os.makedirs(wdir, exist_ok=True)

    num_node_features = train_data[0].x.shape[1]
    num_edge_features = train_data[0].edge_attr.shape[1]
    if n_node_cap is None or n_edge_cap is None:
        n_cap, e_cap = suggest_capacities(
            list(train_data) + list(val_data), cfg.batch_size
        )
        n_node_cap = n_node_cap or n_cap
        n_edge_cap = n_edge_cap or e_cap

    band_kw: dict = {}
    if cfg.segment_impl.startswith("banded"):
        # the JAX trainer's geometry (batch.py::select_band_geometry, one
        # source shared with eval/inference.py): EA models on tile 128
        # with widths (64, 128) for the fused block, whose width stays <=
        # tile; node capacity aligned to 4 tiles, RCM order
        ea = cfg.model_name.startswith("EA_")
        tile, width = select_band_geometry(
            list(train_data) + list(val_data),
            **(dict(tile=128, widths=(64, 128)) if ea else {}),
        )
        align = 4 * tile
        if cfg.segment_impl == "banded_partitioned":
            # node capacity splits into tile-aligned shard ranges; an EA
            # shard needs one full slab (tile + width <= 2 tiles) of rows
            from buckgnn_tpu_torch.parallel.mesh import model_dim

            n_shards = model_dim()[1]
            align = math.lcm(align, n_shards * tile)
            if ea:
                align = math.lcm(align, n_shards * 2 * tile)
        n_node_cap = ((max(n_node_cap, tile + width) + align - 1)
                      // align) * align
        band_kw = dict(band_width=width, band_tile=tile, rcm=True,
                       materialize_band=cfg.materialize_band)

    model = build_model(cfg, num_node_features, num_edge_features,
                        device=device)
    optimizer = make_optimizer(cfg, model)

    all_values = (
        [float(np.reshape(d.y, (-1,))[0]) for d in train_data]
        if cfg.prediction_type == "buckling"
        else np.concatenate([np.reshape(d.y, (-1,)) for d in train_data])
    )
    criterion = get_loss_function(cfg.loss_function, all_values,
                                  cfg.use_z_coord, cfg.use_rotations)
    train_step, eval_step = make_train_step(model, optimizer, criterion, cfg,
                                            normalizer)

    # sticky edge-window caps: a repack_every_epoch reshuffle must not
    # change the windowed shapes, so the largest caps seen so far come back
    # in as floors; the local star windows, once dropped by any repack,
    # stay dropped (the JAX trainer keeps one compiled step this way; here
    # it keeps every epoch's batches alike)
    win_floors = {"w": 0, "f": 0, "ft": 0, "fs": 0, "s": 0, "s2": 0,
                  "b": 0, "ea_cl": 0, "ea_cr": 0, "ea_cs": 0,
                  "local_star": True}

    def pack(data, shuffle, seed):
        batches = list(
            batch_iterator(data, cfg.batch_size, n_node_cap, n_edge_cap,
                           shuffle=shuffle, seed=seed,
                           min_win_cap=win_floors["w"],
                           min_far_cap=win_floors["f"],
                           min_far_tile_cap=win_floors["ft"],
                           min_fs_cap=win_floors["fs"],
                           min_spill_cap=win_floors["s"],
                           min_spill2_cap=win_floors["s2"],
                           min_band_cap=win_floors["b"],
                           local_star_windows=win_floors["local_star"],
                           device=device, **band_kw)
        )
        if batches and batches[0].win_edges is not None:
            b = batches[0]
            win_floors["w"] = max(win_floors["w"], b.win_edges.shape[1])
            win_floors["f"] = max(win_floors["f"], b.win_far_pos.shape[0])
            win_floors["ft"] = max(win_floors["ft"],
                                   b.win_far_tsend.shape[1])
            win_floors["fs"] = max(win_floors["fs"], b.win_fs_src.shape[1])
        if batches and batches[0].spill_senders is not None:
            b = batches[0]
            win_floors["s"] = max(win_floors["s"],
                                  int(b.spill_senders.shape[0]))
            win_floors["s2"] = max(win_floors["s2"],
                                   int(b.spill2_senders.shape[0]))
            win_floors["b"] = max(win_floors["b"],
                                  int(b.band_senders.shape[0]))
        if any(b.gcode is not None and b.gwin is None for b in batches):
            win_floors["local_star"] = False
        if cfg.segment_impl == "banded_partitioned" and batches:
            batches = attach_shards(batches, cfg.model_name, win_floors,
                                    device)
        return batches

    train_batches = pack(train_data, True, cfg.seed)
    val_batches = pack(val_data, False, 0)

    state = init_state(model, optimizer)
    start_epoch = 0
    if resume_from is not None:
        start_epoch, _, _, _ = ckpt.load_checkpoint(resume_from, model,
                                                    optimizer)
        state.epoch = start_epoch

    cfg_dict = checkpoint_config_dict(cfg, num_node_features,
                                      num_edge_features)
    generator = torch.Generator().manual_seed(cfg.seed + 1)
    best_fitness = 1e10
    history = []

    epoch_edges = sum(int(b.edge_mask.sum()) for b in train_batches)
    val_graphs = sum(int(b.graph_mask.sum()) for b in val_batches)
    timer = StepTimer()
    profiler_cm = None
    if cfg.profile_epochs > 0:
        profiler_cm = profiling.trace(os.path.join(log_dir, "profile"))
        profiler_cm.__enter__()

    for epoch in range(start_epoch, cfg.num_epochs):
        lr = lr_for_epoch(cfg, epoch)
        if cfg.repack_every_epoch and epoch > start_epoch:
            train_batches = pack(train_data, True, cfg.seed + epoch)
        order = np.random.default_rng(cfg.seed + epoch).permutation(
            len(train_batches)
        )
        # metrics stay on the device across the epoch (one host fetch per
        # epoch); the reference syncs per batch via .item()
        # (TRAIN_FINAL.py:298)
        acc = None
        timer.start()
        for bi in order:
            metrics = train_step(train_batches[bi], lr, generator)
            acc = metrics if acc is None else {
                k: acc[k] + v for k, v in metrics.items()}
        acc = _fetch(acc)
        timer.stop(len(train_batches), epoch_edges)
        if profiler_cm is not None and epoch - start_epoch + 1 >= \
                cfg.profile_epochs:
            profiler_cm.__exit__(None, None, None)
            profiler_cm = None
        train_loss = acc["loss"] / len(train_batches)
        train_mape = acc.get("mape", 0.0) / len(train_batches)

        vacc = None
        for b in val_batches:
            metrics, _ = eval_step(b)
            vacc = metrics if vacc is None else {
                k: vacc[k] + v for k, v in metrics.items()}
        vacc = _fetch(vacc)
        val_loss = vacc["loss"] / len(val_batches)
        val_mape = vacc.get("mape", 0.0) / len(val_batches)

        writer.add_scalar("Learning_Rate", lr, epoch)
        writer.add_scalar("Loss/train", train_loss, epoch)
        writer.add_scalar("Loss/validation", val_loss, epoch)
        writer.add_scalar("Perf/train_step_ms", timer.step_ms, epoch)
        writer.add_scalar("Perf/train_edges_per_s", timer.edges_per_s, epoch)
        timer.reset()
        if cfg.prediction_type == "buckling":
            writer.add_scalar("MAPE/train", train_mape, epoch)
            writer.add_scalar("MAPE/val", val_mape, epoch)
        for k, v in vacc.items():
            # per-key static aggregates, per graph (stress_errors sums over
            # graphs; INFERENCE.py:153-172 averages per sample)
            if k.startswith("static/"):
                writer.add_scalar(f"{k}/val", v / max(val_graphs, 1), epoch)

        state.epoch = epoch + 1
        ckpt.save_checkpoint(os.path.join(wdir, "last"), state, cfg,
                             cfg_dict, normalizer)
        if cfg.prediction_type == "buckling" and val_mape < best_fitness:
            best_fitness = val_mape
            ckpt.save_checkpoint(os.path.join(wdir, "best"), state, cfg,
                                 cfg_dict, normalizer)

        s = (
            f"Epoch {epoch + 1}/{cfg.num_epochs}, Train_Loss: {train_loss:.4f}, "
            f"Train_Mape: {train_mape:.2f}%, Val_Loss: {val_loss:.4f}, "
            f"Val_Mape:{val_mape:.2f}%"
        )
        results.append(s)
        if verbose:
            print(s)
        history.append(
            dict(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                 train_mape=train_mape, val_mape=val_mape, lr=lr)
        )
        if report_fn is not None:
            # Ray-Tune-style reporting hook (TRAIN_FINAL.py:447-453);
            # returns False to early-stop (ASHA-like schedulers)
            if report_fn(history[-1]) is False:
                break

    if profiler_cm is not None:  # fewer epochs ran than profile_epochs
        profiler_cm.__exit__(None, None, None)
    writer.close()
    return TrainResult(state=state, best_val_mape=best_fitness,
                       history=history, log_dir=log_dir)
