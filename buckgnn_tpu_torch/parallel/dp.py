"""Data-parallel (+ edge-sharded) training over a device mesh.

The port of buckgnn_tpu/parallel/dp.py. The JAX package stacks one packed
batch per data-parallel group on a leading axis, shards it over the
``data`` mesh axis and vmaps the per-batch loss inside one jit, so that
XLA turns the gradient reduction into a psum. One process per card does
the same with collectives in the open: every rank runs the model on its
own batch (the ranks of one ``data`` index, the ``model`` group, on the
same batch, each with its shard of it), then

- each rank's loss is weighted by its real-graph count over the ``data``
  group's total, so the result equals the single-device loss on the
  concatenation of the batches;
- metrics are weighted the same way, except the per-graph ``static/*``
  sums, which simply add;
- the gradients are summed over the ``data`` group (``all_reduce``) and
  one Adam update runs on every rank, so the replicas stay equal;
- the batch norms' running statistics are averaged over the ``data``
  group;
- dropout streams differ between ``data`` indices and agree within a
  ``model`` group, whose ranks compute the same replicated activations.

Of the JAX module's helpers, ``stack_batches``, ``shard_stacked_batch`` and
``replicate`` have no counterpart: nothing is stacked, each process holds
its own batch, which `local_batch` picks from the world's list, and every
rank builds the same weights from the config's seed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer
from buckgnn_tpu_torch.models.buckgnn import BuckGNN
from buckgnn_tpu_torch.parallel.mesh import DATA_AXIS, mesh_dim, set_mesh
from buckgnn_tpu_torch.train.trainer import make_loss_and_metrics


def local_batch(batches, mesh, device=None):
    """This rank's batch of ``batches`` (one per ``data`` index, the same
    list on every rank), on ``device`` when given."""
    _, _, i = mesh_dim(mesh, DATA_AXIS)
    b = batches[i]
    return b if device is None else b.to(device)


def _rank_generator(generator, data_index: int):
    """A dropout generator of this ``data`` index: one draw from the
    caller's generator (the same on every rank) and the index."""
    if generator is None:
        return None
    base = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator().manual_seed(base + 7919 * data_index)


def make_parallel_train_step(model: BuckGNN, optimizer, criterion,
                             cfg: TrainConfig,
                             normalizer: DatasetNormalizer | None, mesh):
    """``train_step(batch, lr, generator)``: one data-parallel step on this
    rank's batch, in place on the model and the optimizer; returns the
    metrics of the whole ``data`` group (``loss`` and those of
    `train.trainer.make_loss_and_metrics`), the same on every rank. The
    loss and metric assembly is the trainer's own, so the step computes
    the single-device loss of the concatenated batches and the full metric
    dict."""
    compute_loss, compute_metrics = make_loss_and_metrics(criterion, cfg,
                                                          normalizer)
    group, _, data_index = mesh_dim(mesh, DATA_AXIS)
    n_data = mesh_dim(mesh, DATA_AXIS)[1]
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def train_step(batch, lr: float, generator: torch.Generator | None):
        for g in optimizer.param_groups:
            g["lr"] = float(lr)
        optimizer.zero_grad(set_to_none=True)
        gen = _rank_generator(generator, data_index)
        with set_mesh(mesh):
            pred, aux = model(batch, deterministic=False, generator=gen)
            loss = compute_loss(pred, aux, batch)
            weight = batch.graph_mask.float().sum()
            total = weight.clone()
            dist.all_reduce(total, group=group)
            w = weight / total.clamp_min(1.0)
            (loss * w).backward()
        flat = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                          else p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=group)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        with torch.no_grad():
            for b in stats:
                dist.all_reduce(b, group=group)
                b.div_(n_data)
        optimizer.step()
        with torch.no_grad():
            metrics = compute_metrics(pred.detach(), aux, batch)
            keys = sorted(metrics)
            vals = torch.stack(
                [(loss.detach() * w).float()]
                + [metrics[k].float() if k.startswith("static/")
                   else (metrics[k] * w).float() for k in keys])
            dist.all_reduce(vals, group=group)
        out = dict(zip(keys, vals[1:]))
        out["loss"] = vals[0]
        return out

    return train_step
