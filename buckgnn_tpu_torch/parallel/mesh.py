"""Device mesh for data x model (edge-partition) parallelism.

The port of buckgnn_tpu/parallel/mesh.py. The JAX package is one process
over a `jax.sharding.Mesh`; PyTorch's idiom is one process per card, so
here the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the world, with the same two dims:

- ``data``: data parallelism. Each rank group trains on its own packed
  batch; gradients are summed over this dim (parallel/dp.py).
- ``model``: edge partitioning. The ranks of one ``data`` index share one
  batch and split its node rows (parallel/partitioned.py) or its edge
  windows (parallel/ea_shard.py) between them.

`set_mesh` makes a mesh current, as ``jax.set_mesh`` makes one ambient: the
model's partitioned routes and the trainer read the ``model`` dim from it
(`model_dim`), and see one shard when no mesh is current.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket

import torch
import torch.distributed as dist

from buckgnn_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# how long a collective may wait for its peers before it fails (a world
# that hangs must end, not hold its caller)
TIMEOUT_S = 300

_CURRENT: list = []


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a new world's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None):
    """Mesh of shape (n_data, n_model) over the world's ranks ``devices``
    (default: every rank), ``data`` major. Defaults to every rank on
    ``data``. Needs `initialize_distributed` first; the mesh's device type
    follows the world's backend (NCCL: the card, gloo: the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs torch.distributed: call "
                               "initialize_distributed first")
        devices = list(range(dist.get_world_size()))
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}"
        )
    ranks = torch.tensor(list(devices)[: n_data * n_model]).reshape(
        n_data, n_model)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost mesh of `set_mesh`, or None."""
    return _CURRENT[-1] if _CURRENT else None


def mesh_dim(mesh, name: str) -> tuple:
    """``(group, size, index)`` of this rank in dim ``name`` of ``mesh``:
    (None, 1, 0) without a mesh."""
    if mesh is None:
        return None, 1, 0
    i = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.size(i), mesh.get_local_rank(name)


def model_dim(mesh=None) -> tuple:
    """`mesh_dim` of the ``model`` dim of ``mesh`` (default: the current
    mesh): the shards of one batch, and this rank's shard."""
    return mesh_dim(mesh if mesh is not None else current_mesh(),
                    MODEL_AXIS)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> dict:
    """Bring up the world (`torch.distributed.init_process_group`) and
    return its topology. Idempotent: a second call, or a call in a world
    already up, only reports it.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name the world; without them ``torchrun``'s environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) does, and without that
    this process is a world of one on a free port of 127.0.0.1. NCCL on
    the card (each process takes card LOCAL_RANK, or its rank modulo the
    cards), gloo only when ``device="cpu"``. One device per process, so
    ``local_devices`` is 1 and ``global_devices`` the world size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        env = os.environ
        if coordinator_address is not None:
            init = f"tcp://{coordinator_address}"
            world, rank = int(num_processes), int(process_id)
        elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
            init = "env://"
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        else:
            init = f"tcp://127.0.0.1:{free_port()}"
            world, rank = 1, 0
        if dev.type == "cuda":
            local = int(env.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dict(
        process_index=dist.get_rank(),
        process_count=dist.get_world_size(),
        local_devices=1,
        global_devices=dist.get_world_size(),
    )


def host_shard(items, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Per-host slice of a dataset/work list (round-robin): each process
    builds only its own shard (the multi-host input pipeline)."""
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None \
        else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


# ---- collectives under autograd --------------------------------------------
#
# One process per card computes the replicated parts of a model (the
# encoders, pooling, the decoder) on every rank of a ``model`` group, so
# their gradients are whole on every rank; only a sharded operator's own
# partials need a sum. These two are its boundaries (Megatron's f and g).


class _SumPartials(torch.autograd.Function):
    """Forward: the sum of every rank's partial; backward: the replicated
    cotangent passes to each partial as it is."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """Forward: identity on a replicated tensor used by a sharded operator;
    backward: the ranks' partial gradients summed, so that the tensor's
    gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_partials(t: torch.Tensor, group) -> torch.Tensor:
    """all_reduce(sum) of ``t`` over ``group`` (whose result every rank
    then uses whole); its gradient is the cotangent unchanged."""
    return _SumPartials.apply(t, group)


def sum_grads(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged; its gradient all_reduce(sum)'d over ``group``."""
    return _SumGrads.apply(t, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' [n, ...] blocks of ``group`` stacked in rank order (no
    autograd)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
