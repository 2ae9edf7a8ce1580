"""Scaling-efficiency harness: throughput at 1 device against N devices.

The port of buckgnn_tpu/parallel/scaling.py: data-parallel training
throughput (graphs/s, edges/s) with the same step (parallel/dp.py) on one
device and on N, and the efficiency throughput_N / (N * throughput_1).

The JAX package is one process over N devices; here one world of N
processes, one per device, measures both counts (the first rank alone,
then all N), spawned (``spawn`` start method) on NCCL over the cards, or
on gloo over CPU processes with ``device="cpu"``, where the numbers say
nothing of hardware but the code path runs. Called inside a world that is
up, the harness runs there instead. Every spawned world has a time limit
and is joined; a world that hangs or fails raises.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time

import numpy as np
import torch

from buckgnn_tpu_torch.config import TrainConfig

__all__ = ["scaling_bench", "run_world"]

WORLD_TIMEOUT_S = 600


def run_world(fn, n: int, args=(), device=None,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``fn(rank, world, *args)`` in a world of ``n`` spawned processes
    (`mesh.initialize_distributed` on 127.0.0.1: NCCL over the cards unless
    ``device="cpu"``, then gloo); returns each rank's result in rank order.
    ``fn`` must be importable by name. Raises when a rank fails or the
    world outlives ``timeout`` seconds (its processes are killed)."""
    import torch.multiprocessing as mp

    from buckgnn_tpu_torch.parallel.mesh import free_port

    dev = "cpu" if device is not None and torch.device(device).type == "cpu" \
        else "cuda"
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the world on gloo")
        if n > torch.cuda.device_count():
            raise ValueError(f"a world of {n} processes needs {n} cards, "
                             f"have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, n, addr, dev, args, out))
             for rank in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {n} did not finish in "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(
                        f"a rank of a world of {n} exited with code "
                        f"{dead[0].exitcode}") from None
                continue
            (results.__setitem__(rank, value) if ok
             else errors.append((rank, value)))
        if errors:
            raise RuntimeError(f"rank {errors[0][0]} failed:\n"
                               f"{errors[0][1]}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def _rank_main(fn, rank, world, addr, dev, args, out):
    import traceback

    import torch.distributed as dist

    from buckgnn_tpu_torch.parallel.mesh import initialize_distributed

    try:
        if dev == "cpu":
            # the world's processes share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        initialize_distributed(addr, world, rank, device=dev)
        value = fn(rank, world, *args)
        out.put((rank, True, value))
    except BaseException:
        # SystemExit too (a failed check): reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _throughput(step, batch, lr, gen, n_steps: int, sync,
                n_warmup: int = 2) -> float:
    for _ in range(n_warmup):
        metrics = step(batch, lr, gen)
    float(metrics["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        metrics = step(batch, lr, gen)
    float(metrics["loss"])
    sync()
    return n_steps / (time.perf_counter() - t0)


def _batches(n_devices, graphs_per_device, min_side, max_side, seed):
    from buckgnn_tpu_torch.graph.batch import (
        batch_iterator, suggest_capacities,
    )
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset

    ds = generate_dataset(graphs_per_device * n_devices, seed=seed,
                          min_side=min_side, max_side=max_side)
    normed, nz = normalize_dataset(ds)
    ncap, ecap = suggest_capacities(normed, graphs_per_device, slack=1.3)
    ecap = ((ecap + 127) // 128) * 128
    batches = list(batch_iterator(normed, graphs_per_device, ncap, ecap,
                                  device="cpu"))[:n_devices]
    return normed, nz, batches


def _in_world(n_devices, cfg, graphs_per_device, min_side, max_side,
              n_steps, seed) -> dict:
    """The harness on the first ``n_devices`` ranks of the world that is up
    (every rank calls it; each gets the result)."""
    import torch.distributed as dist

    from buckgnn_tpu_torch.parallel.dp import (
        local_batch, make_parallel_train_step,
    )
    from buckgnn_tpu_torch.parallel.mesh import make_mesh
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model, make_optimizer

    if n_devices > dist.get_world_size():
        raise ValueError(f"scaling over {n_devices} devices in a world of "
                         f"{dist.get_world_size()}")
    cuda = dist.get_backend() == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    normed, nz, batches = _batches(n_devices, graphs_per_device, min_side,
                                   max_side, seed)
    edges_per_batch = int(np.mean([int(b.edge_mask.sum()) for b in batches]))
    rank = dist.get_rank()
    results = {}
    for n in sorted({1, n_devices}):
        mesh = make_mesh(n_data=n, n_model=1, devices=list(range(n)))
        sps = [0.0]
        if rank < n:
            model = build_model(cfg, normed[0].x.shape[1],
                                normed[0].edge_attr.shape[1], device=dev)
            opt = make_optimizer(cfg, model)
            step = make_parallel_train_step(
                model, opt, get_loss_function(cfg.loss_function), cfg, nz,
                mesh)
            sps[0] = _throughput(step, local_batch(batches[:n], mesh, dev),
                                 cfg.lr, torch.Generator().manual_seed(0),
                                 n_steps, sync)
        dist.broadcast_object_list(sps, src=0)
        results[n] = dict(
            steps_per_s=sps[0],
            graphs_per_s=sps[0] * graphs_per_device * n,
            edges_per_s=sps[0] * edges_per_batch * n,
        )
    eff = (results[n_devices]["edges_per_s"]
           / (n_devices * results[1]["edges_per_s"])
           if n_devices > 1 else 1.0)
    return dict(
        n_devices=n_devices,
        per_count=results,
        scaling_efficiency=eff,
        edges_per_batch=edges_per_batch,
        backend="cuda" if cuda else "cpu",
    )


def _world_rank(rank, world, *args):
    return _in_world(world, *args)


def scaling_bench(
    n_devices: int | None = None,
    cfg: TrainConfig | None = None,
    graphs_per_device: int = 8,
    min_side: int = 8,
    max_side: int = 12,
    n_steps: int = 10,
    seed: int = 0,
    device=None,
) -> dict:
    """DP throughput at 1 device and at ``n_devices``; returns steps/s,
    per-device-batch graphs/s and edges/s per count, and the scaling
    efficiency. Called in a world that is up, every rank calls it and it
    runs on the first ``n_devices`` ranks (default: all); otherwise it
    spawns a world of ``n_devices`` processes, on the cards (default: every
    card; raises when there are fewer) unless ``device="cpu"`` (default 2
    processes)."""
    import torch.distributed as dist

    cfg = cfg or TrainConfig(hidden_channels=64, num_layers=3,
                             batch_size=graphs_per_device, lr=1e-3)
    cfg = dataclasses.replace(cfg, batch_size=graphs_per_device)
    args = (cfg, graphs_per_device, min_side, max_side, n_steps, seed)
    if dist.is_initialized():
        return _in_world(n_devices or dist.get_world_size(), *args)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the harness on the CPU")
    n_devices = n_devices or (2 if cpu else torch.cuda.device_count())
    if not cpu and n_devices > torch.cuda.device_count():
        raise ValueError(f"scaling over {n_devices} devices needs as many "
                         f"cards, have {torch.cuda.device_count()}")
    return run_world(_world_rank, n_devices, args=args,
                     device="cpu" if cpu else None)[0]
