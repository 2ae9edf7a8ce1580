"""Serving benchmark setup: the flagship model answering one packed batch.

The serving counterpart of the repo-root bench.py (build_bench_setup and
the infer half of run_bench): data, model and batch, with no optimizer.
The flagship is ``build_serve_setup()``: 128 synthetic supernode panels
(24-32 nodes a side), normalized, RCM-ordered and packed into one batch
on the band that `select_band_geometry` picks, served by the 6-layer,
hidden-512, bf16 ``GraphSage_addAggr_Shared`` model with random weights
from a seeded generator.
"""

from __future__ import annotations

import time

import torch

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.utils.device import resolve_device


def pack_exact(normed, batch_size: int, band_width: int | None,
               band_tile: int, device):
    """One batch holding the whole dataset, with exact capacities (nodes
    aligned to 4 tiles, as the JAX bench packs)."""
    from buckgnn_tpu_torch.graph.batch import batch_iterator

    n_real = sum(g.n_node for g in normed) + 1  # + dead node
    e_real = sum(g.n_edge for g in normed)
    ecap = ((e_real + 255) // 128) * 128
    align = 4 * band_tile
    ncap = ((max(n_real, band_tile + band_width) + align - 1)
            // align) * align
    return next(iter(batch_iterator(normed, batch_size, ncap, ecap,
                                    band_width=band_width,
                                    band_tile=band_tile, rcm=True,
                                    device=device)))


def build_serve_setup(device=None):
    """The flagship cell. Returns dict(model, batch, eval_step, normalizer,
    dataset, cfg, n_edges, n_graphs) on ``device`` (the CUDA card unless
    "cpu")."""
    from buckgnn_tpu_torch.graph.batch import select_band_geometry
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model, make_eval_step

    device = resolve_device(device)
    batch_size = 128
    dataset = generate_dataset(batch_size, seed=0, min_side=24, max_side=32,
                               use_super_node=True, use_virtual_edges=False)
    normed, nz = normalize_dataset(dataset)
    cfg = TrainConfig(hidden_channels=512, num_layers=6,
                      compute_dtype="bfloat16", seed=0)
    band_tile, band_width = select_band_geometry(normed, tile=256)
    batch = pack_exact(normed, batch_size, band_width, band_tile, device)
    model = build_model(cfg, normed[0].x.shape[1],
                        normed[0].edge_attr.shape[1], device=device)
    eval_step = make_eval_step(model, get_loss_function(cfg.loss_function),
                               cfg, nz)
    return dict(model=model, batch=batch, eval_step=eval_step,
                normalizer=nz, dataset=normed, cfg=cfg,
                n_edges=int(batch.edge_mask.sum()),
                n_graphs=int(batch.graph_mask.sum()))


def run_serve_bench(setup, n_warmup=3, n_steps=20):
    """Serve step time of ``eval_step`` on the setup's batch; the host
    clock spans work that ends in a device synchronize."""
    batch, eval_step = setup["batch"], setup["eval_step"]
    dev = batch.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(n_warmup):
        m, _ = eval_step(batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m, _ = eval_step(batch)
    sync()
    dt = (time.perf_counter() - t0) / n_steps
    return dict(
        infer_step_ms=dt * 1e3,
        infer_edges_per_s=setup["n_edges"] / dt,
        infer_samples_per_s=setup["n_graphs"] / dt,
        n_edges=setup["n_edges"],
        n_graphs=setup["n_graphs"],
        metrics={k: float(v) for k, v in m.items()},
    )
