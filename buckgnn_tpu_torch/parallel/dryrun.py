"""Multi-device dry run: the flagship SAGE step and the EA step over a
(data x model) mesh, with loss and update parity against one device.

The port of ``dryrun_multichip`` and ``_dryrun_ea`` of the JAX package's
repo-root ``__graft_entry__.py``. `dryrun_multichip` runs on every rank of
a world that is up (parallel/mesh.py::initialize_distributed; for example
through parallel/scaling.py::run_world):

1. the FULL flagship step (6 layers, hidden 512, shared SAGE, supernode
   pooling) with data parallelism over ``data`` and the banded aggregation
   edge-partitioned over ``model`` (halo exchange, spill all_to_all, star
   all_reduce; parallel/partitioned.py), one step on tiny node counts that
   put graphs across the shard boundary and edges out of band;
2. the same at dropout 0 against a single-device oracle ('banded', the
   graph-weighted loss over every data index's batch, one accumulated
   gradient, the same Adam update): the losses, and the update vectors'
   norms and cosine;
3. EA_GNN_Shared (hidden 128, 2 layers, dropout 0) with the edge windows
   tile-sharded over ``model`` (parallel/ea_shard.py: kernels #5 and #6
   per shard in 'hybrid' mode) against the single-device fused path
   ('banded_pallas'), with the same two parities.

On the card the EA step runs in bfloat16, the kernels' type; the SAGE step
in float32, as on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

# parity gates, as (loss rtol, loss atol, update norm rtol, 1 - cosine):
# float32 as the JAX dry run holds them. bfloat16 (the EA step on the
# card): the sharded and single-device steps round their bf16 values in
# another order, which moves the loss and, through Adam's division by
# sqrt(v), the update of parameters whose gradients are near zero.
PARITY_TOL = {torch.float32: (1e-4, 1e-6, 1e-4, 1e-5),
              torch.bfloat16: (1e-2, 1e-4, 1e-2, 1e-2)}


def _oracle_accum_step(model, criterion, cfg, nz, batches, lr):
    """Single-device oracle of the DP step's math: the graph-weighted mean
    loss over the batches, one accumulated gradient, one Adam update of a
    fresh optimizer. Returns (loss, update fingerprint)."""
    from buckgnn_tpu_torch.train.trainer import (
        make_loss_and_metrics, make_optimizer,
    )

    compute_loss, _ = make_loss_and_metrics(criterion, cfg, nz)
    opt = make_optimizer(cfg, model)
    before = _params(model)
    tot, wsum = 0.0, 0.0
    for b in batches:
        pred, aux = model(b, deterministic=False)
        w = b.graph_mask.float().sum()
        tot = tot + compute_loss(pred, aux, b) * w
        wsum = wsum + w
    loss = tot / wsum.clamp_min(1.0)
    loss.backward()
    for g in opt.param_groups:
        g["lr"] = float(lr)
    opt.step()
    return float(loss.detach()), _update_fingerprint(before, _params(model))


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _update_fingerprint(old, new) -> np.ndarray:
    """Flattened parameter update (new - old) for parity checks."""
    return np.concatenate([(b - a).float().reshape(-1).cpu().numpy()
                           for a, b in zip(old, new)])


def _assert_update_parity(tag, fp_a, fp_b, tol):
    l2a = float(np.linalg.norm(fp_a))
    l2b = float(np.linalg.norm(fp_b))
    cos = float(np.dot(fp_a, fp_b) / max(l2a * l2b, 1e-30))
    np.testing.assert_allclose(l2a, l2b, rtol=tol[2], err_msg=tag)
    assert cos > 1.0 - tol[3], (tag, cos)
    return l2a, l2b, cos


def _step(model, cfg, nz, batch, mesh, lr, seed):
    from buckgnn_tpu_torch.parallel.dp import make_parallel_train_step
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import make_optimizer

    opt = make_optimizer(cfg, model)
    step = make_parallel_train_step(model, opt,
                                    get_loss_function(cfg.loss_function),
                                    cfg, nz, mesh)
    before = _params(model)
    metrics = step(batch, lr, torch.Generator().manual_seed(seed))
    return float(metrics["loss"]), _update_fingerprint(before,
                                                       _params(model))


def dryrun_multichip(device=None) -> dict:
    """One DP x partitioned flagship step and one DP x TP EA step on this
    world's mesh (n_model 2 when the world is even, else 1), each held to
    its single-device oracle. Every rank returns the same dict of losses
    and update fingerprints' norms and cosines; a failed parity raises."""
    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.graph.batch import batch_iterator
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset
    from buckgnn_tpu_torch.parallel.dp import local_batch
    from buckgnn_tpu_torch.parallel.mesh import make_mesh
    from buckgnn_tpu_torch.parallel.partitioned import (
        pad_partitioned, partition_batch,
    )
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model
    from buckgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n_devices = dist.get_world_size()
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model
    mesh = make_mesh(n_data=n_data, n_model=n_model)

    # sides 11-12 (121-144 nodes a graph): each 2-graph batch straddles the
    # shard boundary at row 256 of the 512-row capacity, and edges beyond
    # the width-16 halo land out of band, so the spill all_to_all runs
    # beside the halo exchange and the star all_reduce
    ds = generate_dataset(2 * n_data, seed=0, min_side=11, max_side=12,
                          use_super_node=True, use_virtual_edges=True)
    normed, nz = normalize_dataset(ds)
    cfg = TrainConfig(hidden_channels=512, num_layers=6, batch_size=2,
                      dropout_rate=0.1, lr=1e-3,
                      pooling_layer="supernode_with_pooling",
                      segment_impl="banded_partitioned")
    tile, width = 128, 16
    ncap = 2 * n_model * tile
    batches = list(batch_iterator(normed, 2, ncap, 2048, band_width=width,
                                  band_tile=tile, device="cpu"))[:n_data]
    assert len(batches) == n_data
    pbs = [partition_batch(b, n_model) for b in batches]
    s_cap = max(int(pb.send_idx.shape[-1]) for pb in pbs)
    e_cap = max(int(pb.recv_perm.shape[-1]) for pb in pbs)
    any_spill = any(pb.has_spill for pb in pbs)
    assert any_spill, (
        "dryrun batches must carry out-of-band edges so the spill "
        "all_to_all is exercised")
    batches = [b.replace(part=pad_partitioned(pb, s_cap, e_cap,
                                              force_spill=any_spill))
               for b, pb in zip(batches, pbs)]
    mine = local_batch(batches, mesh, dev)
    n_feat, e_feat = normed[0].x.shape[1], normed[0].edge_attr.shape[1]

    model = build_model(cfg, n_feat, e_feat, device=dev)
    loss, _ = _step(model, cfg, nz, mine, mesh, cfg.lr, 0)
    assert np.isfinite(loss), loss

    tol = PARITY_TOL[torch.float32]
    cfg0 = dataclasses.replace(cfg, dropout_rate=0.0)
    part_loss, part_fp = _step(build_model(cfg0, n_feat, e_feat, device=dev),
                               cfg0, nz, mine, mesh, cfg.lr, 0)
    cfg_b = dataclasses.replace(cfg0, segment_impl="banded")
    oracle_loss, oracle_fp = _oracle_accum_step(
        build_model(cfg_b, n_feat, e_feat, device=dev),
        get_loss_function(cfg.loss_function), cfg_b, nz,
        [b.replace(part=None).to(dev) for b in batches], cfg.lr)
    np.testing.assert_allclose(part_loss, oracle_loss, rtol=tol[0],
                               atol=tol[1])
    l2p, l2o, cos = _assert_update_parity("sage", part_fp, oracle_fp, tol)
    out = dict(mesh=[n_data, n_model], sage=dict(
        loss=loss, partitioned_loss=part_loss, oracle_loss=oracle_loss,
        update_l2=l2p, oracle_update_l2=l2o, cos=cos))
    out["ea"] = _dryrun_ea(mesh, n_data, n_model, dev)
    return out


def _dryrun_ea(mesh, n_data: int, n_model: int, dev) -> dict:
    """DP x TP for the EA_GNN_Shared train step (edge windows tile-sharded
    over ``model``, kernels #5 and #6 per shard in 'hybrid' mode) against
    the single-device fused path, at dropout 0."""
    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.graph.batch import (
        batch_iterator, suggest_capacities,
    )
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset
    from buckgnn_tpu_torch.ops.ea_block import supports_fused_ea
    from buckgnn_tpu_torch.parallel.dp import local_batch
    from buckgnn_tpu_torch.parallel.ea_shard import shard_caps, shard_ea_batch
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model

    # sides 11-12 with virtual edges and width 16: graph spans exceed the
    # 144-row slab, so out-of-band senders exist at every device count
    ds = generate_dataset(2 * n_data, seed=7, min_side=11, max_side=12,
                          use_super_node=False, use_virtual_edges=True)
    normed, nz = normalize_dataset(ds)
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    cfg = TrainConfig(hidden_channels=128, num_layers=2, batch_size=2,
                      dropout_rate=0.0, lr=1e-3,
                      segment_impl="banded_partitioned",
                      model_name="EA_GNN_Shared", compute_dtype=dtype)
    tile, width = 128, 16
    ncap, ecap = suggest_capacities(normed, 2)
    # each shard needs at least one full slab (tile + width) of rows
    align = n_model * 2 * tile
    ncap = ((max(ncap, tile + width) + align - 1) // align) * align
    ecap = ((ecap + 127) // 128) * 128
    batches = list(batch_iterator(normed, 2, ncap, ecap, band_width=width,
                                  band_tile=tile, rcm=True,
                                  device="cpu"))[:n_data]
    assert len(batches) == n_data
    assert supports_fused_ea(batches[0], cfg.hidden_channels), (
        "EA dryrun must exercise the fused-kernel path")
    needed = [shard_caps(shard_ea_batch(b, n_model)) for b in batches]
    cl = max(n[0] for n in needed)
    cr = max(n[1] for n in needed)
    cs = max(n[2] for n in needed)
    shards = [shard_ea_batch(b, n_model, local_cap=cl, remote_cap=cr,
                             fs_cap=cs) for b in batches]
    dead = ncap - 1
    assert any(int((s.far != dead).sum()) > 0 for s in shards), (
        "EA dryrun shards carry no real far rows")
    batches = [b.replace(ea_part=s) for b, s in zip(batches, shards)]
    n_feat, e_feat = normed[0].x.shape[1], normed[0].edge_attr.shape[1]
    tol = PARITY_TOL[torch.bfloat16 if dtype == "bfloat16"
                     else torch.float32]

    ea_loss, ea_fp = _step(build_model(cfg, n_feat, e_feat, device=dev),
                           cfg, nz, local_batch(batches, mesh, dev), mesh,
                           cfg.lr, 0)
    assert np.isfinite(ea_loss), ea_loss
    cfg_1 = dataclasses.replace(cfg, segment_impl="banded_pallas")
    oracle_loss, oracle_fp = _oracle_accum_step(
        build_model(cfg_1, n_feat, e_feat, device=dev),
        get_loss_function(cfg.loss_function), cfg_1, nz,
        [b.replace(ea_part=None).to(dev) for b in batches], cfg.lr)
    np.testing.assert_allclose(ea_loss, oracle_loss, rtol=tol[0],
                               atol=tol[1])
    l2p, l2o, cos = _assert_update_parity("ea", ea_fp, oracle_fp, tol)
    return dict(loss=ea_loss, oracle_loss=oracle_loss, update_l2=l2p,
                oracle_update_l2=l2o, cos=cos, dtype=dtype,
                caps=[cl, cr, cs])
