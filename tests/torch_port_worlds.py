"""The bodies of the gloo worlds of the test_torch_port_{partitioned,
ea_shard,parallel} files: one function per world, run on every rank by
buckgnn_tpu_torch.parallel.scaling.run_world (spawned processes on
127.0.0.1, each world with a time limit). They import only torch and the
port; the JAX references come in through an .npz that the test process
wrote, and rank 0 returns what the test compares."""

import contextlib
import io
import json

import numpy as np
import torch

TILE, WIDTH = 128, 64
# every spawned world of the tests ends within this many seconds or fails
WORLD_TIMEOUT_S = 240


def packed(n_graphs, seed, supernode, n_shards=4, min_side=5, max_side=9,
           device="cpu"):
    """tests/test_partitioned.py's batch: panels with supernodes or with
    virtual edges, tile 128, width 64, node capacity split into
    ``n_shards`` tile-aligned ranges. Returns (graphs, batch)."""
    from buckgnn_tpu_torch.graph import batch as tb
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset

    ds = generate_dataset(n_graphs, seed=seed, min_side=min_side,
                          max_side=max_side, use_super_node=supernode,
                          use_virtual_edges=not supernode)
    n = sum(g.n_node for g in ds) + 1
    mult = n_shards * TILE
    ncap = ((max(n, TILE + WIDTH) + mult - 1) // mult) * mult
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    return ds, tb.pack_graphs(ds, ncap, ecap, n_graphs + 1, device=device,
                              band_width=WIDTH, band_tile=TILE)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _state(ref, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(prefix)}


def _grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _pred_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    pred, _ = model(batch, deterministic=True)
    (torch.where(batch.graph_mask, pred, 0.0) ** 2).sum().backward()
    return pred.detach().numpy(), _grads(model)


# ---- test_torch_port_partitioned.py ---------------------------------------

AGG_CASES = [(d, sup) for d in (2, 4) for sup in (False, True)]
MODEL_KW = dict(num_edge_features=5, hidden_channels=32, num_layers=3,
                dropout_rate=0.0)


def partitioned_world(rank, world, path):
    """partitioned_sage_aggregate at D = 2 (a 2 x 2 mesh) and D = 4 (1 x 4)
    on both batch kinds, forward and the gradient of <agg, probe> on real
    rows; BuckGNN(impl="banded_partitioned") at D = 4: pred and every
    gradient."""
    from buckgnn_tpu_torch.models.buckgnn import BuckGNN
    from buckgnn_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from buckgnn_tpu_torch.parallel.partitioned import (
        partition_batch, partitioned_sage_aggregate,
    )

    ref = _load(path)
    meshes = {2: make_mesh(2, 2), 4: make_mesh(1, 4)}
    out = {}
    for d, sup in AGG_CASES:
        _, batch = packed(8, 0 if d == 4 else 3, sup)
        pb = partition_batch(batch, d)
        x = torch.from_numpy(ref[f"x_{d}_{sup}"]).requires_grad_()
        probe = torch.from_numpy(ref[f"probe_{d}_{sup}"])
        mask = batch.node_mask.float()[:, None]
        with set_mesh(meshes[d]):
            agg = partitioned_sage_aggregate(x, pb)
            (agg * probe * mask).sum().backward()
        out[f"agg_{d}_{sup}"] = agg.detach().numpy()
        out[f"grad_{d}_{sup}"] = x.grad.numpy()
    for sup in (False, True):
        ds, batch = packed(8, 7, sup)
        model = BuckGNN(ds[0].x.shape[1], impl="banded_partitioned",
                        pooling_layer="supernode_with_pooling" if sup
                        else "mean", **MODEL_KW)
        model.load_state_dict(_state(ref, f"model_{sup}."))
        with set_mesh(meshes[4]):
            pred, grads = _pred_and_grads(
                model, batch.replace(part=partition_batch(batch, 4)))
        out[f"pred_{sup}"] = pred
        out.update({f"g_{sup}.{k}": v for k, v in grads.items()})
    return out if rank == 0 else None


# ---- test_torch_port_ea_shard.py -------------------------------------------

EA_H, EA_LAYERS = 128, 3


def ea_stack_inputs(ref):
    """The EA stack test's batch, block and encoder (weights from the
    test process) and x."""
    from buckgnn_tpu_torch.models.blocks import MLP, GraphNetBlock

    _, batch = packed(16, 2, False, min_side=8, max_side=11)
    blk = GraphNetBlock(EA_H)
    blk.load_state_dict(_state(ref, "block."))
    enc = MLP(5, (64, EA_H))
    enc.load_state_dict(_state(ref, "enc."))
    return batch, blk, enc, torch.from_numpy(ref["x"])


def ea_unsharded_stack(batch, blk, enc, x):
    """The single-device fused stack ('fold' mode) from the raw windows."""
    from buckgnn_tpu_torch.ops.ea_block import fused_ea_block, make_ea_context

    ctx = make_ea_context(batch)
    e = enc(batch.win_edges)
    for i in range(EA_LAYERS):
        x, e = fused_ea_block(x, e, blk, ctx, skip=0 < i < EA_LAYERS - 1)
    return x


def ea_shard_world(rank, world, path):
    """ea_tp_stack over the world's 'model' dim (a 1 x world mesh), and in
    each process the unsharded stack: forward and the gradients of
    sum(x_out ** 2) in the block's and the encoder's parameters."""
    from buckgnn_tpu_torch.parallel.ea_shard import ea_tp_stack, shard_ea_batch
    from buckgnn_tpu_torch.parallel.mesh import make_mesh, set_mesh

    ref = _load(path)
    batch, blk, enc, x = ea_stack_inputs(ref)
    shards = shard_ea_batch(batch, world)
    with set_mesh(make_mesh(1, world)):
        got = ea_tp_stack(x, shards, [blk] * EA_LAYERS, enc, rate=0.0,
                          seed=None, deterministic=True)
    (got ** 2).sum().backward()
    out = {"tp": got.detach().numpy(),
           **{f"tp.block.{k}": v for k, v in _grads(blk).items()},
           **{f"tp.enc.{k}": v for k, v in _grads(enc).items()}}
    blk.zero_grad(set_to_none=True)
    enc.zero_grad(set_to_none=True)
    want = ea_unsharded_stack(batch, blk, enc, x)
    (want ** 2).sum().backward()
    out.update({"one": want.detach().numpy(),
                **{f"one.block.{k}": v for k, v in _grads(blk).items()},
                **{f"one.enc.{k}": v for k, v in _grads(enc).items()}})
    return out if rank == 0 else None


# ---- test_torch_port_parallel.py -------------------------------------------

DP_KW = dict(hidden_channels=16, num_layers=2, batch_size=4,
             dropout_rate=0.0, lr=1e-3)


def dp_data():
    """tests/test_parallel.py's DP set: 32 panels of 3-5 nodes a side, the
    first two batches of 4."""
    from buckgnn_tpu_torch.graph.batch import (
        batch_iterator, suggest_capacities,
    )
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset

    normed, nz = normalize_dataset(generate_dataset(32, seed=0, min_side=3,
                                                    max_side=5))
    ncap, ecap = suggest_capacities(normed, 4)
    ecap = ((ecap + 255) // 256) * 256
    batches = list(batch_iterator(normed, 4, ncap, ecap, device="cpu"))[:2]
    return normed, nz, batches


def parallel_world(rank, world, path):
    """In one world of 4: edge_partitioned_aggregate over the 'model' dim of
    a 2 x 2 mesh (add, mean, max; the gradients of add and mean); the DP
    step on ranks 0 and 1 (a 2 x 1 mesh) from the test's weights (loss,
    metrics, updated parameters); the dry run at a 2 x 2 mesh;
    scaling_bench and ``cli scale`` on ranks 0 and 1."""
    from buckgnn_tpu_torch import cli
    from buckgnn_tpu_torch.config import TrainConfig
    from buckgnn_tpu_torch.parallel.dp import (
        local_batch, make_parallel_train_step,
    )
    from buckgnn_tpu_torch.parallel.dryrun import dryrun_multichip
    from buckgnn_tpu_torch.parallel.mesh import make_mesh
    from buckgnn_tpu_torch.parallel.scaling import scaling_bench
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import build_model, make_optimizer

    from buckgnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_aggregate, shard_edge_arrays,
    )

    ref = _load(path)
    out = {}
    # edge_partitioned_aggregate over the 'model' dim of a 2 x 2 mesh
    mesh22 = make_mesh(2, 2)
    x = torch.from_numpy(ref["ep_x"]).requires_grad_()
    s, r, _ = shard_edge_arrays(mesh22, torch.from_numpy(ref["ep_s"]),
                                torch.from_numpy(ref["ep_r"]),
                                torch.zeros((len(ref["ep_s"]), 1)))
    for aggr in ("add", "mean", "max"):
        agg = edge_partitioned_aggregate(x, s, r, mesh22, aggr)
        out[f"ep_{aggr}"] = agg.detach().numpy()
        if aggr != "max":
            x.grad = None
            (agg * torch.from_numpy(ref["ep_probe"])).sum().backward()
            out[f"ep_grad_{aggr}"] = x.grad.numpy().copy()
    mesh = make_mesh(2, 1, devices=[0, 1])
    if rank < 2:
        normed, nz, batches = dp_data()
        cfg = TrainConfig(**DP_KW)
        model = build_model(cfg, normed[0].x.shape[1],
                            normed[0].edge_attr.shape[1], device="cpu")
        model.load_state_dict(_state(ref, "model."))
        opt = make_optimizer(cfg, model)
        step = make_parallel_train_step(model, opt,
                                        get_loss_function(cfg.loss_function),
                                        cfg, nz, mesh)
        metrics = step(local_batch(batches, mesh), cfg.lr, None)
        out["dp_metrics"] = {k: float(v) for k, v in metrics.items()}
        out["dp_params"] = {k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()}
    out["dryrun"] = dryrun_multichip(device="cpu")
    out["scaling"] = scaling_bench(2, n_steps=2, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["scale", "--device", "cpu", "--n-devices", "2",
                       "--n-steps", "2"])
    out["cli_scale"] = (rc, json.loads(buf.getvalue().strip()
                                       .splitlines()[-1]))
    return out if rank == 0 else None
