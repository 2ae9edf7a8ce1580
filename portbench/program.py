"""The system under test: the only module of the benchmark that imports
the PyTorch port (``buckgnn_tpu_torch``).

It hands the port the benchmark's raw panels and weights and takes back
what the port produces: graphs, the packed batches, the model, its train
and eval steps, and the layout of a packed batch that the reference
checks (which row each node and which window slot each edge took).
`prepare` is the set-up every loop shares. Nothing here reads the JAX
package.

`pack_exact` is a copy of ``buckgnn_tpu_torch/bench.py::pack_exact``: one
batch holding the whole list with exact capacities, nodes aligned to four
band tiles in RCM order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def graph_kind(c) -> str:
    """The cell's graph construction: the traffic's, else the
    configuration's."""
    return c.traffic.get("graph", c.cfg["graph"])


def batch_shape(normed) -> dict:
    """The counts of portbench/metrics/counts.py of a batch's graphs."""
    return dict(nodes=sum(g.n_node for g in normed),
                edges=sum(g.n_edge for g in normed), graphs=len(normed),
                node_features=int(normed[0].x.shape[1]),
                edge_features=int(normed[0].edge_attr.shape[1]))


def prepare(run, panel_batches: list[list]) -> dict:
    """The set-up that every loop shares: the port's graphs of every panel,
    normalized together (one fitted normalizer, as a deployment has), one
    packed batch on the device a list of panels, the kernel libraries,
    and the model with the benchmark's weights from the run seed."""
    c, dev = run.c, run.device
    cfg = c.cfg
    t0 = time.perf_counter()
    graphs = build_graphs([p for b in panel_batches for p in b],
                          graph_kind(c), cfg["virtual_edge_percentage"])
    normed, nz = normalize(graphs)
    bs = cfg["batch_size"]
    parts = [normed[i * bs:(i + 1) * bs] for i in range(len(panel_batches))]
    batches = [pack(p, cfg, dev) for p in parts]
    sync(dev)
    setup_data_s = time.perf_counter() - t0
    check_path(cfg)
    build_s = build_kernels(cfg) if dev.type == "cuda" else 0.0
    t1 = time.perf_counter()
    model = build_model(cfg, normed, dev)
    shapes = [batch_shape(p) for p in parts]
    pspec = c.ref.spec(cfg, shapes[0]["node_features"],
                       shapes[0]["edge_features"])
    weights = run.weights_fn(pspec, run.seed, dev)
    load_weights(model, weights)
    return dict(model=model, normalizer=nz, batches=batches, shapes=shapes,
                weights=weights, setup_data_s=setup_data_s,
                kernel_build_s=build_s, t_model=t1)


def build_graphs(panels: list[dict], graph: str, virtual_percentage: float):
    """The port's graphs of the panels (graph/build.py::build_graph)."""
    from buckgnn_tpu_torch.graph.build import build_graph
    from buckgnn_tpu_torch.graph.mesh import FEAResults, MeshModel

    out = []
    for p in panels:
        n = p["coords"].shape[0]
        mesh = MeshModel(
            node_ids=np.arange(1, n + 1), coords=p["coords"], quads=p["quads"],
            trias=np.zeros((0, 3), np.int32), cbars=np.zeros((0, 2), np.int32),
            cbar_pids=np.zeros((0,), np.int32),
            spc_components={int(i): "123456" for i in p["spc_nodes"]},
            forces={int(i): p["force"].copy() for i in p["force_nodes"]})
        fea = FEAResults(eigenvalue=p["eigenvalue"],
                         static_displacements=p["disp"], gp_stresses=p["gp"])
        out.append(build_graph(
            mesh, fea, use_super_node=graph == "supernode",
            use_virtual_edges=graph == "virtual",
            virtual_edge_percentage=virtual_percentage, seed=p["seed"]))
    return out


def normalize(graphs):
    """(normalized graphs, normalizer) of graph/normalizer.py."""
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset

    return normalize_dataset(graphs)


def pack_exact(normed, band_width: int | None, band_tile: int, device):
    """One batch holding every graph of ``normed``, with exact capacities
    (copy of buckgnn_tpu_torch/bench.py::pack_exact)."""
    from buckgnn_tpu_torch.graph.batch import batch_iterator

    n_real = sum(g.n_node for g in normed) + 1  # + dead node
    e_real = sum(g.n_edge for g in normed)
    ecap = ((e_real + 255) // 128) * 128
    ncap = n_real
    if band_width is not None:
        align = 4 * band_tile
        ncap = ((max(n_real, band_tile + band_width) + align - 1)
                // align) * align
    return next(iter(batch_iterator(normed, len(normed), ncap, ecap,
                                    band_width=band_width,
                                    band_tile=band_tile,
                                    rcm=band_width is not None,
                                    device=device)))


def pack(normed, cfg: dict, device):
    """The configuration's packed batch: its band tile and width, or the
    width that graph/batch.py::select_band_geometry picks."""
    from buckgnn_tpu_torch.graph.batch import select_band_geometry

    tile, width = cfg["band_tile"], cfg["band_width"]
    if width is None:
        tile, width = select_band_geometry(normed, tile=tile)
    return pack_exact(normed, width, tile, device)


def train_config(cfg: dict):
    from buckgnn_tpu_torch.config import TrainConfig

    opt = cfg["optimizer"]
    return TrainConfig(
        hidden_channels=cfg["hidden_channels"], num_layers=cfg["num_layers"],
        compute_dtype=cfg["compute_dtype"], lr=opt["lr"],
        weight_decay=opt["weight_decay"], batch_size=cfg["batch_size"],
        model_name=cfg["model_name"], segment_impl=cfg["segment_impl"],
        dropout_rate=cfg["dropout_rate"], loss_function=cfg["loss_function"],
        pooling_layer=cfg["pooling_layer"],
        prediction_type=cfg["prediction_type"], remat=None)


def check_path(cfg: dict) -> None:
    """Refuse a configuration whose kernels would not be the ones it
    names (ops/banded_matmul.py::kernel_variant's rule on dtype and H)."""
    from buckgnn_tpu_torch.ops.banded_matmul import kernel_variant

    got = kernel_variant(_DTYPES[cfg["compute_dtype"]],
                         cfg["hidden_channels"])
    if got != cfg["kernel_variant"]:
        raise RuntimeError(f"the port would take the {got!r} kernels, the "
                           f"configuration names {cfg['kernel_variant']!r}")


def build_kernels(cfg: dict) -> float:
    """Build (on a cold cache) or find the configuration's kernel
    libraries in the port's fixed build directory; seconds taken."""
    from buckgnn_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(cfg["kernel_libraries"])
    for name in cfg["kernel_libraries"]:
        cuda_build.load(name)
    return time.perf_counter() - t0


def build_model(cfg: dict, normed, device):
    from buckgnn_tpu_torch.train.trainer import build_model as build

    return build(train_config(cfg), normed[0].x.shape[1],
                 normed[0].edge_attr.shape[1], device=device)


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    """Every parameter of the model from ``weights`` (name -> tensor): the
    two sets of names and shapes must agree."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError("the port's parameters are not the reference's: "
                           f"{sorted(set(params) ^ set(weights))}")
    for k, p in params.items():
        p.copy_(weights[k])


def make_steps(model, cfg: dict, normalizer):
    """(train_step, eval_step, optimizer) of train/trainer.py."""
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import (
        make_optimizer, make_train_step,
    )

    tc = train_config(cfg)
    optimizer = make_optimizer(tc, model)
    train_step, eval_step = make_train_step(
        model, optimizer, get_loss_function(tc.loss_function), tc, normalizer)
    return train_step, eval_step, optimizer


def make_eval(model, cfg: dict, normalizer):
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import make_eval_step

    tc = train_config(cfg)
    return make_eval_step(model, get_loss_function(tc.loss_function), tc,
                          normalizer)


def layout(batch, edge_slots: bool) -> dict:
    """Host copies of what the reference checks of the packed batch: its
    nodes, graph of each row, edge list and masks, and where the
    reference keys dropout by window slot (``edge_slots``) each window
    slot's sender and receiver row (-1 for a pad) with its raw edge
    features, and the slot count (ops/ea_block.py's EAContext)."""
    out = {k: getattr(batch, k).detach().cpu().numpy() for k in (
        "nodes", "node_graph", "node_mask", "senders", "receivers",
        "edge_mask", "graph_mask", "y")}
    if edge_slots:
        from buckgnn_tpu_torch.ops.ea_block import make_ea_context

        ctx = make_ea_context(batch)
        out["slot_send"] = ctx.send.cpu().numpy()
        out["slot_recv"] = ctx.recv.cpu().numpy()
        out["slot_edges"] = batch.win_edges.reshape(
            ctx.n_slots, -1).cpu().numpy()
        out["n_slots"] = ctx.n_slots
    return out
