"""Command-line interface: ``python -m buckgnn_tpu_torch <command> ...``.

The reference has no CLI — each entry script is configured by editing
module-level globals (TRAIN_FINAL.py:24-84, INFERENCE.py:212-225's
commented-out argparse). This exposes every workflow with every toggle as
typed flags:

  datagen    organic shapes -> loadcases -> (bdf, fea.npz) pairs  (L1)
  train      train a model from a data folder or synthetic data   (L4/L5)
  tune       grid search with ASHA early stopping                 (L4)
  infer      checkpoint evaluation + report                       (L5)
  timer      GNN vs solver latency benchmark                      (L5)
  split      stratified split + materialization                   (L2)
  flatten    eigenvalue-distribution flattening                   (L2)
  bench      the port's benchmark (one JSON line)

Dataset folders hold ``*.bdf`` + ``*.fea.npz`` (or ``*.op2``) pairs; see
graph/folder.py.

The port of buckgnn_tpu/cli.py: the same subcommands, options, defaults,
choices and dests, and the same data and train configs from them. It
differs in four places: ``--device`` on train, tune, infer, timer and
scale (the CUDA card unless ``--device cpu``, which runs the plain
PyTorch path); ``bench`` runs the port's own benchmark
(buckgnn_tpu_torch/bench.py); ``scale`` spawns one process per device for
each count it measures (NCCL over the cards, gloo over CPU processes with
``--device cpu``); and ``timer`` adds the solver's timings
(``nastran``, null without a solver) to the GNN's in the line it prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from buckgnn_tpu_torch.config import DataConfig, TrainConfig

__all__ = ["main", "build_parser"]


def _add_data_flags(p: argparse.ArgumentParser) -> None:
    d = DataConfig()
    p.add_argument("--prediction-type", default=d.prediction_type,
                   choices=["buckling", "static", "static_stress",
                            "mode_shape"])
    for name in ("use_z_coord", "use_rotations", "use_gp_forces",
                 "use_axial_stress", "use_mode_shapes_as_features",
                 "use_super_node"):
        p.add_argument(f"--{name.replace('_', '-')}", action="store_true",
                       default=getattr(d, name))
    p.add_argument("--no-virtual-edges", dest="use_virtual_edges",
                   action="store_false", default=d.use_virtual_edges)
    p.add_argument("--virtual-edge-percentage", type=float,
                   default=d.virtual_edge_percentage)
    p.add_argument("--no-transform", dest="transform", action="store_false",
                   default=d.transform)


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")


def _data_cfg(args) -> DataConfig:
    names = {f.name for f in dataclasses.fields(DataConfig)}
    return DataConfig(**{k: v for k, v in vars(args).items() if k in names})


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    t = TrainConfig()
    p.add_argument("--lr", type=float, default=t.lr)
    p.add_argument("--hidden-channels", type=int, default=t.hidden_channels)
    p.add_argument("--num-layers", type=int, default=t.num_layers)
    p.add_argument("--weight-decay", type=float, default=t.weight_decay)
    p.add_argument("--num-epochs", type=int, default=t.num_epochs)
    p.add_argument("--loss-function", default=t.loss_function)
    p.add_argument("--pooling-layer", default=t.pooling_layer)
    p.add_argument("--dropout-rate", type=float, default=t.dropout_rate)
    p.add_argument("--model-name", default=t.model_name)
    p.add_argument("--batch-size", type=int, default=t.batch_size)
    p.add_argument("--scheduler", default=t.scheduler,
                   choices=["cosine", "restart", "none"])
    p.add_argument("--t-0", type=int, default=t.t_0)
    p.add_argument("--t-mult", type=int, default=t.t_mult)
    p.add_argument("--min-lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=t.seed)
    p.add_argument("--compute-dtype", default=t.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--segment-impl", default=t.segment_impl,
                   choices=["xla", "sorted", "banded", "banded_pallas",
                            "banded_partitioned"])
    p.add_argument("--no-materialize-band", dest="materialize_band",
                   action="store_false", default=t.materialize_band)
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=t.remat,
                   help="checkpoint conv layers (default: auto — on for "
                        "EA_GNN at hidden >= 256)")
    p.add_argument("--no-remat", dest="remat", action="store_false")


def _train_cfg(args, data_cfg: DataConfig) -> TrainConfig:
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    kw["use_lr_scheduler"] = args.scheduler != "none"
    if args.scheduler == "none":
        kw["scheduler"] = "cosine"
    kw["use_z_coord"] = data_cfg.use_z_coord
    kw["use_rotations"] = data_cfg.use_rotations
    kw["prediction_type"] = data_cfg.prediction_type
    return TrainConfig(**kw)


def _load_split(args, data_cfg: DataConfig):
    """(train, val, normalizer) from --data-dir (Train/Validation subdirs
    or one flat folder split 90/10) or --synthetic N."""
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset

    if args.synthetic:
        from buckgnn_tpu_torch.graph.synthetic import generate_dataset

        ds = generate_dataset(
            args.synthetic, seed=args.seed,
            use_super_node=data_cfg.use_super_node,
            use_virtual_edges=data_cfg.use_virtual_edges,
            prediction_type=data_cfg.prediction_type,
        )
        normed, nz = normalize_dataset(
            ds, prediction_type=data_cfg.prediction_type
        )
        k = max(1, int(0.9 * len(normed)))
        return normed[:k], normed[k:] or normed[-1:], nz

    from buckgnn_tpu_torch.graph.folder import load_folder_dataset

    train_dir = os.path.join(args.data_dir, "Train")
    val_dir = os.path.join(args.data_dir, "Validation")
    if os.path.isdir(train_dir) and os.path.isdir(val_dir):
        train, nz = load_folder_dataset(train_dir, data_cfg=data_cfg)
        val, _ = load_folder_dataset(val_dir, normalizer=nz,
                                     data_cfg=data_cfg)
        return train, val, nz
    full, nz = load_folder_dataset(args.data_dir, data_cfg=data_cfg)
    k = max(1, int(0.9 * len(full)))
    return full[:k], full[k:] or full[-1:], nz


# ------------------------------ commands ------------------------------ #

def cmd_datagen(args) -> int:
    from buckgnn_tpu_torch.datagen import (
        LoadcaseConfig, ShapeConfig, generate_model_cases,
        generate_shape_mesh,
    )
    from buckgnn_tpu_torch.graph.folder import save_fea_npz
    from buckgnn_tpu_torch.graph.mesh import write_bdf
    from buckgnn_tpu_torch.graph.synthetic import fake_fea

    os.makedirs(args.out_dir, exist_ok=True)
    shape_cfg = ShapeConfig(with_cutouts=args.cutouts)
    lc_cfg = LoadcaseConfig(
        loadcases_per_model=args.loadcases_per_model,
        generate_stiffeners=args.stiffeners,
        min_load=args.min_load, max_load=args.max_load,
    )
    count = 0
    for m in range(args.n_models):
        seed = args.seed + m
        mesh = generate_shape_mesh(seed=seed, cfg=shape_cfg)
        cases = generate_model_cases(
            mesh, lambda mm: fake_fea(mm, seed=seed), seed=seed, cfg=lc_cfg
        )
        for i, case in enumerate(cases):
            stem = os.path.join(args.out_dir, f"model_{m:04d}_{i:03d}")
            write_bdf(case, stem + ".bdf")
            save_fea_npz(fake_fea(case, seed=seed), stem + ".fea.npz")
            count += 1
    print(f"wrote {count} (bdf, fea.npz) pairs to {args.out_dir}")
    return 0


def cmd_train(args) -> int:
    from buckgnn_tpu_torch.train.trainer import train_gnn

    data_cfg = _data_cfg(args)
    cfg = _train_cfg(args, data_cfg)
    train, val, nz = _load_split(args, data_cfg)
    result = train_gnn(cfg, train, val, nz, args.output_dir,
                       resume_from=args.resume_from, device=args.device)
    print(json.dumps({"best_val_mape": result.best_val_mape,
                      "log_dir": result.log_dir}))
    return 0


def cmd_tune(args) -> int:
    from buckgnn_tpu_torch.train.tune import (
        GridSearch, hyperparameter_optimization,
    )

    data_cfg = _data_cfg(args)
    base = {
        k: GridSearch(v) if isinstance(v, list) else v
        for k, v in json.loads(args.grid).items()
    }
    cfg = _train_cfg(args, data_cfg)
    base_full = {**dataclasses.asdict(cfg), **base}
    train, val, nz = _load_split(args, data_cfg)
    best, results = hyperparameter_optimization(
        base_full, train, val, nz, args.output_dir,
        prediction_type=data_cfg.prediction_type,
        grace_period=args.grace_period,
        max_concurrent=args.max_concurrent, device=args.device,
    )
    print(json.dumps({"best_config": best, "n_trials": len(results)}))
    return 0


def cmd_infer(args) -> int:
    from buckgnn_tpu_torch.eval.inference import run_inference
    from buckgnn_tpu_torch.graph.folder import load_folder_dataset
    from buckgnn_tpu_torch.train.checkpoint import load_checkpoint_configs

    _, config, normalizer = load_checkpoint_configs(args.model_path)
    data_cfg = _data_cfg(args)
    data_cfg.prediction_type = config["prediction_type"]
    test, _ = load_folder_dataset(args.data_dir, normalizer=normalizer,
                                  data_cfg=data_cfg)
    results = run_inference(args.model_path, test, args.output_dir,
                            batch_size=args.batch_size,
                            report_path=args.report_path,
                            data_dir=args.data_dir, device=args.device)
    print(json.dumps({k: v for k, v in results.items()
                      if isinstance(v, (int, float, str))}))
    return 0


def cmd_timer(args) -> int:
    from buckgnn_tpu_torch.eval.timer import run_time_analysis
    from buckgnn_tpu_torch.graph.folder import load_folder_dataset
    from buckgnn_tpu_torch.train.checkpoint import load_checkpoint_configs

    _, config, normalizer = load_checkpoint_configs(args.model_path)
    data_cfg = _data_cfg(args)
    data_cfg.prediction_type = config["prediction_type"]
    data, _ = load_folder_dataset(args.data_dir, normalizer=normalizer,
                                  data_cfg=data_cfg)
    report = run_time_analysis(
        args.model_path, data[0], output_path=args.output_path,
        batch_size=args.batch_size,
        bdf_paths=[data[i].file_path for i in
                   range(min(args.n_solver_runs, len(data)))]
        if args.nastran_cmd else (),
        nastran_cmd=args.nastran_cmd or "nastran", device=args.device,
    )
    print(json.dumps({**report["gnn"], "nastran": report["nastran"]}))
    return 0


def cmd_split(args) -> int:
    from buckgnn_tpu_torch.graph.folder import load_folder_dataset
    from buckgnn_tpu_torch.graph.materialize import split_and_save

    data_cfg = _data_cfg(args)
    raw, _ = load_folder_dataset(args.data_dir, data_cfg=data_cfg,
                                 normalize=False)
    _, _, report = split_and_save(
        raw, args.out_dir, prediction_type=data_cfg.prediction_type,
        lengths=tuple(args.lengths), n_bins=args.n_bins, seed=args.seed,
    )
    print(json.dumps(report))
    return 0


def cmd_flatten(args) -> int:
    from buckgnn_tpu_torch.graph.flatten import (
        flatten_distribution, scan_eigenvalues,
    )
    from buckgnn_tpu_torch.graph.folder import load_folder_dataset
    from buckgnn_tpu_torch.graph.io import save_dataset

    data_cfg = _data_cfg(args)
    raw, _ = load_folder_dataset(args.data_dir, data_cfg=data_cfg,
                                 normalize=False)
    ev = scan_eigenvalues(raw)
    idx, info = flatten_distribution(
        ev, samples_per_bin=args.samples_per_bin,
        target_total=args.target_total, seed=args.seed,
    )
    flat = [raw[i] for i in idx]
    os.makedirs(args.out_dir, exist_ok=True)
    save_dataset(flat, os.path.join(args.out_dir, "dataset_flattened.npz"))
    print(json.dumps({"selected": len(idx), "total": len(raw), **{
        k: v for k, v in info.items() if isinstance(v, (int, float))
    }}))
    return 0


def cmd_scale(args) -> int:
    from buckgnn_tpu_torch.parallel.scaling import scaling_bench

    out = scaling_bench(n_devices=args.n_devices,
                        graphs_per_device=args.graphs_per_device,
                        n_steps=args.n_steps, device=args.device)
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    from buckgnn_tpu_torch import bench

    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="buckgnn_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("datagen", help="generate (bdf, fea.npz) datasets")
    g.add_argument("--out-dir", required=True)
    g.add_argument("--n-models", type=int, default=10)
    g.add_argument("--loadcases-per-model", type=int, default=4)
    g.add_argument("--stiffeners", action="store_true")
    g.add_argument("--cutouts", action="store_true")
    g.add_argument("--min-load", type=float, default=10.0)
    g.add_argument("--max-load", type=float, default=100.0)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_datagen)

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--data-dir")
    t.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic graphs instead of a folder")
    t.add_argument("--output-dir", default="runs")
    t.add_argument("--resume-from")
    _add_data_flags(t)
    _add_train_flags(t)
    _add_device_flag(t)
    t.set_defaults(fn=cmd_train)

    u = sub.add_parser("tune", help="grid search + ASHA")
    u.add_argument("--data-dir")
    u.add_argument("--synthetic", type=int, default=0)
    u.add_argument("--output-dir", default="runs")
    u.add_argument("--grid", required=True,
                   help='JSON dict; list values are grid axes, e.g. '
                        '{"lr": [1e-2, 1e-3], "hidden_channels": [128]}')
    u.add_argument("--grace-period", type=int, default=None,
                   help="ASHA rung base; default num_epochs // 10")
    u.add_argument("--max-concurrent", type=int, default=1,
                   help="trials run at once, round-robin across devices "
                        "(Ray trial-executor role)")
    _add_data_flags(u)
    _add_train_flags(u)
    _add_device_flag(u)
    u.set_defaults(fn=cmd_tune)

    i = sub.add_parser("infer", help="evaluate a checkpoint")
    i.add_argument("--model-path", required=True)
    i.add_argument("--data-dir", required=True)
    i.add_argument("--output-dir", default="runs/inference")
    i.add_argument("--batch-size", type=int, default=128)
    i.add_argument("--report-path")
    _add_data_flags(i)
    _add_device_flag(i)
    i.set_defaults(fn=cmd_infer)

    m = sub.add_parser("timer", help="latency benchmark")
    m.add_argument("--model-path", required=True)
    m.add_argument("--data-dir", required=True)
    m.add_argument("--output-path")
    m.add_argument("--batch-size", type=int, default=128)
    m.add_argument("--nastran-cmd", default="")
    m.add_argument("--n-solver-runs", type=int, default=4)
    _add_data_flags(m)
    _add_device_flag(m)
    m.set_defaults(fn=cmd_timer)

    s = sub.add_parser("split", help="stratified split + materialize")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--lengths", type=float, nargs="+", default=[0.9, 0.1])
    s.add_argument("--n-bins", type=int, default=1000)
    s.add_argument("--seed", type=int, default=0)
    _add_data_flags(s)
    s.set_defaults(fn=cmd_split)

    f = sub.add_parser("flatten", help="flatten eigenvalue distribution")
    f.add_argument("--data-dir", required=True)
    f.add_argument("--out-dir", required=True)
    f.add_argument("--samples-per-bin", type=int)
    f.add_argument("--target-total", type=int)
    f.add_argument("--seed", type=int, default=0)
    _add_data_flags(f)
    f.set_defaults(fn=cmd_flatten)

    b = sub.add_parser("bench", help="the port's benchmark (one JSON line)")
    b.set_defaults(fn=cmd_bench)

    sc = sub.add_parser("scale", help="DP scaling-efficiency harness")
    sc.add_argument("--n-devices", type=int, default=None)
    sc.add_argument("--graphs-per-device", type=int, default=8)
    sc.add_argument("--n-steps", type=int, default=10)
    _add_device_flag(sc)
    sc.set_defaults(fn=cmd_scale)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
