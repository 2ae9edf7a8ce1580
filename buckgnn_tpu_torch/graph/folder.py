"""Folder -> dataset: the L2 public interface.

Re-implements ``load_folder_dataset`` / ``load_single_data``
(Dataset_Preparation/GraphCreate.py:461-554, 556-640, 792-836): scan a
directory for BDF decks with matching result files, build graphs in a
process pool, quarantine corrupt pairs with a JSON problem log
(GraphCreate.py:434-459, 498-512), cache the built dataset on disk, and
fit-or-apply the DatasetNormalizer.

Result files per ``model.bdf``:
  - ``model.op2``       Nastran binary (needs pyNastran at runtime), or
  - ``model.fea.npz``   this framework's portable FEAResults dump — what
                        the synthetic oracle writes, so every pipeline
                        stage runs hermetically (SURVEY §4.5).

A copy of buckgnn_tpu/graph/folder.py, kept here so the port needs no JAX:
the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import shutil
import time

import numpy as np

from buckgnn_tpu_torch.config import DataConfig
from buckgnn_tpu_torch.graph.batch import GraphData
from buckgnn_tpu_torch.graph.build import build_graph
from buckgnn_tpu_torch.graph.io import (
    dataset_cache_path,
    load_dataset_file,
    save_dataset,
)
from buckgnn_tpu_torch.graph.mesh import (
    FEAResults,
    MeshModel,
    read_bdf,
    read_op2_results,
)
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer, normalize_dataset

__all__ = ["save_fea_npz", "load_fea_npz", "load_single_data",
           "load_folder_dataset"]


def save_fea_npz(results: FEAResults, path: str) -> None:
    """Portable FEAResults serialization (the hermetic stand-in for OP2)."""
    payload: dict = {}
    if results.eigenvalue is not None:
        payload["eigenvalue"] = np.float64(results.eigenvalue)
    for name in ("static_displacements", "mode_shape", "gp_stresses"):
        v = getattr(results, name)
        if v is not None:
            payload[name] = np.asarray(v)
    if results.cbar_axial:
        items = sorted(results.cbar_axial.items())
        payload["cbar_axial_ids"] = np.asarray([k for k, _ in items])
        payload["cbar_axial_vals"] = np.asarray([v for _, v in items])
    if results.gp_forces:
        rows = []
        for nid, per_elem in sorted(results.gp_forces.items()):
            for eid, vec in sorted(per_elem.items()):
                v = np.asarray(vec, dtype=np.float64)[:2]
                rows.append([nid, eid, v[0], v[1]])
        payload["gp_force_rows"] = np.asarray(rows)
    np.savez_compressed(path, **payload)


def load_fea_npz(path: str) -> FEAResults:
    with np.load(path) as z:
        cbar_axial = None
        if "cbar_axial_ids" in z:
            cbar_axial = {
                int(k): float(v)
                for k, v in zip(z["cbar_axial_ids"], z["cbar_axial_vals"])
            }
        gp_forces = None
        if "gp_force_rows" in z:
            gp_forces = {}
            for nid, eid, fx, fy in z["gp_force_rows"]:
                gp_forces.setdefault(int(nid), {})[int(eid)] = np.array(
                    [fx, fy]
                )
        return FEAResults(
            eigenvalue=(float(z["eigenvalue"]) if "eigenvalue" in z else None),
            static_displacements=(z["static_displacements"]
                                  if "static_displacements" in z else None),
            mode_shape=z["mode_shape"] if "mode_shape" in z else None,
            gp_stresses=z["gp_stresses"] if "gp_stresses" in z else None,
            gp_forces=gp_forces,
            cbar_axial=cbar_axial,
        )


def _result_path(bdf_path: str) -> str | None:
    stem = os.path.splitext(bdf_path)[0]
    for ext in (".fea.npz", ".op2"):
        if os.path.exists(stem + ext):
            return stem + ext
    return None


def _quarantine(bdf_path: str, result_path: str | None, reason: str) -> None:
    """Move a corrupt pair aside and log it
    (GraphCreate.py:434-459, 498-512)."""
    folder = os.path.join(os.path.dirname(bdf_path), "problematic_files")
    os.makedirs(folder, exist_ok=True)
    for p in (bdf_path, result_path):
        if p and os.path.exists(p):
            shutil.move(p, os.path.join(folder, os.path.basename(p)))
    log_path = os.path.join(folder, "problems.json")
    entries = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            entries = json.load(f)
    entries.append({"file": os.path.basename(bdf_path), "reason": reason,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")})
    with open(log_path, "w") as f:
        json.dump(entries, f, indent=2)


def load_single_data(args) -> GraphData | None:
    """(bdf_path, DataConfig, quarantine) -> GraphData | None
    (load_single_data, GraphCreate.py:461-554). Top-level so mp.Pool can
    pickle it."""
    bdf_path, cfg, quarantine = args
    result_path = _result_path(bdf_path)
    if result_path is None:
        return None  # missing results -> skip (GraphCreate.py:485-487)
    try:
        mesh = read_bdf(bdf_path)
        results = (load_fea_npz(result_path)
                   if result_path.endswith(".fea.npz")
                   else read_op2_results(result_path))
        n_res = None
        for arr in (results.static_displacements, results.gp_stresses):
            if arr is not None:
                n_res = len(arr)
                break
        if n_res is not None and n_res != mesh.n_node:
            raise ValueError(
                f"node count mismatch: BDF {mesh.n_node} vs results {n_res}"
            )
        g = build_graph(
            mesh, results,
            use_z_coord=cfg.use_z_coord,
            use_rotations=cfg.use_rotations,
            use_gp_forces=cfg.use_gp_forces,
            use_axial_stress=cfg.use_axial_stress,
            use_mode_shapes_as_features=cfg.use_mode_shapes_as_features,
            use_super_node=cfg.use_super_node,
            use_virtual_edges=cfg.use_virtual_edges,
            virtual_edge_percentage=cfg.virtual_edge_percentage,
            transform=cfg.transform,
            prediction_type=cfg.prediction_type,
            # stable across processes/hosts (Python's hash() is salted per
            # process — would make virtual edges irreproducible)
            seed=int.from_bytes(
                hashlib.sha256(
                    os.path.basename(bdf_path).encode()
                ).digest()[:4], "little",
            ),
        )
        g.file_path = bdf_path
        return g
    except Exception as e:  # noqa: BLE001 — skip-and-continue parity
        if quarantine:
            _quarantine(bdf_path, result_path, repr(e))
        return None


def load_folder_dataset(
    data_dir: str,
    normalizer: DatasetNormalizer | None = None,
    data_cfg: DataConfig | None = None,
    processes: int | None = None,
    use_cache: bool = True,
    quarantine: bool = True,
    normalize: bool = True,
) -> tuple[list[GraphData], DatasetNormalizer | None]:
    """Directory of (bdf, results) pairs -> normalized GraphData list +
    normalizer (load_folder_dataset, GraphCreate.py:792-836).

    Fits the normalizer when ``normalizer`` is None (train folder), applies
    the given one otherwise (val/test folders, INFERENCE.py:91-102).
    """
    cfg = data_cfg or DataConfig()
    cache = dataset_cache_path(data_dir, cfg.prediction_type)
    raw: list[GraphData] | None = None
    if use_cache and os.path.exists(cache):
        raw = load_dataset_file(cache)
    if raw is None:
        bdfs = sorted(
            os.path.join(data_dir, f) for f in os.listdir(data_dir)
            if f.endswith(".bdf")
        )
        work = [(b, cfg, quarantine) for b in bdfs]
        n_proc = processes or max(mp.cpu_count() - 2, 1)
        if n_proc > 1 and len(work) > 8:
            # fork, whatever the platform's default: the workers run
            # read_bdf and build_graph (NumPy and the standard library) and
            # return NumPy graphs, never touching torch.cuda, so a CUDA
            # context live in the parent is safe to fork past, as for
            # PyTorch's DataLoader workers; spawn or forkserver would
            # import torch afresh in every worker. The graphs come back in
            # the order of `work` either way.
            with mp.get_context("fork").Pool(n_proc) as pool:
                raw = [g for g in pool.imap(load_single_data, work,
                                            chunksize=8) if g is not None]
        else:
            raw = [g for g in map(load_single_data, work) if g is not None]
        if not raw:
            raise ValueError(f"no loadable (bdf, results) pairs in {data_dir}")
        if use_cache:
            save_dataset(raw, cache)
    if not normalize:
        return raw, normalizer
    normed, normalizer = normalize_dataset(
        raw, normalizer,
        use_z_coord=cfg.use_z_coord,
        use_rotations=cfg.use_rotations,
        use_gp_forces=cfg.use_gp_forces,
        use_axial_stress=cfg.use_axial_stress,
        use_mode_shapes_as_features=cfg.use_mode_shapes_as_features,
        prediction_type=cfg.prediction_type,
    )
    return normed, normalizer
