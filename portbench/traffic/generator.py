"""The one generator of every traffic mix: raw panels from a seed.

A panel is what a structural engineer hands the system: a quad shell mesh
of a stiffened-panel candidate with its clamped edge and edge load, and the
solver's fields that become node features (static displacements, Gauss
point stresses) and the target (the first buckling eigenvalue). Plain
arrays, no object of the program.

`make_mesh` and `make_fea` are frozen copies of the port's
``graph/synthetic.py::generate_mesh`` and ``fake_fea`` as of this
benchmark, changed in three ways only: the mesh's two side counts are
given, not drawn; the quads are built without a Python loop; and the
fields that no graph of a configuration here reads (the mode shape,
grid-point forces, CBAR axial stresses, stiffeners) are left out.

Every panel of a mix is one fixed draw (``panel_seed``): the run seed
only orders the panels within each batch (and, elsewhere, draws the
weights and dropout). Panels drawn anew for each seed would change the
work with the seed (their geometry moves the packed band and star
layout: the serve cell's rate differed by 2% between seeds against 0.5%
between two runs of one seed). The limits that decide ``correct`` were
set over other draws too (``portbench/calibrate.py --panel-seeds``).

A traffic file (``portbench/traffic/<name>.json``) holds the parameters:
``mode`` (the loop in ``portbench/modes/``), ``batches`` (packed batches
of the configuration's ``batch_size`` panels), ``min_side`` / ``max_side``,
``panel_seed`` (the fixed draw of every panel), and optionally ``graph``
("supernode" or "virtual"), which overrides the configuration's graph
construction.
"""

from __future__ import annotations

import numpy as np


def side_sizes(n: int, min_side: int, max_side: int,
               panel_seed_: int) -> np.ndarray:
    """[n, 2] side counts (nx, ny), the same for every run seed."""
    rng = np.random.default_rng(panel_seed_)
    return rng.integers(min_side, max_side + 1, size=(n, 2))


def panel_seed(seed: int, i: int) -> int:
    """Panel i's 31-bit seed under the run seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (2**63), i])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def make_mesh(s: int, nx: int, ny: int) -> dict:
    """Jittered quad-grid panel, clamped at one grid edge and loaded at the
    opposite one (frozen copy of generate_mesh, sides given)."""
    rng = np.random.default_rng(s)
    lx = float(rng.uniform(700.0, 1000.0))
    ly = float(rng.uniform(700.0, 1000.0))
    xs = np.linspace(0, lx, nx)
    ys = np.linspace(0, ly, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    interior = ((gx > 0) & (gx < lx) & (gy > 0) & (gy < ly)).reshape(-1)
    jitter = rng.uniform(-0.25, 0.25, size=coords.shape) * np.array(
        [lx / max(nx - 1, 1), ly / max(ny - 1, 1)])
    coords[interior] += jitter[interior]
    ang = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    coords = coords @ rot.T + rng.uniform(-500, 500, size=2)

    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    quads = np.stack([i * ny + j, (i + 1) * ny + j, (i + 1) * ny + j + 1,
                      i * ny + j + 1], axis=1).astype(np.int32)
    n = coords.shape[0]
    mag = float(rng.uniform(500.0, 5000.0))
    theta = rng.uniform(0, 2 * np.pi)
    fvec = mag * np.array([np.cos(theta), np.sin(theta), 0.0])
    return dict(coords=np.concatenate([coords, np.zeros((n, 1))], axis=1),
                quads=quads, spc_nodes=np.arange(ny),
                force_nodes=(nx - 1) * ny + np.arange(ny), force=fvec)


def make_fea(mesh: dict, s: int) -> dict:
    """Deterministic pseudo-FEA fields of a mesh (frozen copy of fake_fea:
    eigenvalue, static displacements, Gauss point stresses)."""
    rng = np.random.default_rng(s + 10_000)
    coords = mesh["coords"][:, :2]
    n = coords.shape[0]
    span = coords.max(axis=0) - coords.min(axis=0)
    diag = float(np.linalg.norm(span))
    force_nodes = np.sort(mesh["force_nodes"])
    total_force = np.sum([mesh["force"][:2] for _ in force_nodes], axis=0)
    fmag = float(np.linalg.norm(total_force)) + 1e-6
    fdir = total_force / fmag
    spc_centroid = coords[np.sort(mesh["spc_nodes"])].mean(axis=0)
    load_centroid = coords[force_nodes].mean(axis=0)
    lever = float(np.linalg.norm(load_centroid - spc_centroid)) + 1e-6
    e_mod, t = 76_000.0, 1.5
    per_node_force = fmag / max(len(force_nodes), 1)
    k = 2.0 + 1.5 * abs(float(np.cos(2 * np.arctan2(fdir[1], fdir[0]))))
    aspect = float(max(span) / (min(span) + 1e-6))
    eigenvalue = (10.0 * k * e_mod * t**3 / (diag * per_node_force)
                  * (1.0 + 0.15 * (aspect - 1.0))
                  * (diag / (2.0 * lever)) ** 0.3)
    eigenvalue *= float(rng.uniform(0.9, 1.1))
    eigenvalue = float(np.clip(eigenvalue, 0.05, 40.0))

    d_from_spc = np.linalg.norm(coords - spc_centroid, axis=1)
    amp = fmag / (e_mod * t * 10.0)
    profile = (d_from_spc / (d_from_spc.max() + 1e-6)) ** 1.5
    disp = np.zeros((n, 6))
    disp[:, 0] = amp * profile * fdir[0]
    disp[:, 1] = amp * profile * fdir[1]
    width = max(span.min(), 1.0)
    sigma0 = fmag / (width * t)
    d_from_load = np.linalg.norm(coords - load_centroid, axis=1)
    decay = np.exp(-2.0 * d_from_load / (diag + 1e-6))
    gp = np.zeros((n, 3))
    gp[:, 0] = sigma0 * decay * fdir[0] ** 2
    gp[:, 1] = sigma0 * decay * fdir[1] ** 2
    gp[:, 2] = 0.5 * sigma0 * decay * fdir[0] * fdir[1]
    return dict(eigenvalue=eigenvalue, disp=disp, gp=gp)


def make_panels(traffic: dict, batch_size: int, seed: int) -> list[list]:
    """``traffic["batches"]`` lists of ``batch_size`` panels, each a dict
    of `make_mesh`'s and `make_fea`'s arrays with its own ``seed``. Batch
    b holds panels b*batch_size.. of the mix's fixed draw, in the order
    that the run ``seed`` permutes."""
    n_batches = int(traffic["batches"])
    fixed = int(traffic["panel_seed"])
    sizes = side_sizes(n_batches * batch_size, traffic["min_side"],
                       traffic["max_side"], fixed)
    order_rng = np.random.default_rng(panel_seed(seed, 2**32))
    out = []
    for b in range(n_batches):
        batch = []
        for r in b * batch_size + order_rng.permutation(batch_size):
            s = panel_seed(fixed, int(r))
            mesh = make_mesh(s, int(sizes[r, 0]), int(sizes[r, 1]))
            batch.append(dict(mesh, **make_fea(mesh, s), seed=s))
        out.append(batch)
    return out
