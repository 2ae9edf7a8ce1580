"""FE-mesh model and FEA results containers.

A copy of the dataclasses and property-id constants of
buckgnn_tpu/graph/mesh.py. The BDF reader/writer and OP2 interop come with
the host-pipeline slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MeshModel", "FEAResults"]

ACTIVE_STIFFENER_PID = 900  # PBAR 900 == active 2x80mm (Data_Generation_v3.py:246-262)
DUMMY_STIFFENER_PID = 999


@dataclasses.dataclass
class MeshModel:
    """FE mesh with boundary conditions. Node arrays are index-aligned to
    ``node_ids`` sorted ascending (the reference's sorted-node convention,
    GraphCreate.py:150-151)."""

    node_ids: np.ndarray                  # [n] int
    coords: np.ndarray                    # [n, 3] float
    quads: np.ndarray                     # [nq, 4] int node INDICES
    trias: np.ndarray                     # [nt, 3] int node indices
    cbars: np.ndarray                     # [nc, 2] int node indices
    cbar_pids: np.ndarray                 # [nc] int property ids
    quad_ids: np.ndarray | None = None    # [nq] element ids
    cbar_ids: np.ndarray | None = None    # [nc] element ids
    spc_components: dict | None = None    # node index -> component string
    forces: dict | None = None            # node index -> [3] scaled vector

    @property
    def n_node(self) -> int:
        return int(self.coords.shape[0])

    def __post_init__(self):
        if self.spc_components is None:
            self.spc_components = {}
        if self.forces is None:
            self.forces = {}
        if self.quad_ids is None and len(self.quads):
            self.quad_ids = np.arange(1, len(self.quads) + 1)
        if self.cbar_ids is None and len(self.cbars):
            self.cbar_ids = np.arange(
                100000, 100000 + len(self.cbars)
            )


@dataclasses.dataclass
class FEAResults:
    """Solver outputs consumed by graph construction
    (parse_nastran_results, GraphCreate.py:55-110)."""

    eigenvalue: float | None = None
    static_displacements: np.ndarray | None = None  # [n, >=2]
    mode_shape: np.ndarray | None = None            # [n, >=3]
    gp_stresses: np.ndarray | None = None           # [n, 3] (sx, sy, txy)
    gp_forces: dict | None = None                   # node idx -> {elem id: [>=2]}
    cbar_axial: dict | None = None                  # elem id -> float
