"""Dataset normalization — fit-on-train scaler set, .npz-serializable.

Re-implements Dataset_Preparation/Normalizer.py (DatasetNormalizer) and the
feature-slice walk of GraphCreate.dataset_normalizer (GraphCreate.py:675-789)
in plain NumPy. A copy of buckgnn_tpu/graph/normalizer.py without its .npz
serialization (checkpoint loading comes with a later slice of the port).

Scaler math matches sklearn exactly (validated against sklearn in tests):
- RobustScaler: center = median, scale = IQR(25, 75), zero-scales -> 1
  (eigenvalue :8, displacement :9, gp stress :19).
- StandardScaler: mean / population std, zero-scales -> 1
  (force :11, rotations :10, mode shapes :12-13, gp forces :18).
- Range scalers: coords and forces x / ((max-min)/2) (:287-293), axial
  stress 2*x/absmax (:315-317).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from buckgnn_tpu_torch.graph.batch import GraphData


def _handle_zeros(scale: np.ndarray) -> np.ndarray:
    scale = np.atleast_1d(np.asarray(scale, dtype=np.float64)).copy()
    scale[scale == 0.0] = 1.0
    return scale


@dataclasses.dataclass
class RobustScaler:
    """sklearn.preprocessing.RobustScaler (centering+scaling, 25/75)."""

    center_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "RobustScaler":
        x = np.asarray(x, dtype=np.float64)
        self.center_ = np.nanmedian(x, axis=0)
        q = np.nanpercentile(x, [25.0, 75.0], axis=0)
        self.scale_ = _handle_zeros(q[1] - q[0])
        return self

    def transform(self, x):
        return (np.asarray(x) - self.center_) / self.scale_

    def inverse_transform(self, x):
        return np.asarray(x) * self.scale_ + self.center_


@dataclasses.dataclass
class StandardScaler:
    mean_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        self.mean_ = np.nanmean(x, axis=0)
        self.scale_ = _handle_zeros(np.nanstd(x, axis=0))
        return self

    def transform(self, x):
        return (np.asarray(x) - self.mean_) / self.scale_

    def inverse_transform(self, x):
        return np.asarray(x) * self.scale_ + self.mean_


class DatasetNormalizer:
    """Scaler set fit on the training split (Normalizer.py:5-202)."""

    def __init__(self):
        self.eigenvalue_scaler = RobustScaler()
        self.displacement_scaler = RobustScaler()
        self.gp_stress_scaler = RobustScaler()
        self.rotation_scaler = StandardScaler()
        self.force_scaler = StandardScaler()  # fit only; forces use range scaling
        self.mode_shape_disp_scaler = StandardScaler()
        self.mode_shape_rot_scaler = StandardScaler()
        self.gp_force_scaler = StandardScaler()
        self.coord_min = None
        self.coord_max = None
        self.force_min = None
        self.force_max = None
        self.eigenvalue_min = None
        self.eigenvalue_max = None
        self.axial_stress_absmax = None

    # ------------------------------------------------------------------ #

    def fit(
        self,
        dataset: Sequence[GraphData],
        use_z_coord: bool = False,
        use_rotations: bool = False,
        use_gp_forces: bool = False,
        use_axial_stress: bool = False,
        use_mode_shapes_as_features: bool = False,
        prediction_type: str = "buckling",
    ) -> "DatasetNormalizer":
        """Collect per-feature-block statistics (Normalizer.py:43-202).

        The feature-index walk mirrors the reference's layout contract
        (SURVEY §2.3): coords | SPC | forces | [boundary + 4 stiffener bins]
        | disp | (rot) | gp stress | (gp forces) | (mode shapes).
        """
        eigenvalues, displacements, forces, rotations = [], [], [], []
        ms_disp, ms_rot, coords, gp_forces, gp_stresses, axial = [], [], [], [], [], []

        coord_dim = 3 if use_z_coord else 2
        force_dim = 3 if use_z_coord else 2
        for data in dataset:
            if prediction_type == "buckling":
                if data.eigenvalue is not None:
                    eigenvalues.append(float(data.eigenvalue))
                elif data.y.size == 1:
                    eigenvalues.append(float(np.reshape(data.y, (-1,))[0]))
            elif prediction_type == "mode_shape" and data.eigenvalue is not None:
                # mode-shape graphs carry their eigenvalue on the side
                # (GraphCreate.py:548-549) and normalize_dataset rescales it
                # — the reference collects eigenvalues only for buckling
                # (Normalizer.py:57-61) yet transforms them for mode_shape
                # (GraphCreate.py:768), an unfit-scaler crash. Deliberate fix.
                eigenvalues.append(float(data.eigenvalue))
            x = data.x
            fi = 0
            if use_axial_stress and data.edge_attr.shape[1] == 6:
                axial.append(data.edge_attr[:, 4])
            coords.append(x[:, :coord_dim])
            fi += coord_dim
            fi += 1  # SPC
            forces.append(x[:, fi : fi + force_dim])
            fi += force_dim
            fi += 5  # boundary + stiffener bins

            if "static" in prediction_type:
                static = data.y
                disp_dim = static.shape[1] - 3
                displacements.append(static[:, : 2 if not use_rotations else 2]
                                     if not use_z_coord else static[:, :3])
                if use_rotations:
                    rotations.append(
                        static[:, 3:6] if use_z_coord else static[:, 2:4]
                    )
                gp_stresses.append(static[:, -3:])
                del disp_dim
            else:
                disp_dim = 3 if use_z_coord else 2
                displacements.append(x[:, fi : fi + disp_dim])
                fi += disp_dim
                if use_rotations:
                    rotations.append(x[:, fi : fi + 3])
                    fi += 3
                gp_stresses.append(x[:, fi : fi + 3])
                fi += 3

            if use_gp_forces and "static" not in prediction_type:
                gp_forces.append(x[:, fi : fi + 8])
                fi += 8

            if use_mode_shapes_as_features and prediction_type != "mode_shape":
                ms_disp.append(x[:, fi : fi + 3])
                fi += 3
                if use_rotations:
                    ms_rot.append(x[:, fi : fi + 3])
                    fi += 3
            elif prediction_type == "mode_shape":
                # mode-shape targets live in y (GraphCreate.py:529-542; the
                # reference's fit misses this case — Normalizer.py:119 only
                # checks data.mode_shapes, which GraphCreate.py:551 sets for
                # buckling runs only, leaving the scaler unfit for the very
                # prediction type that normalizes y with it. Deliberate fix.)
                ms_disp.append(np.asarray(data.y)[:, :3])
                if use_rotations:
                    ms_rot.append(np.asarray(data.y)[:, 3:])
            elif data.mode_shapes is not None:
                ms_disp.append(data.mode_shapes[:, :3])
                if use_rotations:
                    ms_rot.append(data.mode_shapes[:, 3:])

        if eigenvalues:
            ev = np.array(eigenvalues).reshape(-1, 1)
            self.eigenvalue_scaler.fit(ev)
            self.eigenvalue_min = np.min(ev, axis=0)
            self.eigenvalue_max = np.max(ev, axis=0)
        if displacements:
            d = np.concatenate(displacements)
            self.displacement_scaler.fit(d)
        if rotations:
            self.rotation_scaler.fit(np.concatenate(rotations))
        if forces:
            f = np.concatenate(forces)
            self.force_scaler.fit(f)
            self.force_min = np.min(f, axis=0)
            self.force_max = np.max(f, axis=0)
        if ms_disp:
            self.mode_shape_disp_scaler.fit(np.concatenate(ms_disp))
        if ms_rot:
            self.mode_shape_rot_scaler.fit(np.concatenate(ms_rot))
        c = np.concatenate(coords)
        self.coord_min = np.min(c, axis=0)
        self.coord_max = np.max(c, axis=0)
        if gp_forces:
            self.gp_force_scaler.fit(np.concatenate(gp_forces))
        if gp_stresses:
            self.gp_stress_scaler.fit(np.concatenate(gp_stresses))
        if axial:
            a = np.concatenate(axial).reshape(-1, 1)
            self.axial_stress_absmax = np.maximum(
                np.abs(np.max(a, axis=0)), np.abs(np.min(a, axis=0))
            )
        return self

    # ----------------------- normalize/denormalize --------------------- #

    def normalize_eigenvalue(self, ev):
        return self.eigenvalue_scaler.transform(np.reshape(ev, (-1, 1)))[..., 0]

    def denormalize_eigenvalue(self, ev):
        return np.asarray(ev) * self.eigenvalue_scaler.scale_[0] + (
            self.eigenvalue_scaler.center_[0]
        )

    def normalize_coordinates(self, coords):
        denominator = np.maximum(self.coord_max - self.coord_min, 1e-8) / 2
        return coords / denominator  # (Normalizer.py:287-289)

    def normalize_force(self, force):
        denominator = np.maximum(self.force_max - self.force_min, 1e-8) / 2
        return force / denominator  # (Normalizer.py:291-293)

    def normalize_displacement(self, d):
        return self.displacement_scaler.transform(d)

    def denormalize_displacement(self, d):
        return self.displacement_scaler.inverse_transform(d)

    def normalize_gp_stresses(self, s):
        return self.gp_stress_scaler.transform(s)

    def denormalize_gp_stresses(self, s):
        return self.gp_stress_scaler.inverse_transform(s)

    def normalize_rotation(self, r):
        return self.rotation_scaler.transform(r)

    def normalize_mode_shape_disp(self, m):
        return self.mode_shape_disp_scaler.transform(m)

    def normalize_mode_shape_rot(self, m):
        return self.mode_shape_rot_scaler.transform(m)

    def normalize_gp_forces(self, g):
        return self.gp_force_scaler.transform(g)

    def normalize_axial_stress(self, a):
        return (a / self.axial_stress_absmax[0]) * 2  # (Normalizer.py:315-317)

    # --------------------------- device side --------------------------- #

    def device_stats(self) -> dict:
        """Scale/center arrays for on-device denormalization (the role of the
        torch-side denormalize_* methods, Normalizer.py:207-215,298-312)."""
        out = {}
        if self.eigenvalue_scaler.center_ is not None:
            out["eigenvalue_scale"] = np.float32(self.eigenvalue_scaler.scale_[0])
            out["eigenvalue_center"] = np.float32(self.eigenvalue_scaler.center_[0])
        if self.displacement_scaler.center_ is not None:
            out["displacement_scale"] = self.displacement_scaler.scale_.astype(
                np.float32
            )
            out["displacement_center"] = self.displacement_scaler.center_.astype(
                np.float32
            )
        if self.gp_stress_scaler.center_ is not None:
            out["gp_stress_scale"] = self.gp_stress_scaler.scale_.astype(np.float32)
            out["gp_stress_center"] = self.gp_stress_scaler.center_.astype(np.float32)
        return out


def normalize_dataset(
    dataset: Sequence[GraphData],
    normalizer: DatasetNormalizer | None = None,
    use_z_coord: bool = False,
    use_rotations: bool = False,
    use_gp_forces: bool = False,
    use_axial_stress: bool = False,
    use_mode_shapes_as_features: bool = False,
    prediction_type: str = "buckling",
) -> tuple[list[GraphData], DatasetNormalizer]:
    """Feature-slice normalization walk (GraphCreate.py:675-789).

    Fits a normalizer when none is given; returns new GraphData objects.
    Super-node rows are forced to zero except the indicator
    (GraphCreate.py:742-744).
    """
    if normalizer is None:
        normalizer = DatasetNormalizer().fit(
            dataset, use_z_coord, use_rotations, use_gp_forces,
            use_axial_stress, use_mode_shapes_as_features, prediction_type,
        )

    coord_dim = 3 if use_z_coord else 2
    force_dim = 3 if use_z_coord else 2
    out = []
    for data in dataset:
        x = data.x.astype(np.float64)
        nx = np.zeros_like(x)
        is_super = x[:, -1] == 1

        fi = 0
        nx[:, :coord_dim] = normalizer.normalize_coordinates(x[:, :coord_dim])
        fi += coord_dim
        nx[:, fi : fi + 1] = x[:, fi : fi + 1]  # SPC untouched
        fi += 1
        nx[:, fi : fi + force_dim] = normalizer.normalize_force(
            x[:, fi : fi + force_dim]
        )
        fi += force_dim
        nx[:, fi : fi + 5] = x[:, fi : fi + 5]  # boundary + stiffener bins
        fi += 5

        if "static" not in prediction_type:
            disp_dim = 3 if use_z_coord else 2
            nx[:, fi : fi + disp_dim] = normalizer.normalize_displacement(
                x[:, fi : fi + disp_dim]
            )
            fi += disp_dim
            if use_rotations:
                nx[:, fi : fi + 3] = normalizer.normalize_rotation(
                    x[:, fi : fi + 3]
                )
                fi += 3
            nx[:, fi : fi + 3] = normalizer.normalize_gp_stresses(
                x[:, fi : fi + 3]
            )
            fi += 3
        if use_gp_forces and "static" not in prediction_type:
            nx[:, fi : fi + 8] = normalizer.normalize_gp_forces(x[:, fi : fi + 8])
            fi += 8
        if use_mode_shapes_as_features and "static" not in prediction_type:
            nx[:, fi : fi + 3] = normalizer.normalize_mode_shape_disp(
                x[:, fi : fi + 3]
            )
            fi += 3
            if use_rotations:
                nx[:, fi : fi + 3] = normalizer.normalize_mode_shape_rot(
                    x[:, fi : fi + 3]
                )
                fi += 3
        # copy any remaining (e.g. supernode indicator) columns verbatim
        if fi < x.shape[1]:
            nx[:, fi:] = x[:, fi:]

        nx[is_super] = 0.0
        nx[is_super, -1] = 1.0

        # Targets (GraphCreate.py:747-769)
        if prediction_type == "buckling":
            y = np.asarray(
                normalizer.normalize_eigenvalue(float(np.reshape(data.y, (-1,))[0])),
                dtype=np.float32,
            ).reshape(1)
        elif "static" in prediction_type:
            disp_dim = data.y.shape[1] - 3
            nd = normalizer.normalize_displacement(data.y[:, :disp_dim])
            ns = normalizer.normalize_gp_stresses(data.y[:, disp_dim:])
            y = np.concatenate([nd, ns], axis=1).astype(np.float32)
        elif prediction_type == "mode_shape":
            if use_rotations:
                y = np.concatenate(
                    [
                        normalizer.normalize_mode_shape_disp(data.y[:, :3]),
                        normalizer.normalize_mode_shape_rot(data.y[:, 3:]),
                    ],
                    axis=1,
                ).astype(np.float32)
            else:
                y = normalizer.normalize_mode_shape_disp(data.y).astype(np.float32)
        else:
            y = data.y

        edge_attr = data.edge_attr
        if use_axial_stress and "static" not in prediction_type:
            edge_attr = edge_attr.copy()
            edge_attr[:, 4] = normalizer.normalize_axial_stress(edge_attr[:, 4])

        mode_shapes = data.mode_shapes
        if prediction_type == "buckling" and mode_shapes is not None:
            nm = np.zeros_like(mode_shapes)
            nm[:, :3] = normalizer.normalize_mode_shape_disp(mode_shapes[:, :3])
            if use_rotations:
                nm[:, 3:] = normalizer.normalize_mode_shape_rot(mode_shapes[:, 3:])
            mode_shapes = nm.astype(np.float32)

        out.append(
            GraphData(
                x=nx.astype(np.float32),
                senders=data.senders,
                receivers=data.receivers,
                edge_attr=edge_attr.astype(np.float32),
                y=y,
                supernode=data.supernode,
                eigenvalue=(
                    float(normalizer.normalize_eigenvalue(data.eigenvalue))
                    if data.eigenvalue is not None
                    and prediction_type == "mode_shape"
                    else data.eigenvalue
                ),
                mode_shapes=mode_shapes,
                file_path=data.file_path,
            )
        )
    return out, normalizer
