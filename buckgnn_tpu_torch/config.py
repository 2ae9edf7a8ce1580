"""Typed configuration — replaces the reference's module-level globals.

The port of buckgnn_tpu/config.py: `DataConfig` whole, `TrainConfig`
with the same field names, order and defaults but for ``rng_impl`` (see
its docstring), the JSON round trip and `checkpoint_config_dict`, the
``config`` payload of a checkpoint (TRAIN_FINAL.py:397-409). A
``train_config.json`` either package wrote loads in the other.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class DataConfig:
    """Data pipeline flags (GraphCreate.load_folder_dataset signature +
    TRAIN_FINAL globals)."""

    use_z_coord: bool = False               # USE_Z_COORD_GLOB (:32)
    use_rotations: bool = False             # USE_ROT_GLOB (:33)
    use_gp_forces: bool = False             # (TRAIN_FINAL.py:1151)
    use_axial_stress: bool = False          # USE_AXIAL_STRESS_GLOB (:34)
    use_mode_shapes_as_features: bool = False
    use_super_node: bool = False            # USE_SUPER_NODE_GLOB (:35)
    use_virtual_edges: bool = True          # default virtual-edge path
    virtual_edge_percentage: float = 0.1333  # VirtualEdgeCreate.py:21
    prediction_type: str = "buckling"       # PREDICTION_TYPE_GLOB (:36)
    transform: bool = True


@dataclasses.dataclass
class TrainConfig:
    """Model + optimization config (CONFIG_MANUAL_GLOB, TRAIN_FINAL.py:69-82,
    scheduler globals :45-49).

    The JAX package's ``rng_impl`` is left out: it picks the TPU's hardware
    generator for dropout, and the port draws its dropout seeds from a
    ``torch.Generator`` (train/trainer.py::train_gnn). `from_json` drops
    it from a JAX ``train_config.json``, and the JAX package's
    ``from_json`` fills in its default.
    """

    lr: float = 1e-2                        # INITIAL_LR_GLOB
    hidden_channels: int = 128
    num_layers: int = 6
    weight_decay: float = 1e-8
    num_epochs: int = 1501
    loss_function: str = "relative_error"
    use_edge_attr: bool = True
    pooling_layer: str = "mean"
    use_z_coord: bool = False
    use_rotations: bool = False
    dropout_rate: float = 0.1
    model_name: str = "GraphSage_addAggr_Shared"
    prediction_type: str = "buckling"

    batch_size: int = 128                   # BATCH_SIZE_GLOB (:37)
    scheduler: str = "cosine"               # SCHEDULER_GLOB: 'cosine'|'restart'
    use_lr_scheduler: bool = True           # USE_LR_SCHEDULER_GLOB
    t_0: int = 500                          # T_0_GLOB
    t_mult: int = 2                         # T_M_GLOB
    min_lr: float | None = None             # MIN_LR_GLOB == lr/100 when None

    seed: int = 0
    compute_dtype: str = "float32"          # 'float32' | 'bfloat16'
    segment_impl: str = "xla"               # models/buckgnn.py::IMPLS
    repack_every_epoch: bool = False        # re-shuffle batch composition
    profile_epochs: int = 0                 # trace the first N epochs
    remat: bool | None = None               # checkpoint conv layers;
                                            # None = auto (EA_GNN at h>=256)
    materialize_band: bool = True           # pack-time int8 band

    @property
    def eta_min(self) -> float:
        return self.lr / 100.0 if self.min_lr is None else self.min_lr

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def checkpoint_config_dict(
    cfg: TrainConfig, num_node_features: int, num_edge_features: int
) -> dict:
    """The `config` payload embedded in checkpoints (TRAIN_FINAL.py:397-409)."""
    return dict(
        num_node_features=num_node_features,
        num_edge_features=num_edge_features,
        hidden_channels=cfg.hidden_channels,
        num_layers=cfg.num_layers,
        use_edge_attr=cfg.use_edge_attr,
        use_z_coord=cfg.use_z_coord,
        use_rotations=cfg.use_rotations,
        prediction_type=cfg.prediction_type,
        pooling_layer=cfg.pooling_layer,
        dropout_rate=cfg.dropout_rate,
        model_name=cfg.model_name,
    )
