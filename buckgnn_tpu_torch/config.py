"""Typed configuration: the `TrainConfig` fields the port reads.

A subset of buckgnn_tpu/config.py::TrainConfig with the same names and
defaults: the model fields (``segment_impl`` "xla", the unfused SAGE path,
``remat``, the node-level heads' ``use_z_coord`` and ``use_rotations``),
the optimizer and learning-rate schedule fields of the train step, and
``materialize_band`` (False: the band is built on the device each step).
The rest of the data-pipeline fields come with later slices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    """Model + optimization config (CONFIG_MANUAL_GLOB, TRAIN_FINAL.py:69-82,
    scheduler globals :45-49)."""

    lr: float = 1e-2                        # INITIAL_LR_GLOB
    hidden_channels: int = 128
    num_layers: int = 6
    weight_decay: float = 1e-8
    loss_function: str = "relative_error"
    pooling_layer: str = "mean"
    use_z_coord: bool = False
    use_rotations: bool = False
    dropout_rate: float = 0.1
    model_name: str = "GraphSage_addAggr_Shared"
    prediction_type: str = "buckling"

    scheduler: str = "cosine"               # SCHEDULER_GLOB: 'cosine'|'restart'
    use_lr_scheduler: bool = True           # USE_LR_SCHEDULER_GLOB
    t_0: int = 500                          # T_0_GLOB
    t_mult: int = 2                         # T_M_GLOB
    min_lr: float | None = None             # MIN_LR_GLOB == lr/100 when None

    seed: int = 0
    compute_dtype: str = "float32"          # 'float32' | 'bfloat16'
    segment_impl: str = "xla"               # models/buckgnn.py::IMPLS
    remat: bool | None = None               # checkpoint conv layers;
                                            # None = auto (EA_GNN at h>=256)
    materialize_band: bool = True           # pack-time int8 band

    @property
    def eta_min(self) -> float:
        return self.lr / 100.0 if self.min_lr is None else self.min_lr
