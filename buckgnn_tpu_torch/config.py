"""Typed configuration: the `TrainConfig` fields the serving path reads.

A subset of buckgnn_tpu/config.py::TrainConfig with the same names and
defaults. The optimizer, scheduler and data-pipeline fields come with the
training slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    """Model config (CONFIG_MANUAL_GLOB, TRAIN_FINAL.py:69-82)."""

    hidden_channels: int = 128
    num_layers: int = 6
    loss_function: str = "relative_error"
    pooling_layer: str = "mean"
    dropout_rate: float = 0.1
    model_name: str = "GraphSage_addAggr_Shared"
    prediction_type: str = "buckling"
    seed: int = 0
    compute_dtype: str = "float32"          # 'float32' | 'bfloat16'
    segment_impl: str = "banded_pallas"     # the fused banded path
