"""Serving-side timing of the port."""

from buckgnn_tpu_torch.eval.inference import run_inference  # noqa: F401
from buckgnn_tpu_torch.eval.timer import run_time_analysis  # noqa: F401
