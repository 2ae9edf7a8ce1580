"""Losses, metrics and the eval step of the port."""

from buckgnn_tpu_torch.train.losses import get_loss_function  # noqa: F401
from buckgnn_tpu_torch.train.metrics import MAPE_error, stress_errors  # noqa: F401
