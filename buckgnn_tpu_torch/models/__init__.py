"""Model family of the port."""

from buckgnn_tpu_torch.models.buckgnn import BuckGNN  # noqa: F401
