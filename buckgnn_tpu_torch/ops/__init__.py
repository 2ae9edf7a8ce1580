"""Aggregation ops and the fused SAGE layer of the port."""

from buckgnn_tpu_torch.ops.segment import (  # noqa: F401
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax_weights,
)
from buckgnn_tpu_torch.ops.sage import sage_aggregate  # noqa: F401
