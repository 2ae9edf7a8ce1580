"""Neighbor aggregation for the unfused SAGE convolution (port of
buckgnn_tpu/ops/sage.py).

Messages flow senders -> receivers and are reduced at the receiver (PyG's
direction). The padding convention of `GraphBatch` (pad edges join the
dead node to itself) needs no edge masking: pads land only in the dead
node's row.
"""

from __future__ import annotations

import torch

from buckgnn_tpu_torch.ops import csr_segment, segment


def sage_aggregate(x: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor, num_nodes: int,
                   aggr: str = "add", impl: str = "xla",
                   csr: csr_segment.CsrContext | None = None) -> torch.Tensor:
    """aggr_{j in N(i)} x_j for every node i (receiver-sorted edges).

    ``impl``: ``'pallas'`` takes the CSR kernel (ops/csr_segment.py; ``csr``
    is the forward's `CsrContext`, built here when None); ``'xla'`` and
    ``'sorted'`` the segment reductions of the gathered rows. ``aggr``:
    'add' | 'sum' | 'mean' | 'max'.
    """
    if impl == "pallas":
        if csr is None:
            csr = csr_segment.make_csr_context(senders, receivers, num_nodes)
        return csr_segment.gather_segment_reduce(x, csr, aggr)
    messages = x[senders.long()]
    if aggr in ("add", "sum"):
        return segment.segment_sum(messages, receivers, num_nodes)
    if aggr == "mean":
        return segment.segment_mean(messages, receivers, num_nodes)
    if aggr == "max":
        return segment.segment_max(messages, receivers, num_nodes)
    raise ValueError(f"Unknown aggregation: {aggr}")
