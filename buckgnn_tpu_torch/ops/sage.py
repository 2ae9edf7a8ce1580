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


class _GatherMessages(torch.autograd.Function):
    """``x[senders]``, whose backward keeps the last row's duplicates
    apart. A batch's last row is its dead row, the sender of every pad
    edge, and advanced indexing's backward (a sorted ``index_put_``) walks
    each index's duplicates in turn: 86,004 pads on one row made a float32
    train step 372 ms on an H100 (tools/cli_step_profile.py). Here the
    same ``index_put_`` sends each message of the last row to a spare row
    of its own (one per edge slot, modulo N), and the spare rows are
    summed into the last."""

    @staticmethod
    def forward(ctx, x, senders):
        ctx.save_for_backward(senders)
        ctx.n = x.shape[0]
        return x.index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        (senders,) = ctx.saved_tensors
        n = ctx.n
        spare = n + torch.arange(senders.shape[0],
                                 device=senders.device) % n
        idx = torch.where(senders == n - 1, spare, senders)
        dx = g.new_zeros((2 * n, g.shape[1]))
        dx.index_put_((idx,), g, accumulate=True)
        dx[n - 1] += dx[n:].sum(0)
        return dx[:n], None


def _gather_messages(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    return _GatherMessages.apply(x, senders.long())


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
    messages = _gather_messages(x, senders)
    if aggr in ("add", "sum"):
        return segment.segment_sum(messages, receivers, num_nodes)
    if aggr == "mean":
        return segment.segment_mean(messages, receivers, num_nodes)
    if aggr == "max":
        return segment.segment_max(messages, receivers, num_nodes)
    raise ValueError(f"Unknown aggregation: {aggr}")
