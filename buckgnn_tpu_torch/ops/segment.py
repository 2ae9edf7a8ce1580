"""Segment reductions (port of buckgnn_tpu/ops/segment.py).

`segment_sum`, `segment_count`, `segment_mean` and `segment_max` are the
scatter reductions of buckgnn_tpu/ops/segment.py:19-73: the ``'xla'``
route of the unfused SAGE aggregation (ops/sage.py) and the plain versions
of the CSR kernel (ops/csr_segment.py). `segment_sum` accumulates in
float32 (``index_add_`` into a float32 buffer) and casts once to the data's
dtype. That is a deliberate difference from XLA, whose bf16 scatter-add
rounds to bf16 after every add: a bf16 ``index_add_`` would do the same
and, on the card, add by atomics in bf16 in an order that changes from run
to run. So on bf16 data the port's sums are the f32 sums of the CSR kernel
(pallas_segment.py's f32 accumulator), within a few bf16 ulps of XLA's.

`segment_sum_dense` and `segment_count_dense` are the few-segment
reductions of :76-120 as one-hot products with the same casts (the product
accumulates in float32, the sum returns the data's dtype): plain products
outside any kernel (graph readout and the first layer's star table).
`segment_softmax_weights` is the per-segment softmax of :123-141.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments, ...] sums of the rows of ``data`` by segment id,
    accumulated in float32 and cast to ``data.dtype``."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, segment_ids.long(), data.float())
    return out.to(data.dtype)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """[num_segments] float32 element counts (``mask``: counted elements)."""
    ones = (torch.ones(segment_ids.shape, dtype=torch.float32,
                       device=segment_ids.device)
            if mask is None else mask.float())
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over segments; an empty segment gives 0 (torch_scatter's
    scatter_mean). The sum, in ``data.dtype``, is divided by the count in
    float32, so bf16 data gives a float32 mean (bf16 / f32 promotes, as in
    the JAX package)."""
    if mask is not None:
        data = data * mask.to(data.dtype)[..., None]
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments, mask)
    return total.float() / count.clamp_min(1.0)[..., None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max over segments in ``data.dtype``; an empty segment (and any
    non-finite result) gives 0, as PyG's ``aggr='max'``."""
    out = torch.full((num_segments, *data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    ids = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1)))
    out = out.scatter_reduce(0, ids.expand_as(data), data, "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


def one_hot_matrix(
    segment_ids: torch.Tensor,
    num_segments: int,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """[num_segments, N] bool membership matrix."""
    iota = torch.arange(num_segments, dtype=segment_ids.dtype,
                        device=segment_ids.device)
    m = segment_ids[None, :] == iota[:, None]
    if keep is not None:
        m = m & keep[None, :]
    return m


def segment_sum_dense(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """segment_sum via a one-hot product accumulated in float32; ``keep``
    masks elements out of all segments."""
    p = one_hot_matrix(segment_ids, num_segments, keep).to(data.dtype)
    return torch.matmul(p.float(), data.float()).to(data.dtype)


def segment_count_dense(
    segment_ids: torch.Tensor,
    num_segments: int,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Element counts per segment (float32)."""
    p = one_hot_matrix(segment_ids, num_segments, keep)
    return p.float().sum(dim=1)


def segment_softmax_weights(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Per-segment softmax of per-element logits (for attention pooling),
    buckgnn_tpu/ops/segment.py:123-141: shifted by the segment's maximum
    (0 for an empty segment or a non-finite maximum), the denominator
    clamped at 1e-16. ``indices_are_sorted`` is accepted for the JAX
    signature and changes nothing; the gradient comes from autograd."""
    del indices_are_sorted
    ids = segment_ids.long()
    expd = torch.exp(logits - segment_max(logits, ids, num_segments)[ids])
    return expd / segment_sum(expd, ids, num_segments)[ids].clamp_min(1e-16)
