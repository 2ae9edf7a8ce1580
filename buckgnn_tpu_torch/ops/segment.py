"""Few-segment reductions as one-hot products.

The port of the dense reductions of buckgnn_tpu/ops/segment.py:76-120,
with the same casts: the product accumulates in float32 and
`segment_sum_dense` returns the data's dtype. These are plain products
outside any kernel (graph readout and the first layer's star table).
"""

from __future__ import annotations

import torch


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
