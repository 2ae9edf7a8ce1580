"""CSR segment reduction of gathered rows: kernel wrapper, plain version and
its VJP.

The port of buckgnn_tpu/ops/pallas_segment.py (`gather_segment_reduce`,
the ``impl='pallas'`` aggregation of ops/sage.py) for receiver-sorted edge
lists:

    out[i] = aggr over edges k with receivers[k] == i of x[senders[k]]

``'add'``/``'sum'`` sums in float32 and returns ``x.dtype``; ``'mean'``
divides the sum, already rounded to ``x.dtype``, by max(count, 1) in
float32 and returns float32 (bf16 / f32 promotes, pallas_segment.py:
165-167, as the XLA route's `segment.segment_mean` does); ``'max'`` is
`segment.segment_max` of the gathered rows on either route, as
pallas_segment.py:96-102 takes it (a selection product cannot express max).

`make_csr_context` builds, once per forward, the receiver offsets (from
the sorted receivers by ``bincount`` and ``cumsum``, as :124-132), the
in-degrees and the transposed CSR for the backward: the receivers in
sender order and the sender offsets. `csr_segment_sum` is the wrapper of
the hand-written kernel ``csrc/csr_segment.cu``: on CUDA tensors it
launches it (bf16 or float32, any row count, H % 8 == 0 up to 1024) and
counts the launch in ``LAUNCHES``, and raises on anything else; on CPU
tensors it runs `csr_segment_sum_plain`. It does not take the TPU kernel's
shape fallbacks (H % 128, N % 256), which exist for the TPU's tiles. The
kernel sums a run of at most SPLIT edges in one warp and cuts a longer
run into SPLIT-edge chunks, summed by separate warps and added in chunk
order; `csr_segment_sum_split_plain` is that order in plain PyTorch.

The JAX package has no VJP for this kernel (``jax.grad`` through it
raises). The port's backward is the same CSR sum over the transposed CSR,
applied to the cotangent (divided by the receiver's count first, for
``'mean'``): dx[j] = sum over edges k with senders[k] == j of
dout[receivers[k]], for any edge set, symmetric or not.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from buckgnn_tpu_torch.ops import segment

# launches of the kernel wrapper (reset by callers that count a run)
LAUNCHES = {"csr_segment": 0}

# The kernel against the plain version on the same inputs (`gate`): both
# sides sum the same values in f32 in another order and round once, so an
# output can round to the neighbouring bf16 value, one ulp, at most 2^-7 of
# |out|: |got - ref| <= atol + rtol * |ref| with sage_layer.KERNEL_Z_TOL's
# (4e-3, 8e-3). On bf16 rows a flip needs the exact sum within the f32
# noise of a rounding boundary, so few outputs differ at all: at most
# KERNEL_FLIP_SHARE of them (an f32 sum of a few hundred terms is good to
# ~1e-5 relative and a bf16 half ulp is 2e-3, so even a hub's row flips
# about 1e-3 of its entries, one row among thousands; an H100 run at the
# csr-virtual shape flipped 2e-8 of the outputs). A mean that divides
# before it rounds moves most outputs by up to half an ulp, inside the ulp
# gate, and fails the share; a lost edge fails the ulp gate. Float32 rows
# are not rounded to bf16: their last bits differ with the order (about
# 30% of the outputs), so they take the ulp gate alone.
KERNEL_TOL = (4e-3, 8e-3)
KERNEL_FLIP_SHARE = 1e-3

# edges one warp of the kernel sums at once (csrc/csr_segment.cu::kSplit):
# a longer run is cut into chunks of SPLIT edges
SPLIT = 32


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class CsrContext:
    """A receiver-sorted edge list as CSR, both ways (build once per
    forward, reuse across layers)."""

    num_segments: int
    senders: torch.Tensor    # [E] int32, receiver order: the forward's rows
    receivers: torch.Tensor  # [E] int32, ascending
    row_off: torch.Tensor    # [N + 1] int32 receiver offsets
    cnt: torch.Tensor        # [N] float32 in-degrees
    t_idx: torch.Tensor      # [E] int32 receivers in sender order
    t_off: torch.Tensor      # [N + 1] int32 sender offsets


def _offsets(ids: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    counts = torch.bincount(ids.long(), minlength=n)
    off = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    off[1:] = torch.cumsum(counts, 0)
    return off, counts


def make_csr_context(senders: torch.Tensor, receivers: torch.Tensor,
                     num_segments: int) -> CsrContext:
    """The CSR of a receiver-sorted edge list (the `GraphBatch` layout) and
    its transpose; ids in [0, num_segments)."""
    row_off, cnt = _offsets(receivers, num_segments)
    t_off, _ = _offsets(senders, num_segments)
    perm = torch.argsort(senders, stable=True)
    return CsrContext(
        num_segments=num_segments, senders=senders.int().contiguous(),
        receivers=receivers.int().contiguous(), row_off=row_off,
        cnt=cnt.float(), t_idx=receivers[perm].int().contiguous(),
        t_off=t_off)


def csr_segment_sum_plain(x: torch.Tensor, idx: torch.Tensor,
                          off: torch.Tensor, mean: bool = False):
    """out[i] = sum of x[idx[k]] for k in [off[i], off[i+1]), in float32,
    cast to x.dtype (``mean``: float32 of that, over max(count, 1))."""
    n = off.numel() - 1
    counts = (off[1:] - off[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts,
                                   output_size=idx.numel())
    out = segment.segment_sum(x[idx.long()], rows, n)
    if mean:
        return out.float() / counts.float().clamp_min(1.0)[:, None]
    return out


def csr_segment_sum_split_plain(x: torch.Tensor, idx: torch.Tensor,
                                off: torch.Tensor, mean: bool = False):
    """`csr_segment_sum_plain` in the kernel's order: a run of at most SPLIT
    edges summed in float32 in edge order; a longer run cut into chunks of
    SPLIT edges, each summed on its own, the chunk sums added in chunk
    order; one rounding to x.dtype (``mean``: float32 of that, over
    max(count, 1))."""
    n, h = off.numel() - 1, x.shape[1]
    counts = (off[1:] - off[:-1]).long()
    nch = (counts + SPLIT - 1) // SPLIT
    coff = torch.zeros(n + 1, dtype=torch.long, device=x.device)
    coff[1:] = torch.cumsum(nch, 0)
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts,
                                   output_size=idx.numel())
    k = torch.arange(idx.numel(), device=x.device)
    chunk = coff[rows] + (k - off[rows].long()) // SPLIT
    part = torch.zeros((int(coff[-1]), h), dtype=torch.float32,
                       device=x.device).index_add_(0, chunk,
                                                   x[idx.long()].float())
    total = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for j in range(int(nch.max()) if n else 0):
        has = nch > j
        total[has] = total[has] + part[coff[:-1][has] + j]
    out = total.to(x.dtype)
    if mean:
        return out.float() / counts.float().clamp_min(1.0)[:, None]
    return out


def gate(got: torch.Tensor, ref: torch.Tensor,
         x_dtype: torch.dtype) -> tuple[bool, float, float]:
    """The kernel's output ``got`` against the plain ``ref`` from rows of
    ``x_dtype``: (within KERNEL_TOL and, for bf16 rows, at most
    KERNEL_FLIP_SHARE of the outputs not equal; max abs error; that
    share)."""
    g, r = got.float(), ref.float()
    if g.numel() == 0:
        return True, 0.0, 0.0
    err = (g - r).abs()
    share = float((g != r).float().mean())
    atol, rtol = KERNEL_TOL
    ok = (bool(torch.isfinite(g).all())
          and not bool((err > atol + rtol * r.abs()).any())
          and (x_dtype != torch.bfloat16 or share <= KERNEL_FLIP_SHARE))
    return ok, float(err.max()), share


def faults(x: torch.Tensor, idx: torch.Tensor, off: torch.Tensor,
           mean: bool) -> dict:
    """Wrong CSR sums that the gate must fail, from the plain version: the
    last edge of every run skipped, and (``mean``) the mean taken before
    the rounding to x.dtype (the f32 sum over the count, then rounded; a
    fault on bf16 rows only, float32 rows give the same values)."""
    n = off.numel() - 1
    counts = (off[1:] - off[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts,
                                   output_size=idx.numel())
    last = torch.zeros(idx.numel(), dtype=torch.bool, device=x.device)
    last[off[1:][counts > 0].long() - 1] = True
    kept = x[idx.long()] * (~last).to(x.dtype)[:, None]
    total = torch.zeros((n, x.shape[1]), dtype=torch.float32,
                        device=x.device).index_add_(0, rows, kept.float())
    cnt = counts.float().clamp_min(1.0)[:, None]
    if not mean:
        return {"skip-last-edge": total.to(x.dtype)}
    whole = torch.zeros_like(total).index_add_(0, rows, x[idx.long()].float())
    return {"skip-last-edge": total.to(x.dtype).float() / cnt,
            "mean-before-rounding": (whole / cnt).to(x.dtype).float()}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"CSR segment kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(x, idx, off, mean=False):
    from buckgnn_tpu_torch.utils import cuda_build

    dev = x.device
    for t in (x, idx, off):
        _check(t.device == dev, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
    _check(x.dtype in (torch.bfloat16, torch.float32),
           "bfloat16 or float32 rows")
    _check(idx.dtype == torch.int32 and off.dtype == torch.int32,
           "int32 indices and offsets")
    _check(x.dim() == 2, "x [N, H]")
    h = x.shape[1]
    _check(h % 8 == 0 and 0 < h <= 1024, "H % 8 == 0, H <= 1024")
    _check(x.data_ptr() % 16 == 0, "16-byte aligned rows")
    n = off.numel() - 1
    out = torch.empty((n, h), dtype=torch.float32 if mean else x.dtype,
                      device=dev)
    lib = cuda_build.load("csr_segment")
    fn = lib.csr_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(x), _ptr(idx), _ptr(off), _ptr(None if mean else out),
             _ptr(out if mean else None), n, h,
             int(x.dtype == torch.float32), int(mean),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"csr_segment launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "csr_segment")
    return out


def csr_segment_sum(x: torch.Tensor, idx: torch.Tensor, off: torch.Tensor,
                    mean: bool = False) -> torch.Tensor:
    """The CSR sum (arguments and result as `csr_segment_sum_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if x.device.type == "cuda":
        return _launch(x, idx, off, mean)
    if x.device.type == "cpu":
        return csr_segment_sum_plain(x, idx, off, mean)
    raise ValueError(f"csr_segment_sum: unsupported device {x.device}")


class _CsrReduce(torch.autograd.Function):
    """The CSR sum or mean and its VJP over the transposed CSR."""

    @staticmethod
    def forward(ctx, x, csr: CsrContext, mean: bool):
        ctx.csr, ctx.mean, ctx.x_dtype = csr, mean, x.dtype
        return csr_segment_sum(x, csr.senders, csr.row_off, mean)

    @staticmethod
    def backward(ctx, g):
        csr = ctx.csr
        if ctx.mean:
            # the mean's cotangent reaches the rounded sum divided by the
            # count in f32, rounded to the sum's type
            g = g.float() / csr.cnt.clamp_min(1.0)[:, None]
        g = g.to(ctx.x_dtype).contiguous()
        return csr_segment_sum(g, csr.t_idx, csr.t_off), None, None


def gather_segment_reduce(x: torch.Tensor, csr: CsrContext,
                          aggr: str = "add") -> torch.Tensor:
    """aggr_{j in N(i)} x_j over the context's edges (the JAX package's
    `gather_segment_reduce`); differentiable in x."""
    if aggr == "max":
        return segment.segment_max(x[csr.senders.long()], csr.receivers,
                                   csr.num_segments)
    if aggr not in ("add", "sum", "mean"):
        raise ValueError(f"Unknown aggregation: {aggr}")
    return _CsrReduce.apply(x, csr, aggr == "mean")
