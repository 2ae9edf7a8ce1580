"""The unfused SAGE layer's epilogue: relu -> (+ skip) -> dropout, with its
kernels and VJP.

The port of buckgnn_tpu/ops/pallas_epilogue.py. `relu_skip_dropout(c, p,
seed, rate)` is ``dropout(relu(c) + p)``, one fusion boundary for the end of
every unfused layer (Models/BuckGNN.py:338-352):

- at rate 0 or without a seed it is ``relu(c) (+ p)`` in plain PyTorch
  (pallas_epilogue.py:214-216);
- otherwise one ``torch.autograd.Function`` whose only residual is c
  (:27-29, :140-173): forward y = keep ? round(f32(relu(c) (+ p)) * scale)
  : 0, backward dp = keep ? round(f32(g) * scale) : 0 and dc = dp * 1[c > 0].

The rounding follows what the JAX model runs on this path, the XLA branch
of ``relu_skip_dropout`` (models/buckgnn.py:130-139 never passes
``use_pallas``): t = relu(c) (+ p) in c's dtype, and the scale multiplies
in f32 with one rounding (ops/dropout.py:64-68). The TPU kernel rounds the
scale to bf16 first (pallas_epilogue.py:74, 89), a bias of up to 0.2%
that the JAX package's own dropout warns against.

The keep mask is the port's keyed hash, `ops/dropout.py::keep_mask` over
the global rows and columns (as in the fused kernels), so the words are not
the TPU's and the port matches the JAX package only at rate 0.
`epilogue_fwd` and `epilogue_bwd` are the wrappers of the hand-written
kernels ``csrc/epilogue.cu`` (#8 and #9 of the TPU kernels): on CUDA
tensors they launch them (bf16 or float32, H % 8 == 0) and count each
launch in ``LAUNCHES``, and raise on anything else; on CPU tensors they run
the plain versions `epilogue_fwd_plain` and `epilogue_bwd_plain`, which
compute the same values bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from buckgnn_tpu_torch.ops.dropout import (
    dropout_scale, dropout_threshold, keep_mask,
)

# launches of each kernel wrapper (reset by callers that count a run)
LAUNCHES = {"epilogue_fwd": 0, "epilogue_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _keep_scale(c: torch.Tensor, seed, rate: float):
    keep = keep_mask(seed, c.shape[0], c.shape[1], rate, c.device)
    return keep, torch.tensor(dropout_scale(rate), dtype=torch.float32,
                              device=c.device)


def epilogue_fwd_plain(c: torch.Tensor, p: torch.Tensor | None, seed,
                       rate: float) -> torch.Tensor:
    """keep ? round(f32(relu(c) (+ p)) * scale) : 0, in c's dtype."""
    t = torch.relu(c)
    if p is not None:
        t = t + p
    keep, scale = _keep_scale(c, seed, rate)
    return torch.where(keep, (t.float() * scale).to(c.dtype),
                       torch.zeros((), dtype=c.dtype, device=c.device))


def epilogue_bwd_plain(g: torch.Tensor, c: torch.Tensor, seed, rate: float,
                       has_skip: bool):
    """(dc, dp): dp = keep ? round(f32(g) * scale) : 0, dc = dp * 1[c > 0];
    dp is None without the skip."""
    keep, scale = _keep_scale(c, seed, rate)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dp = torch.where(keep, (g.float() * scale).to(g.dtype), zero)
    dc = torch.where(c > 0, dp, zero)
    return dc, (dp if has_skip else None)


def faults(g, c, p, seed, rate: float) -> dict:
    """Wrong epilogues that the bit-equality gate must fail, from the plain
    versions: {name: (fwd y, bwd (dc, dp))} of a mask drawn from the wrong
    seed word (the words swapped) and of a backward without the relu
    mask."""
    s0, s1 = seed
    swapped = (s1, s0)
    dp = epilogue_bwd_plain(g, c, seed, rate, True)[1]
    return {
        "wrong-seed-word": (epilogue_fwd_plain(c, p, swapped, rate),
                            epilogue_bwd_plain(g, c, swapped, rate,
                                               p is not None)),
        "no-relu-mask": (None, (dp, dp if p is not None else None)),
    }


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"epilogue kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _operands(tensors, like):
    for t in tensors:
        _check(t.device == like.device, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
        _check(t.dtype == like.dtype and t.shape == like.shape,
               "operands of one dtype and shape")
        _check(t.data_ptr() % 16 == 0, "16-byte aligned tensors")
    _check(like.dtype in (torch.bfloat16, torch.float32),
           "bfloat16 or float32 operands")
    _check(like.dim() == 2 and like.shape[1] % 8 == 0, "[N, H], H % 8 == 0")


def _words(seed, rate: float):
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return dropout_threshold(rate), s0, s1, dropout_scale(rate)


def _fn(name: str, n_ptr: int):
    from buckgnn_tpu_torch.utils import cuda_build

    fn = getattr(cuda_build.load("epilogue"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch_fwd(c, p, seed, rate):
    from buckgnn_tpu_torch.utils import cuda_build

    _operands([c] + ([p] if p is not None else []), c)
    y = torch.empty_like(c)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = _fn("epilogue_fwd", 3)(
        _ptr(c), _ptr(p), _ptr(y), c.shape[0], c.shape[1],
        int(c.dtype == torch.float32), *_words(seed, rate),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"epilogue_fwd launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "epilogue_fwd")
    return y


def _launch_bwd(g, c, seed, rate, has_skip):
    from buckgnn_tpu_torch.utils import cuda_build

    _operands([g, c], c)
    dc = torch.empty_like(c)
    dp = torch.empty_like(c) if has_skip else None
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = _fn("epilogue_bwd", 4)(
        _ptr(g), _ptr(c), _ptr(dc), _ptr(dp), c.shape[0], c.shape[1],
        int(c.dtype == torch.float32), *_words(seed, rate),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"epilogue_bwd launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "epilogue_bwd")
    return dc, dp


def epilogue_fwd(c, p, seed, rate: float):
    """The epilogue's forward (as `epilogue_fwd_plain`). CUDA tensors launch
    the kernel (or raise); CPU tensors take the plain version."""
    if c.device.type == "cuda":
        return _launch_fwd(c, p, seed, rate)
    if c.device.type == "cpu":
        return epilogue_fwd_plain(c, p, seed, rate)
    raise ValueError(f"epilogue_fwd: unsupported device {c.device}")


def epilogue_bwd(g, c, seed, rate: float, has_skip: bool):
    """The epilogue's backward (as `epilogue_bwd_plain`). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if c.device.type == "cuda":
        return _launch_bwd(g, c, seed, rate, has_skip)
    if c.device.type == "cpu":
        return epilogue_bwd_plain(g, c, seed, rate, has_skip)
    raise ValueError(f"epilogue_bwd: unsupported device {c.device}")


class _Epilogue(torch.autograd.Function):
    """dropout(relu(c) (+ p)); the residual is c alone."""

    @staticmethod
    def forward(ctx, c, p, seed, rate):
        ctx.save_for_backward(c)
        ctx.seed, ctx.rate, ctx.has_skip = seed, rate, p is not None
        return epilogue_fwd(c, p, seed, rate)

    @staticmethod
    def backward(ctx, g):
        (c,) = ctx.saved_tensors
        dc, dp = epilogue_bwd(g.to(c.dtype).contiguous(), c, ctx.seed,
                              ctx.rate, ctx.has_skip)
        return dc, dp, None, None


def relu_skip_dropout(c: torch.Tensor, p: torch.Tensor | None, seed,
                      rate: float) -> torch.Tensor:
    """``dropout(relu(c) + p, rate)`` with the port's hashed mask under
    ``seed`` (two 32-bit words); ``p`` None: no skip. ``seed`` may be None
    only when ``rate`` <= 0 (the deterministic epilogue)."""
    if rate <= 0.0 or seed is None:
        t = torch.relu(c)
        return t if p is None else t + p
    return _Epilogue.apply(c, p, seed, float(rate))
