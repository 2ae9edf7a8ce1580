"""Banded SpMM with the fused spill window: kernel wrapper and plain version.

The port of buckgnn_tpu/ops/pallas_banded.py (`pallas_banded_matmul`). Per
node tile t of T rows, with the forward's clamped slab start
s_t = clip(t*T - W/2, 0, N - (T+W)):

    out[t] = band[t] @ x[s_t : s_t+T+W]                  (f32 accumulation)
             + sel(lo, hi) @ spill window of t           (spill)
             + onehot(gcode) @ table                     (table)
             + acc[t]                                    (acc)

cast once to ``out_dtype``. The spill window of tile t is the SPILL_CHUNK
rows of the receiver-sorted message list starting at
clip(off[t] // SPILL_ALIGN * SPILL_ALIGN, 0, Es - SPILL_CHUNK); each row r
takes the run [lo[r], hi[r]) of it (graph/batch.py::_host_spill_ranges
packs off, lo and hi).

`banded_matmul` is the wrapper: on CUDA tensors it launches the hand-written
kernel ``csrc/banded_matmul.cu`` (``csrc/banded.cuh::band_kernel``, bf16
only, on persistent clusters of the product engine) and counts the launch in
``ops/sage_layer.py::LAUNCHES["banded_matmul"]``; on CPU tensors it runs
`banded_matmul_plain`, the plain PyTorch version with the TPU kernel's
casts.
"""

from __future__ import annotations

import ctypes

import torch

from buckgnn_tpu_torch.graph.batch import SPILL_ALIGN, SPILL_CHUNK

_BM = 64  # rows per kernel block (csrc/engine.cuh)

# The kernel against `banded_matmul_plain` on the same bf16 inputs, as
# (atol as a fraction of rms(ref), rtol): |got - ref| <= atol * rms(ref) +
# rtol * |ref|. Both sides sum the same exact bf16 products and terms in f32
# in another order and round once, so a value can round to the neighbouring
# bf16 value: one ulp, at most 2^-7 = 0.0078 of |out|, inside rtol 8e-3;
# atol 1e-2 of rms(out) covers entries whose terms cancel. A dropped spill
# message moves its row by about rms(x) per entry and fails it.
KERNEL_BANDED_TOL = (1e-2, 8e-3)


def slab_starts(n: int, tile: int, width: int, device) -> torch.Tensor:
    """[n_tiles] clamped slab starts clip(t*T - W/2, 0, N - (T+W))."""
    slab = tile + width
    t = torch.arange(n // tile, device=device)
    return (t * tile - width // 2).clamp(0, max(n - slab, 0))


def spill_term_plain(msgs, offsets, lo, hi, n_tiles: int, tile: int,
                     dtype) -> torch.Tensor:
    """[n_tiles, T, H] float32 spill sums as the TPU kernel computes them:
    the one-hot selection sel[r, m] = lo[r] <= m < hi[r] (in ``dtype``)
    times the tile's SPILL_CHUNK-row window of ``msgs``, the window start
    and lo/hi as the batch packed them."""
    es = msgs.shape[0]
    win = (offsets[:-1].long() // SPILL_ALIGN * SPILL_ALIGN).clamp(
        0, es - SPILL_CHUNK)
    cols = torch.arange(SPILL_CHUNK, device=msgs.device)
    lo = lo.reshape(n_tiles, tile, 1)
    hi = hi.reshape(n_tiles, tile, 1)
    sel = ((cols >= lo) & (cols < hi)).to(dtype).float()
    return torch.bmm(sel, msgs[win[:, None] + cols].float())


def banded_matmul_plain(band, x, *, tile: int, width: int,
                        out_dtype=torch.float32, spill_offsets=None,
                        spill_lo=None, spill_hi=None, spill_messages=None,
                        gcode=None, table=None, acc=None):
    """Plain PyTorch version of the banded SpMM, operation by operation as
    the TPU kernel: products accumulated in float32, one cast at the end.

    ``band``: [n_tiles, T, T+W] counts (an integer band is cast to x.dtype).
    ``spill_offsets`` [n_tiles+1], ``spill_lo``/``spill_hi`` [n_tiles, T, 1]
    and ``spill_messages`` [Es, H] (x[spill_senders]) add the spill window.
    ``gcode`` [n_tiles, T, 1] and ``table`` [tg, H] add table[gcode] (the
    sentinel tg adds nothing). ``acc`` [N, H] is added before the cast.
    """
    n, h = x.shape
    n_tiles = n // tile
    dt = x.dtype
    starts = slab_starts(n, tile, width, x.device)
    xs = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    b = band.reshape(n_tiles, tile, tile + width)
    if not b.is_floating_point():
        b = b.to(dt)
    out = torch.bmm(b.float(), xs.to(b.dtype).float())
    if spill_offsets is not None:
        out = out + spill_term_plain(spill_messages, spill_offsets, spill_lo,
                                     spill_hi, n_tiles, tile, dt)
    if table is not None:
        # the one-hot product of one selected row is that row, exactly
        tab = torch.cat([table.float(), table.new_zeros((1, h),
                                                        dtype=torch.float32)])
        out = out + tab[gcode.reshape(n_tiles, tile).long()]
    if acc is not None:
        out = out + acc.reshape(n_tiles, tile, h).float()
    return out.reshape(n, h).to(out_dtype)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"banded matmul kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(band, x, *, tile, width, out_dtype, spill_offsets, spill_lo,
            spill_hi, spill_messages, gcode, table, acc):
    from buckgnn_tpu_torch.ops.sage_layer import LAUNCHES
    from buckgnn_tpu_torch.utils import cuda_build

    n, h = x.shape
    has_spill = spill_offsets is not None
    has_table = table is not None
    has_acc = acc is not None
    bf16 = [x] + ([spill_messages] if has_spill else []) + (
        [table] if has_table else []) + ([acc] if has_acc else [])
    ints = ([spill_offsets, spill_lo, spill_hi] if has_spill else []) + (
        [gcode] if has_table else [])
    dev = x.device
    for t in bf16 + ints + [band]:
        _check(t.device == dev, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
    for t in bf16:
        _check(t.dtype == torch.bfloat16, "bfloat16 operands")
        _check(t.data_ptr() % 32 == 0, "32-byte aligned bf16 tensors")
        _check(t.shape[-1] == h, "every [., H] operand of width H")
    for t in ints:
        _check(t.dtype == torch.int32, "int32 offsets and codes")
    _check(band.dtype == torch.int8, "int8 band")
    _check(band.data_ptr() % 16 == 0, "16-byte aligned band")
    _check(out_dtype in (torch.bfloat16, torch.float32),
           "out_dtype bfloat16 or float32")
    _check(h in (128, 256, 512), "H in (128, 256, 512)")
    _check(tile % _BM == 0 and n % tile == 0, "tile % 64 == 0, N % tile == 0")
    _check((tile + width) % 16 == 0 and width % 2 == 0, "T+W % 16 == 0")
    _check(n >= tile + width, "N >= T+W")
    _check(band.numel() == n * (tile + width), "band [N/T, T, T+W]")
    n_spill = tg = 0
    if has_spill:
        n_spill = spill_messages.shape[0]
        _check(n_spill >= SPILL_CHUNK, "at least SPILL_CHUNK spill rows")
        _check(spill_offsets.numel() == n // tile + 1, "offsets [N/T + 1]")
        _check(spill_lo.numel() == n and spill_hi.numel() == n,
               "lo, hi [N/T, T, 1]")
    if has_table:
        tg = table.shape[0]
        _check(gcode.numel() == n, "one table code per row")
    if has_acc:
        _check(tuple(acc.shape) == (n, h), "acc [N, H]")

    out = torch.empty((n, h), dtype=out_dtype, device=dev)
    lib = cuda_build.load("banded_matmul")
    fn = lib.banded_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(x), _ptr(band), _ptr(spill_messages), _ptr(spill_offsets),
             _ptr(spill_lo), _ptr(spill_hi), _ptr(gcode), _ptr(table),
             _ptr(acc), _ptr(out), n, h, tile, width, n_spill, tg,
             int(has_spill), int(has_table), int(has_acc),
             int(out_dtype == torch.float32), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"banded_matmul launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "banded_matmul")
    return out


def banded_matmul(band, x, *, tile: int, width: int, out_dtype=torch.float32,
                  spill_offsets=None, spill_lo=None, spill_hi=None,
                  spill_messages=None, gcode=None, table=None, acc=None):
    """The banded SpMM (arguments and result as `banded_matmul_plain`).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    kw = dict(tile=tile, width=width, out_dtype=out_dtype,
              spill_offsets=spill_offsets, spill_lo=spill_lo,
              spill_hi=spill_hi, spill_messages=spill_messages, gcode=gcode,
              table=table, acc=acc)
    if x.device.type == "cuda":
        return _launch(band, x, **kw)
    if x.device.type == "cpu":
        return banded_matmul_plain(band, x, **kw)
    raise ValueError(f"banded_matmul: unsupported device {x.device}")
