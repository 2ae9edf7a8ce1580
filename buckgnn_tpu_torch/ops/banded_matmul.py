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

`banded_matmul` is the wrapper: on CUDA tensors it launches one of two
hand-written kernels, chosen by `kernel_variant` from x's dtype and width
alone: bf16 at H in ``ENGINE_WIDTHS`` takes ``csrc/banded_matmul.cu``
(``csrc/banded.cuh::band_kernel``, on persistent clusters of the product
engine), counted in ``ops/sage_layer.py::LAUNCHES["banded_matmul"]``;
float32, and bf16 at every other H % 128 == 0, take
``csrc/sage_simple.cu::band_simple`` (FFMA, a warp a row over the row's
nonzero counts), counted in ``LAUNCHES["banded_matmul_simple"]``. The rule
is static: a failed build or launch raises, it never sends a call to the
other kernel. On CPU tensors the wrapper runs `banded_matmul_plain`, the
plain PyTorch version with the TPU kernel's casts.
"""

from __future__ import annotations

import ctypes

import torch

from buckgnn_tpu_torch.graph.batch import SPILL_ALIGN, SPILL_CHUNK

_BM = 64  # rows per kernel block (csrc/engine.cuh)

# the widths the product engine's kernels take, in bf16 (csrc/engine.cuh:
# each of four warpgroups takes H/4 columns in [32 k, 64 n] boxes, so 384,
# whose 96 columns a warpgroup are no whole box, is not one of them)
ENGINE_WIDTHS = (128, 256, 512)
# the compute dtypes a TrainConfig admits, which every kernel variant takes
VARIANT_DTYPES = (torch.float32, torch.bfloat16)


def kernel_variant(dtype: torch.dtype, h: int) -> str:
    """Which hand-written kernel of #1-#6 a call in ``dtype`` at width
    ``h`` launches on the card: "engine" (csrc/sage_layer_{fwd,bwd}.cu,
    banded_matmul.cu, ea_block_{fwd,bwd}.cu: bf16 at H in ENGINE_WIDTHS) or
    "simple" (csrc/sage_simple.cu, ea_simple.cu: float32 at any H % 128 ==
    0, bf16 at the other widths). A rule on (dtype, H) alone, never a
    fallback; anything else raises (the JAX package's route to these
    kernels asks H % 128 == 0, ops/banded.py:304-307 and
    ops/pallas_ea_block.py:912-923; H % 128 != 0 takes the slab product or
    the unfused EA block there and here)."""
    if dtype not in VARIANT_DTYPES or h <= 0 or h % 128 != 0:
        raise NotImplementedError(
            f"kernels #1-#6 take float32 or bfloat16 at H % 128 == 0, "
            f"not {dtype} at H = {h}")
    if dtype == torch.bfloat16 and h in ENGINE_WIDTHS:
        return "engine"
    return "simple"


def variant_of(x: torch.Tensor, check) -> str:
    """`kernel_variant` of a kernel call's activations, refused by the
    wrapper's ``check`` (a ValueError naming the dtype and width) when no
    variant takes them."""
    h = x.shape[-1]
    what = f"not {x.dtype} at H = {h}"
    check(h % 128 == 0, f"H in multiples of 128, {what}")
    check(x.dtype in VARIANT_DTYPES, f"float32 or bfloat16 activations, {what}")
    return kernel_variant(x.dtype, h)


# The kernel against `banded_matmul_plain` on the same bf16 inputs, as
# (atol as a fraction of rms(ref), rtol): |got - ref| <= atol * rms(ref) +
# rtol * |ref|. Both sides sum the same exact bf16 products and terms in f32
# in another order and round once, so a value can round to the neighbouring
# bf16 value: one ulp, at most 2^-7 = 0.0078 of |out|, inside rtol 8e-3;
# atol 1e-2 of rms(out) covers entries whose terms cancel. A dropped spill
# message moves its row by about rms(x) per entry and fails it.
KERNEL_BANDED_TOL = (1e-2, 8e-3)
# The float32 variants against their float32 plain versions, as atol =
# SIMPLE_F32_TOL * max|ref| (rtol 0): both sides sum the same float32
# products in another order (f32 FFMA against the plain version's matmuls
# with TF32 off), a sum of K terms rounding at about sqrt(K) * 2^-24 of its
# terms' size. On an H100 at H 128-1024: z, y, agg, dx and the tables
# (K <= 2H + T + W) at most 2.7e-6 of max|ref|; dW, whose sums run over N
# rows (chunks of at most 2048, ops/sage_layer.py::_ksplit), reached
# 7.7e-6 at H 1024 with 34,500-row chunks. A dropped bias, spill run,
# star row or norm term moves entries by O(rms) and fails it.
SIMPLE_F32_TOL = 1e-5


def variant_tol(ref: torch.Tensor, dtype: torch.dtype, bf16_tol,
                frac: bool = True) -> tuple[float, float]:
    """(atol, rtol) of a kernel-vs-plain gate on inputs of ``dtype``:
    float32 `SIMPLE_F32_TOL` of max|ref|; bf16 the engine's gate
    ``bf16_tol``, as (atol, rtol) or, with ``frac``, as (atol as a fraction
    of rms(ref), rtol)."""
    if dtype == torch.float32:
        return SIMPLE_F32_TOL * float(ref.float().abs().max()), 0.0
    atol, rtol = bf16_tol
    if frac:
        atol *= float(ref.float().pow(2).mean().sqrt())
    return atol, rtol


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


def check_operands(floats, ints, band, x, check) -> None:
    """The operand rules every kernel variant of #1-#4 shares: every tensor
    on x's device and contiguous, the float operands in x's dtype, 16-byte
    aligned and of width H, the codes int32, the band (None: no band pass)
    int8."""
    dev = x.device
    for t in floats + ints + ([band] if band is not None else []):
        check(t.device == dev, "all tensors on one CUDA device")
        check(t.is_contiguous(), "contiguous tensors")
    for t in floats:
        check(t.dtype == x.dtype, "every activation/weight operand in x's "
              "dtype (float32 or bfloat16)")
        check(t.data_ptr() % 16 == 0, "16-byte aligned operands")
        check(t.shape[-1] == x.shape[-1], "every [., H] operand of width H")
    for t in ints:
        check(t.dtype == torch.int32, "int32 offsets and codes")
    check(band is None or band.dtype == torch.int8, "int8 band")


def check_engine(floats, band, tile: int, width: int, check) -> None:
    """What the product engine's TMA boxes add to `check_operands`:
    32-byte aligned bf16 operands and, with a band, a 16-byte aligned band
    of whole 16-column slab rows."""
    for t in floats:
        check(t.data_ptr() % 32 == 0, "32-byte aligned bf16 tensors")
    if band is not None:
        check(band.data_ptr() % 16 == 0, "16-byte aligned band")
        check((tile + width) % 16 == 0 and width % 2 == 0, "T+W % 16 == 0")


def check_band(band, n: int, tile: int, width: int, check) -> None:
    """The band geometry every variant takes: whole 64-row blocks in a tile
    (the table sums' blocks), whole tiles, a slab inside N."""
    check(tile % _BM == 0 and n % tile == 0, "tile % 64 == 0, N % tile == 0")
    check(n >= tile + width, "N >= T+W")
    check(band.numel() == n * (tile + width), "band [N/T, T, T+W]")


def check_spill(spill_offsets, spill_lo, spill_hi, spill_messages, n: int,
                tile: int, check) -> int:
    """The spill window's operands (``spill_offsets`` given): at least one
    SPILL_CHUNK of messages, an offset a tile and one more, lo and hi a
    row. Returns the message count."""
    n_spill = spill_messages.shape[0]
    check(n_spill >= SPILL_CHUNK, "at least SPILL_CHUNK spill rows")
    check(spill_offsets.numel() == n // tile + 1, "offsets [N/T + 1]")
    check(spill_lo.numel() == n and spill_hi.numel() == n,
          "spill lo, hi [N/T, T, 1]")
    return n_spill


def _launch(band, x, *, tile, width, out_dtype, spill_offsets, spill_lo,
            spill_hi, spill_messages, gcode, table, acc):
    """The checks every variant shares, then the variant's kernel:
    csrc/banded_matmul.cu (engine) or csrc/sage_simple.cu::band_simple
    (x, the messages, table and acc in x's dtype, any H % 128 == 0)."""
    from buckgnn_tpu_torch.ops.sage_layer import LAUNCHES
    from buckgnn_tpu_torch.utils import cuda_build

    engine = variant_of(x, _check) == "engine"
    n, h = x.shape
    has_spill, has_table = spill_offsets is not None, table is not None
    has_acc = acc is not None
    floats = [x] + ([spill_messages] if has_spill else []) + (
        [table] if has_table else []) + ([acc] if has_acc else [])
    ints = ([spill_offsets, spill_lo, spill_hi] if has_spill else []) + (
        [gcode] if has_table else [])
    check_operands(floats, ints, band, x, _check)
    _check(out_dtype in VARIANT_DTYPES, "out_dtype float32 or bfloat16")
    check_band(band, n, tile, width, _check)
    if engine:
        check_engine(floats, band, tile, width, _check)
    n_spill = tg = 0
    if has_spill:
        n_spill = check_spill(spill_offsets, spill_lo, spill_hi,
                              spill_messages, n, tile, _check)
    if has_table:
        tg = table.shape[0]
        _check(gcode.numel() == n, "one table code per row")
    if has_acc:
        _check(tuple(acc.shape) == (n, h), "acc [N, H]")

    out = torch.empty((n, h), dtype=out_dtype, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    f32_out = int(out_dtype == torch.float32)
    if engine:
        name = "banded_matmul"
        fn = cuda_build.load(name).banded_matmul
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        args = (_ptr(x), _ptr(band), _ptr(spill_messages), _ptr(spill_offsets),
                _ptr(spill_lo), _ptr(spill_hi), _ptr(gcode), _ptr(table),
                _ptr(acc), _ptr(out), n, h, tile, width, n_spill, tg,
                int(has_spill), int(has_table), int(has_acc), f32_out)
    else:
        name = "band_simple"
        fn = cuda_build.load("sage_simple").band_simple
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        args = (_ptr(x), _ptr(band), _ptr(spill_messages), _ptr(spill_offsets),
                _ptr(spill_lo), _ptr(spill_hi), _ptr(gcode), None, _ptr(table),
                _ptr(acc), _ptr(out), n, h, tile, width, n_spill, tg, 0, 0,
                int(x.dtype == torch.bfloat16), f32_out)
    fn.restype = ctypes.c_int
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_build.count_launch(
        LAUNCHES, "banded_matmul" if engine else "banded_matmul_simple")
    return out


def banded_matmul(band, x, *, tile: int, width: int, out_dtype=torch.float32,
                  spill_offsets=None, spill_lo=None, spill_hi=None,
                  spill_messages=None, gcode=None, table=None, acc=None):
    """The banded SpMM (arguments and result as `banded_matmul_plain`).
    CUDA tensors launch the kernel of `kernel_variant` (or raise); CPU
    tensors take the plain version."""
    kw = dict(tile=tile, width=width, out_dtype=out_dtype,
              spill_offsets=spill_offsets, spill_lo=spill_lo,
              spill_hi=spill_hi, spill_messages=spill_messages, gcode=gcode,
              table=table, acc=acc)
    if x.device.type == "cuda":
        return _launch(band, x, **kw)
    if x.device.type == "cpu":
        return banded_matmul_plain(band, x, **kw)
    raise ValueError(f"banded_matmul: unsupported device {x.device}")
