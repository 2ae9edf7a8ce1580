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
``csrc/sage_simple.cu::band_simple`` (a block a tile and 256 bytes of
columns: the slab staged once in shared memory, then f32 FMAs, a warp a
row over the row's nonzero counts), counted in
``LAUNCHES["banded_matmul_simple"]``. The rule
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
# SIMPLE_F32_TOL * max|ref| (rtol 0). The variants' products run on the
# tensor cores in 3xTF32 (csrc/simple.cuh): each float32 operand x is split
# into hi = tf32(x) and lo = tf32(x - hi), which keep about 2^-22 of x,
# and the sums take hi.hi + hi.lo + lo.hi (`mm_3xtf32` models it); the
# plain versions' matmuls run in float32 with TF32 off. Both sides then
# sum nearly the same float32 products in another order, a sum of K terms
# rounding at about sqrt(K) * 2^-24 of its terms' size. On an H100 (NVIDIA
# H100 80GB HBM3, 700 W; chip_smoke.py phase 13) #1s-#4s's outputs (z, y,
# agg, dx, the tables and dW over N rows in chunks, ops/sage_layer.py::
# _ksplit) at H 128-1024 lay within 3.6e-6 of max|ref|; from a float64
# evaluation of #3's plain version the kernel lay 1.1e-6 of max and the
# float32 plain version 3.5e-6. One TF32 pass (hi.hi alone) keeps about
# 2^-11 of each operand: on the card's operands of #3s's and #6s's
# products it lay 2.8e-4 to 3.5e-4 of max, outside this gate. A dropped
# bias, spill run, star row or norm term moves entries by O(rms) and fails
# it.
SIMPLE_F32_TOL = 1e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest tf32 value (10 mantissa bits),
    ties away from zero, as PTX ``cvt.rna.tf32.f32`` does on the card: half
    a tf32 unit (0x1000) added to the magnitude bits, the low 13 bits
    cleared. Subnormals round the same way, a value past the largest tf32
    value below inf becomes inf, inf and nan pass unchanged. The product
    tile's split (csrc/simple.cuh): hi = tf32_round(x), lo =
    tf32_round(x - hi). For tests and chip_smoke.py; the port's kernels do
    this on the card."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + 0x1000) & -0x2000
    return torch.where(finite, rounded, bits).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, lo: bool = True
              ) -> torch.Tensor:
    """a @ b (float32 [M, K] @ [K, N]) with the product tile's split
    arithmetic: hi.hi + hi.lo + lo.hi of the operands' tf32 parts (lo.lo
    left out), each product and the sums in float64, rounded once to
    float32; with ``lo=False`` one TF32 pass, hi.hi alone. What the split
    keeps of the operands, not the card's order of sums. For tests and
    chip_smoke.py."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = ah.double() @ bh.double()
    if lo:
        al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


# The weight tile (csrc/wtile.cuh), which runs the variants' products whose
# B is a weight (as stored, or transposed: the backward's dout @ W^T), takes
# B pre-split once a call: its tf32 parts (hi and lo in float32, the value
# in bf16) as [parts, N, K] (K-major), each 32-deep slice of K in the order
# WTILE_DEPTH (position p holds depth WTILE_DEPTH[p]), the order in which a
# consumer thread's A fragment comes from two whole 16-byte loads a row.
WTILE_DEPTH = tuple(4 * (p % 4) + 16 * ((p % 8) // 4) + p // 8
                    for p in range(32))
# The weight pass (dW = A^T @ dout on the same tile, A read transposed out
# of row-major boxes) takes dout pre-split the same way over its N rows, in
# the order WTILE_TDEPTH: column j of wgmma step kk holds depth 8 kk + 2 (j
# % 4) + j // 4, so the four depths a quarter warp reads at once lie in
# k-rows of four swizzle phases, on distinct banks.
WTILE_TDEPTH = tuple(8 * (p // 8) + 2 * (p % 4) + (p % 8) // 4
                     for p in range(32))


def _pad32(k: int) -> int:
    return -(-k // 32) * 32


def presplit_floats(dtype: torch.dtype, k: int, n: int) -> int:
    """float32 values of a [k, n] B in ``dtype`` pre-split for the weight
    tile (k rounded up to 32): two parts in float32, one in bf16."""
    return (2 if dtype == torch.float32 else 1) * _pad32(k) * n


def _slice_order(k: int, order=WTILE_DEPTH) -> torch.Tensor:
    """The depth at each position of K = k (a multiple of 32), slice by
    slice."""
    d = torch.tensor(order)
    return (torch.arange(k) // 32 * 32 + d.repeat(k // 32)).long()


def presplit_plain(w0: torch.Tensor, w1: torch.Tensor | None = None,
                   order=WTILE_DEPTH) -> torch.Tensor:
    """The weight tile's pre-split of B = [w0; w1] ([k0, N] and [k1, N] in
    float32 or bf16) as csrc/wtile.cuh::wsplit_kernel writes it: [parts, N,
    K] float32 (K = k0 + k1 rounded up to 32, depths past k0 + k1 zero),
    part 0 hi = tf32_round(w) and (float32) part 1 lo = tf32_round(w - hi),
    or (bf16) the one part w, each slice's depths in ``order``
    (WTILE_DEPTH; the weight pass's dout WTILE_TDEPTH)."""
    w = (w0 if w1 is None else torch.cat([w0, w1])).float()
    k = _pad32(w.shape[0])
    if k > w.shape[0]:
        w = torch.cat([w, w.new_zeros((k - w.shape[0], w.shape[1]))])
    wt = w[_slice_order(k, order)].t().contiguous()
    if w0.dtype != torch.float32:
        return wt[None]
    hi = tf32_round(wt)
    return torch.stack([hi, tf32_round(wt - hi)])


def presplit_t_plain(w0: torch.Tensor, w1: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """The pre-split of B = [w0^T | w1^T] for weights w0 [n0, K], w1 [n1,
    K] as stored (the backward's dagg | dxp = dout @ [W_l^T | W_r^T]), as
    wsplit_kernel writes it from W's rows: `presplit_plain` of that B."""
    b = w0.t() if w1 is None else torch.cat([w0.t(), w1.t()], 1)
    return presplit_plain(b)


def presplit_tk_plain(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The pre-split of B = [w0^T; w1^T] stacked in depth, for weights w0
    [N, k0], w1 [N, k1] as stored (k0 % 32 == 0; the EA backward's dx =
    [r_de1 | s] @ [W_er^T; W_sp^T]), as wsplit_kernel writes it from W's
    rows: `presplit_plain` of that B."""
    return presplit_plain(w0.t(), w1.t())


def presplit_parts(p: torch.Tensor, order=WTILE_DEPTH) -> torch.Tensor:
    """The pre-split layout mapped back: [parts, K, N] in depth order."""
    inv = torch.argsort(_slice_order(p.shape[2], order))
    return p[:, :, inv].transpose(1, 2)


def weight_tile_plain(a: torch.Tensor, p: torch.Tensor, order=WTILE_DEPTH
                      ) -> torch.Tensor:
    """a @ B (a [M, K] float32 or bf16, ``p`` B's `presplit_plain` in
    ``order``) with the weight tile's arithmetic: a's depths in the same
    order, each 32-deep slice's lo.hi + hi.lo + hi.hi (bf16: hi.hi) summed
    in float64 and rounded to float32 (the tensor cores' slice sum), the
    slices added to float32 sums in order. For tests."""
    k = p.shape[2]
    a = a.float()
    if a.shape[1] < k:
        a = torch.cat([a, a.new_zeros((a.shape[0], k - a.shape[1]))], 1)
    ap = a[:, _slice_order(k, order)]
    ah = tf32_round(ap)
    al = tf32_round(ap - ah)
    out = torch.zeros((a.shape[0], p.shape[1]), dtype=torch.float32)
    for k0 in range(0, k, 32):
        s = slice(k0, k0 + 32)
        bh = p[0, :, s].double().t()
        sl = ah[:, s].double() @ bh
        if p.shape[0] == 2:
            sl = (sl + al[:, s].double() @ bh
                  + ah[:, s].double() @ p[1, :, s].double().t())
        out = out + sl.float()
    return out


def weight_pass_plain(a: torch.Tensor, p: torch.Tensor, kchunk: int
                      ) -> torch.Tensor:
    """a^T @ B (a [rows, M], ``p`` B [rows, N]'s `presplit_plain` in
    WTILE_TDEPTH) as the weight pass computes it: chunks of ``kchunk`` rows
    (a multiple of 32), each chunk's partial on the weight tile's
    arithmetic (`weight_tile_plain`), the partials added to zero in chunk
    order in float32 (sum_parts). For tests."""
    rows = a.shape[0]
    out = torch.zeros((a.shape[1], p.shape[1]), dtype=torch.float32)
    for r0 in range(0, rows, kchunk):
        r1 = min(rows, r0 + kchunk)
        out = out + weight_tile_plain(
            a[r0:r1].t(), p[:, :, r0:r0 + _pad32(r1 - r0)], WTILE_TDEPTH)
    return out


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
