"""Fully fused GraphSAGE layer: forward and backward kernels, and its VJP.

The port of buckgnn_tpu/ops/pallas_sage_layer.py. One forward call computes
the whole shared-SAGE layer (Models/BuckGNN.py:113-119, 338-352):

    agg  = band_t @ x_slab (+ spill window) (+ star selection)  -> x.dtype
    out  = agg @ W_l + x_t @ W_r + b_l           (f32)
    y    = out * rsqrt(max(rowsum(out^2), 1e-24))
    z    = dropout(relu(y) (+ x_t))              -> cast to x.dtype

and, with ``emit``, the next layer's supernode star table summed from z;
with ``save_res`` also the backward's residuals y, inv and agg. The spill
term (out-of-band edges, ops/banded_matmul.py) enters the f32 accumulator
before agg's cast, as on the TPU.

Two backward routes, chosen by the batch as the JAX package does:
- without spill edges, one merged call (`sage_layer_bwd`) computes dx,
  dW_l, dW_r, db_l and the layer's own star table from dz and the
  residuals (csrc/sage_layer_bwd.cu);
- with spill edges, the split backward: `sage_layer_bwd_tile` computes
  dagg, dxp, dW_l, dW_r, db_l and the own table by global codes, then
  `banded_matmul` computes dx = band @ dagg + spill window of dagg + own
  star + dxp.

`sage_layer_fwd`, `sage_layer_bwd` and `sage_layer_bwd_tile` are the
wrappers: on CUDA tensors they launch the hand-written kernels in ``csrc/``
and count each launch in ``LAUNCHES``; on CPU tensors they run the plain
PyTorch versions (`sage_layer_plain`, `sage_layer_bwd_plain`,
`sage_layer_bwd_tile_plain`) with the same casts. Which kernel a CUDA call
launches is ops/banded_matmul.py::kernel_variant's static rule on (dtype,
H): bf16 at H in {128, 256, 512} the product engine's
(``sage_layer_fwd.cu``, ``sage_layer_bwd.cu``), float32 at any H % 128 ==
0 and bf16 at the other widths ``sage_simple.cu``'s (a few launches a
call, the products on ``wtile.cuh``'s 3xTF32 tensor-core tile: the
forward's [agg | x] @ [W_l; W_r] and the backward's dout @ [W_l^T |
W_r^T] from the weights pre-split, and its weight pass [agg | x]^T @ dout
from dout pre-split, into scratch the wrapper allocates), each counted
under its own name (``*_simple``).
`fused_sage_layer` is the layer as the model calls it: a
``torch.autograd.Function`` (the JAX package's ``_fused_layer`` custom
VJP) with supernode-star threading through ghost tables (`star_source`)
on spill-free batches.
"""

from __future__ import annotations

import ctypes

import torch

from buckgnn_tpu_torch.graph.batch import (
    LOCAL_STAR_ROWS, SPILL_CHUNK, star_table_geometry,
)
from buckgnn_tpu_torch.ops import segment
from buckgnn_tpu_torch.ops.banded_matmul import (
    banded_matmul, check_band, check_engine, check_operands, check_spill,
    presplit_floats, slab_starts, spill_term_plain, variant_of,
)
from buckgnn_tpu_torch.ops.dropout import (
    apply_dropout, dropout_scale, dropout_threshold,
)
from buckgnn_tpu_torch.utils.profiling import traced

# launches of each kernel wrapper (reset by callers that count a run): the
# product engine's kernels and, under ``*_simple``, csrc/sage_simple.cu's
LAUNCHES = {"sage_layer_fwd": 0, "sage_layer_bwd": 0,
            "sage_layer_bwd_tile": 0, "banded_matmul": 0,
            "sage_layer_fwd_simple": 0, "sage_layer_bwd_simple": 0,
            "sage_layer_bwd_tile_simple": 0, "banded_matmul_simple": 0}

_BM = 64  # rows per kernel block (csrc/sage_layer_{fwd,bwd}.cu)
_KSPLIT = 16  # row chunks of the backward's weight pass (sage_layer_bwd.cu)

# How close the kernel's outputs must be to the plain version's on the
# same bf16 inputs, as (atol, rtol): |got - ref| <= atol + rtol * |ref|.
# z: both sides sum the same exact bf16 products in f32 in another order,
# so a value can round to the neighbouring bf16 value: one ulp, at most
# 2^-7 = 0.0078 of |z|, inside rtol 8e-3. relu(y) has unit-norm rows, so
# at H = 512 a typical entry is 1/sqrt(512) = 0.044 and the largest about
# 0.2; atol 4e-3 covers their f32 noise and is a tenth of a typical entry.
# A norm off by sqrt(8/7) (7% in y) or a dropped bias fails it.
KERNEL_Z_TOL = (4e-3, 8e-3)
# the emitted table against `emit_table_plain` of the kernel's own z: f32
# sums of the same bf16 values in another order, ~1e-3 for sums of ~1000
# terms of O(1); a dropped or misplaced z row moves entries by |z|.
KERNEL_TABLE_TOL = (1e-2, 1e-4)
# The training variant's residuals against the plain ones: y within the z
# gate (the same rounding of the same f32 values); inv, an f32 rsqrt of an
# f32 sum of 512 squares in another order, to 1e-5 relative; agg is the
# forward's bf16 cast of the band sum, one ulp like z.
KERNEL_INV_TOL = (0.0, 1e-5)

# Backward gates, kernel against `sage_layer_bwd_plain` on the same bf16
# inputs, as (atol as a fraction of rms(ref), rtol):
# |got - ref| <= atol * rms(ref) + rtol * |ref|. Both sides compute the
# same bf16 products with f32 sums in another order, so a bf16 value (dout,
# dagg, dxp, dx) can round to its neighbour: one ulp is at most 2^-7 of
# |dx| (rtol 1.6e-2 takes two: dxp's and dx's), and a flipped dagg moves dx
# rows by a band count times one ulp of dagg, which the atol of 5% of
# rms(dx) covers. The own table sums a graph's bf16 dagg rows (tens to
# hundreds of them), so dagg's flips add up in it the same way: dx's gate.
# dW and db are f32 sums over every row of products of bf16 values in
# which flips are rare and of random sign: 1e-3 relative to their rms.
# A norm backward without its s term, or a dz without the next layer's
# star, moves every row by O(rms) and fails them. The split backward's
# dagg and dxp are bf16 values like dx and take its gate; its own table
# tbwd is summed from bf16 dagg like town.
KERNEL_BWD_TOL = {"dx": (5e-2, 1.6e-2), "dw_l": (1e-3, 1e-3),
                  "dw_r": (1e-3, 1e-3), "db_l": (1e-3, 1e-3),
                  "town": (5e-2, 1.6e-2), "dagg": (5e-2, 1.6e-2),
                  "dxp": (5e-2, 1.6e-2), "tbwd": (5e-2, 1.6e-2)}


def gate_tol(ref: torch.Tensor, tol) -> tuple[float, float]:
    """(atol, rtol) of a KERNEL_BWD_TOL entry for this reference."""
    frac, rtol = tol
    rms = float(ref.float().pow(2).mean().sqrt())
    return frac * rms, rtol


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the passes of each kernel, keys of `pass_flops`: the forward (#1), the
# merged backward (#2: tile, band and weight passes) and the split
# backward's tile kernel (#3: tile and weight passes)
FWD_PASSES = ("fwd",)
BWD_PASSES = ("bwd_tile", "bwd_band", "bwd_weights")
TILE_PASSES = ("tile", "tile_weights")


def pass_flops(n: int, h: int, tile: int, width: int, gw: int, *,
               has_super: bool = False, emit: bool = False,
               apply_prev: bool = False, tg: int = 0) -> dict[str, int]:
    """Operations (two per multiply-add) of the products each kernel pass
    runs on ``n`` rows at width ``h``, keyed by `FWD_PASSES`, `BWD_PASSES`
    and `TILE_PASSES`, counted as the TPU kernels multiply: the band as a
    dense [T, T+W] operand, the star selections (2*GW one-hot columns;
    ``has_super``), the emitted and own tables as one-hot products by
    accumulate code, the split tile kernel's own table over the whole
    [tg, H] table (``tg`` > 0 with ``has_super``). The spill term is not a
    product here: its run sums are f32 adds."""
    hh = h * h
    star = 2 * n * 2 * gw * h if has_super else 0
    band = 2 * n * (tile + width) * h
    return {
        # [band | sel] @ [slab ; window], [agg | x] @ [W_l ; W_r], emit
        "fwd": band + star + 4 * n * hh + (star if emit else 0),
        # dout @ W_r^T, dout @ W_l^T, the own table (and the next layer's
        # star on dz)
        "bwd_tile": 4 * n * hh + star + (star if apply_prev else 0),
        "bwd_band": band,  # band @ dagg slab
        "bwd_weights": 4 * n * hh,  # agg^T dout, x^T dout
        "tile": 4 * n * hh + (2 * n * tg * h if has_super else 0),
        "tile_weights": 4 * n * hh,
    }


def _window_rows(gwin, gw: int, t0: int, n_tiles: int, device):
    """[n_tiles, 2*GW] table rows of each tile's star window: wb.. and
    T0+wb.. (gwin None: the whole table, GW == T0, wb == 0)."""
    wb = (torch.zeros(n_tiles, dtype=torch.long, device=device)
          if gwin is None else gwin.long())
    ar = torch.arange(gw, device=device)
    return torch.cat([wb[:, None] + ar, t0 + wb[:, None] + ar], dim=1)


def _check_dropout(rate: float, seed) -> None:
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs two seed words")


def sage_layer_plain(x, w_l, b_l, w_r, band, *, tile: int, width: int,
                     table=None, code=None, gwin=None, gw: int = 0,
                     t0: int = 0, acc_code=None, skip: bool = False,
                     emit: bool = False, save_res: bool = False,
                     rate: float = 0.0, seed=None, spill_offsets=None,
                     spill_lo=None, spill_hi=None, spill_messages=None):
    """Plain PyTorch version of the fused layer, operation by operation as
    the TPU kernel: products of x.dtype values accumulated in float32.

    ``band``: [n_tiles, T, T+W] int8 counts. ``table``: [tg, H] star table
    or None (no supernode). ``code``: per-row selector over the 2*GW window
    rows ([n_tiles, T] or [n_tiles, T, 1]; 2*GW selects nothing). ``gwin``:
    [n_tiles] window bases, or None for the whole table (GW == T0).
    ``acc_code``: per-row accumulate codes for ``emit``. ``rate`` > 0 drops
    with the keep mask of ``seed`` (ops/dropout.py). ``spill_offsets``,
    ``spill_lo``, ``spill_hi`` and ``spill_messages`` (x[spill_senders])
    add the spill window (ops/banded_matmul.py) to the accumulator before
    agg's cast. Returns ``(z, ftab)``; ftab is the [tg, H] float32
    next-layer table or None. With ``save_res`` returns
    ``(z, ftab, y, inv, agg)``: y and agg in x.dtype, inv float32 [N].
    """
    _check_dropout(rate, seed)
    n, h = x.shape
    n_tiles = n // tile
    dt = x.dtype
    acc = band_product_plain(x, band, tile=tile, width=width).reshape(
        n_tiles, tile, h)
    if spill_offsets is not None:
        acc = acc + spill_term_plain(spill_messages, spill_offsets, spill_lo,
                                     spill_hi, n_tiles, tile, dt)
    rows = None
    if table is not None:
        rows = _window_rows(gwin, gw, t0, n_tiles, x.device)
        ltab = table[rows].to(dt).float()                 # [n_tiles, 2GW, H]
        sel = (code.reshape(n_tiles, tile, 1)
               == torch.arange(2 * gw, device=x.device)).to(dt).float()
        acc = acc + torch.bmm(sel, ltab)
    agg = acc.reshape(n, h).to(dt)
    out = (agg.float() @ w_l.float() + x.float() @ w_r.float()
           + b_l.reshape(1, h).float())
    sq = (out * out).sum(dim=-1, keepdim=True)
    inv = torch.rsqrt(sq.clamp_min(1e-24))
    y = out * inv
    r = torch.relu(y)
    if skip:
        r = r + x.float()
    if rate > 0.0:
        r = apply_dropout(r, seed, rate)
    z = r.to(dt)
    ftab = None
    if emit:
        ftab = emit_table_plain(z, acc_code, gwin, gw, t0, tile)
    if save_res:
        return z, ftab, y.to(dt), inv.reshape(n), agg
    return z, ftab


def emit_table_plain(z, acc_code, gwin, gw: int, t0: int, tile: int):
    """The next layer's [2*T0, H] float32 star table: each tile's z rows
    summed by their accumulate code (2*GW sums none) into its window's
    table rows."""
    n, h = z.shape
    n_tiles = n // tile
    rows = _window_rows(gwin, gw, t0, n_tiles, z.device)
    sela = (acc_code.reshape(n_tiles, 1, tile)
            == torch.arange(2 * gw, device=z.device)[:, None]).float()
    tb = torch.bmm(sela, z.float().reshape(n_tiles, tile, h))
    ftab = torch.zeros((2 * t0, h), dtype=torch.float32, device=z.device)
    ftab.index_add_(0, rows.reshape(-1), tb.reshape(-1, h))
    return ftab


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused SAGE layer kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _dropout_args(rate: float, seed):
    if rate <= 0.0:
        return 0, 0, 0, 0, 1.0
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return 1, dropout_threshold(rate), s0, s1, dropout_scale(rate)


def _star_checks(x, tile, table, code, gwin, gw, t0) -> None:
    """The star operands' shapes (``table`` given): [2*T0, H], a code a
    row, a window base a tile or the whole table (GW == T0)."""
    n, h = x.shape
    _check(tuple(table.shape) == (2 * t0, h), "table [2*T0, H]")
    _check(code.numel() == n, "one code per row")
    _check(gwin is None or gwin.numel() == n // tile, "gwin [N/T]")
    _check(gwin is not None or gw == t0, "full-table selection: GW == T0")


def _launch(x, w_l, b_l, w_r, band, *, tile, width, table, code, gwin, gw,
            t0, acc_code, skip, emit, save_res, rate, seed, spill_offsets,
            spill_lo, spill_hi, spill_messages):
    """The checks every variant shares, then the variant's kernel:
    csrc/sage_layer_fwd.cu (engine) or sage_simple.cu::sage_fwd_simple
    (#1's float32 / any-width variant: phase 1 (agg), the product pass into
    an f32 [N, H] scratch, the row epilogue and, with emit, the table
    sums)."""
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    engine = variant_of(x, _check) == "engine"
    n, h = x.shape
    has_super = table is not None
    has_spill = spill_offsets is not None
    floats = [x, w_l, b_l, w_r] + ([table] if has_super else []) + (
        [spill_messages] if has_spill else [])
    ints = ([code] if has_super else []) + (
        [gwin] if gwin is not None else []) + ([acc_code] if emit else []) + (
        [spill_offsets, spill_lo, spill_hi] if has_spill else [])
    check_operands(floats, ints, band, x, _check)
    check_band(band, n, tile, width, _check)
    _check(tuple(w_l.shape) == (h, h) and tuple(w_r.shape) == (h, h)
           and b_l.numel() == h, "W_l, W_r [H, H] and b_l [H]")
    tg = 2 * t0
    if has_super:
        _star_checks(x, tile, table, code, gwin, gw, t0)
    if emit:
        _check(has_super and gwin is not None, "emit needs the local star "
               "windows")
        _check(acc_code.numel() == n, "one accumulate code per row")
    n_spill = 0
    if has_spill:
        n_spill = check_spill(spill_offsets, spill_lo, spill_hi,
                              spill_messages, n, tile, _check)
    if engine:
        check_engine(floats, band, tile, width, _check)
        _check(not has_super or ((2 * gw) % 16 == 0
                                 and (gw % 16 == 0 or gw == t0)),
               "star window of whole 16-row fragments")
        _check(not emit or gw <= LOCAL_STAR_ROWS,
               "emit needs the local star windows")

    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty_like(x)
    y = inv = agg = partial = ftab = None
    if save_res:
        y, inv = torch.empty_like(x), torch.empty((n,), **f32)
    if save_res or not engine:
        agg = torch.empty_like(x)
    if emit:
        partial = torch.empty((n // _BM, 2 * gw, h), **f32)
        ftab = torch.empty((tg, h), **f32)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    operands = (_ptr(x), _ptr(band), _ptr(w_l), _ptr(w_r), _ptr(b_l),
                _ptr(table), _ptr(code), _ptr(gwin), _ptr(acc_code),
                _ptr(spill_messages), _ptr(spill_offsets), _ptr(spill_lo),
                _ptr(spill_hi))
    dropout = (drop, thr, s0, s1, scale)
    if engine:
        name = "sage_layer_fwd"
        fn = cuda_build.load(name).sage_layer_fwd
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 14
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        args = operands + (
            _ptr(z), _ptr(partial), _ptr(ftab), _ptr(y), _ptr(inv),
            _ptr(agg), n, h, tile, width, gw, t0, tg, int(has_super),
            int(skip), int(emit), int(save_res), n_spill,
            int(has_spill)) + dropout
    else:
        name = "sage_fwd_simple"
        out32 = torch.empty((n, h), **f32)
        # [W_l; W_r] pre-split for the weight tile (csrc/wtile.cuh)
        wsplit = torch.empty((presplit_floats(x.dtype, 2 * h, h),), **f32)
        fn = cuda_build.load("sage_simple").sage_fwd_simple
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 13
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        args = operands + (
            _ptr(agg), _ptr(out32), _ptr(z), _ptr(y), _ptr(inv),
            _ptr(partial), _ptr(ftab), _ptr(wsplit), n, h, tile, width, gw,
            t0, tg,
            int(has_super), int(skip), int(emit), n_spill,
            int(has_spill)) + dropout + (int(x.dtype == torch.bfloat16),)
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    cuda_build.count_launch(
        LAUNCHES, "sage_layer_fwd" if engine else "sage_layer_fwd_simple")
    if save_res:
        return z, ftab, y, inv, agg
    return z, ftab


def sage_layer_fwd(x, w_l, b_l, w_r, band, *, tile: int, width: int,
                   table=None, code=None, gwin=None, gw: int = 0,
                   t0: int = 0, acc_code=None, skip: bool = False,
                   emit: bool = False, save_res: bool = False,
                   rate: float = 0.0, seed=None, spill_offsets=None,
                   spill_lo=None, spill_hi=None, spill_messages=None):
    """The fused layer (arguments and results as `sage_layer_plain`). CUDA
    tensors launch the kernel of `kernel_variant` (or raise); CPU tensors
    take the plain version."""
    kw = dict(tile=tile, width=width, table=table, code=code, gwin=gwin,
              gw=gw, t0=t0, acc_code=acc_code, skip=skip, emit=emit,
              save_res=save_res, rate=rate, seed=seed,
              spill_offsets=spill_offsets, spill_lo=spill_lo,
              spill_hi=spill_hi, spill_messages=spill_messages)
    if x.device.type == "cuda":
        return _launch(x, w_l, b_l, w_r, band, **kw)
    if x.device.type == "cpu":
        return sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    raise ValueError(f"sage_layer_fwd: unsupported device {x.device}")


def band_product_plain(x, band, *, tile: int, width: int):
    """[N, H] float32 band_t @ x[s_t : s_t+T+W] of every tile: the forward's
    phase 1 without star or spill (the band as x.dtype counts)."""
    n, h = x.shape
    n_tiles = n // tile
    starts = slab_starts(n, tile, width, x.device)
    xs = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    b = band.reshape(n_tiles, tile, tile + width).to(x.dtype).float()
    return torch.bmm(b, xs.float()).reshape(n, h)


def sage_layer_bwd_plain(dz, y, inv, agg, x, w_l, w_r, band, *, tile: int,
                         width: int, table_prev=None, code=None, gwin=None,
                         gw: int = 0, t0: int = 0, acc_code=None,
                         has_super: bool = False, skip: bool = False,
                         rate: float = 0.0, seed=None):
    """Plain PyTorch version of the merged backward, step by step as the
    TPU kernel (_bwd_merged_kernel) with its casts.

    ``dz``: cotangent of z. ``y``, ``inv``, ``agg``: the forward's
    residuals. ``table_prev``: the next layer's deferred star table in
    x.dtype (apply_prev), added at ``code`` before the dropout mask.
    ``acc_code``: accumulate codes of the own star table (``has_super``).
    Returns ``(dx, dW_l, dW_r, db_l, town)``: dx in x.dtype, the rest
    float32; town is the [2*T0, H] own table or None. dx leaves the own
    star out: it goes to the previous layer through town.
    """
    _check_dropout(rate, seed)
    n, h = x.shape
    n_tiles = n // tile
    dt = x.dtype
    dz_eff = dz.float()
    if table_prev is not None:
        rows = _window_rows(gwin, gw, t0, n_tiles, x.device)
        ltab = table_prev.to(dt)[rows].float()           # [n_tiles, 2GW, H]
        sel = (code.reshape(n_tiles, tile, 1)
               == torch.arange(2 * gw, device=x.device)).to(dt).float()
        dz_eff = dz_eff + torch.bmm(sel, ltab).reshape(n, h)
    if rate > 0.0:
        dz_eff = apply_dropout(dz_eff, seed, rate)
    dagg, dxp, dwl, dwr, dbl = _tile_grads(dz_eff, y, inv, agg, x, w_l, w_r,
                                           skip)
    town = (emit_table_plain(dagg, acc_code, gwin, gw, t0, tile)
            if has_super else None)
    starts = slab_starts(n, tile, width, x.device)
    idx = starts[:, None] + torch.arange(tile + width, device=x.device)
    b = band.reshape(n_tiles, tile, tile + width).to(dt).float()
    dx = (dxp.float() + torch.bmm(b, dagg[idx].float()).reshape(n, h)).to(dt)
    return dx, dwl, dwr, dbl, town


def _tile_grads(dz_eff, y, inv, agg, x, w_l, w_r, skip: bool):
    """The backward's per-row math from the masked float32 dz_eff, with the
    TPU kernel's casts: (dagg, dxp) in x.dtype, (dW_l, dW_r, db_l) float32."""
    n = x.shape[0]
    dt = x.dtype
    dout = _norm_backward(dz_eff, y.float(), inv.reshape(n, 1))
    dout_c = dout.to(dt).float()
    dagg = (dout_c @ w_l.float().t()).to(dt)
    dxp = dout_c @ w_r.float().t()
    if skip:
        dxp = dxp + dz_eff
    dxp = dxp.to(dt)
    dwl = agg.float().t() @ dout_c
    dwr = x.float().t() @ dout_c
    dbl = dout.sum(dim=0)
    return dagg, dxp, dwl, dwr, dbl


def sage_layer_bwd_tile_plain(dz, y, inv, agg, x, w_l, w_r, *, tile: int,
                              skip: bool = False, rate: float = 0.0,
                              seed=None, acc_code=None, tg: int = 0):
    """Plain PyTorch version of the split backward's tile kernel
    (_bwd_kernel) with its casts: the dropout mask on dz, the relu and norm
    backward, ``dagg = dout @ W_l^T`` and ``dxp = dout @ W_r^T (+ dz)``.
    ``acc_code``: the global accumulate codes ([n_tiles, 1, T], tg sums
    none) of a supernode batch. Returns ``(dagg, dxp, dW_l, dW_r, db_l,
    tbwd)``: dagg and dxp in x.dtype, the rest float32; tbwd is the [tg, H]
    own star table summed from x.dtype dagg, or None without ``acc_code``.
    """
    _check_dropout(rate, seed)
    dz_eff = dz.float()
    if rate > 0.0:
        dz_eff = apply_dropout(dz_eff, seed, rate)
    dagg, dxp, dwl, dwr, dbl = _tile_grads(dz_eff, y, inv, agg, x, w_l, w_r,
                                           skip)
    tbwd = None
    if acc_code is not None:
        t0 = tg // 2  # the whole table: GW == T0, one window at base 0
        tbwd = emit_table_plain(dagg, acc_code, None, t0, t0, tile)
    return dagg, dxp, dwl, dwr, dbl, tbwd


def _norm_backward(dz_eff, y, inv):
    """The cotangent of out through relu and the L2 norm, in float32: dy =
    dz_eff where y > 0; dout = (dy - y * rowsum(dy * y)) * inv."""
    dy = torch.where(y > 0.0, dz_eff, torch.zeros((), device=y.device))
    s = (dy * y).sum(dim=-1, keepdim=True)
    return (dy - y * s) * inv


def _launch_bwd(dz, y, inv, agg, x, w_l, w_r, band, *, tile, width,
                table_prev, code, gwin, gw, t0, acc_code, has_super, skip,
                rate, seed):
    """The checks every variant shares, then the variant's kernel:
    csrc/sage_layer_bwd.cu (engine) or sage_simple.cu::sage_bwd_simple
    (#2's float32 / any-width variant: the norm backward's row pass, the
    dagg / dxp products, the split-K dW products, db, the own table and the
    band pass for dx)."""
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    engine = variant_of(x, _check) == "engine"
    n, h = x.shape
    apply_prev = table_prev is not None
    floats = [dz, y, agg, x, w_l, w_r] + ([table_prev] if apply_prev else [])
    ints = (([code] if apply_prev else []) + ([acc_code] if has_super else [])
            + ([gwin] if gwin is not None else []))
    _bwd_operand_checks(dz, y, inv, agg, x, w_l, w_r, floats, ints, band)
    check_band(band, n, tile, width, _check)
    tg = 2 * t0
    if has_super:
        _check(gwin is None or gwin.numel() == n // tile, "gwin [N/T]")
        _check(gwin is not None or gw == t0, "full-table selection: GW == T0")
        _check(acc_code.numel() == n, "one accumulate code per row")
    if apply_prev:
        _check(has_super, "apply_prev needs a supernode batch")
        _star_checks(x, tile, table_prev, code, gwin, gw, t0)
    if not engine:
        _, _, dx, dwl, dwr, dbl, town = _simple_bwd_call(
            dz, y, inv, agg, x, w_l, w_r, band, tile=tile, width=width,
            table_prev=table_prev, code=code, gwin=gwin, gw=gw, t0=t0, tg=tg,
            acc_code=acc_code if has_super else None, ncode=2 * gw,
            skip=skip, rate=rate, seed=seed)
        cuda_build.count_launch(LAUNCHES, "sage_layer_bwd_simple")
        return dx, dwl, dwr, dbl, town
    check_engine(floats, band, tile, width, _check)
    _check(n // tile >= 2, "at least 2 node tiles")

    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dout, dagg, dxp, dx = (torch.empty_like(x) for _ in range(4))
    db_part = torch.empty((n // _BM, h), **f32)
    dw_part = torch.empty((2, _KSPLIT, h, h), **f32)
    dwl, dwr = torch.empty((h, h), **f32), torch.empty((h, h), **f32)
    dbl = torch.empty((h,), **f32)
    t_part = town = None
    if has_super:
        t_part = torch.empty((n // _BM, 2 * gw, h), **f32)
        town = torch.empty((tg, h), **f32)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    lib = cuda_build.load("sage_layer_bwd")
    fn = lib.sage_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 11
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(dz), _ptr(y), _ptr(inv), _ptr(agg), _ptr(x), _ptr(w_l),
             _ptr(w_r), _ptr(band), _ptr(table_prev), _ptr(code), _ptr(gwin),
             _ptr(acc_code), _ptr(dout), _ptr(dagg), _ptr(dxp), _ptr(dx),
             _ptr(db_part), _ptr(t_part), _ptr(dw_part), _ptr(dwl),
             _ptr(dwr), _ptr(dbl), _ptr(town), n, h, tile, width, gw, t0, tg,
             int(apply_prev), int(has_super), int(skip), drop, thr, s0, s1,
             scale, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sage_layer_bwd launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "sage_layer_bwd")
    return dx, dwl, dwr, dbl, town


def _ksplit(n: int, h: int) -> int:
    """Row chunks of the simple backward's weight pass, [dW_l; dW_r] =
    [agg | x]^T @ dout on csrc/wtile.cuh's tile (A read transposed): its
    work items, a chunk times one of the (2H / 128) x (H / 128) tiles of
    [dW_l; dW_r], are walked by one persistent block an SM, so at least two
    items an SM on 132 SMs; and chunks of at most 2,048 rows, whose f32 sums
    of 32-deep slice sums stay within the float32 gate (the tensor cores'
    own sums are not rounded to nearest; at 34,500-row chunks dW's error
    reached 7.7e-6 of max|dW| at H 1024 on an H100); at most 64 chunks, none
    under 64 rows."""
    tiles = 2 * (h // 128) ** 2
    return max(1, min(64, max(-(-264 // tiles), -(-n // 2048)), n // _BM))


def _simple_bwd_call(dz, y, inv, agg, x, w_l, w_r, band, *, tile, width,
                     table_prev, code, gwin, gw, t0, tg, acc_code, ncode, skip,
                     rate, seed):
    """One call of sage_simple.cu::sage_bwd_simple, the merged backward
    with ``band``, the split backward's tile kernel without: (dagg, dxp,
    dx, dW_l, dW_r, db_l, own table); dx None without band, the table None
    without ``acc_code`` (``ncode`` codes a 64-row block). Its scratch:
    [W_l^T | W_r^T] and dout pre-split for the weight tile, [dW_l; dW_r]'s
    chunk partials, db's and the table's partials."""
    from buckgnn_tpu_torch.utils import cuda_build

    n, h = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dout, dagg, dxp = (torch.empty_like(x) for _ in range(3))
    dx = torch.empty_like(x) if band is not None else None
    dout32 = torch.empty((n, h), **f32) if x.dtype != torch.float32 else None
    dzeff = torch.empty((n, h), **f32) if skip else None
    wsplit = torch.empty((presplit_floats(x.dtype, h, 2 * h),), **f32)
    dsplit = torch.empty((presplit_floats(x.dtype, n, h),), **f32)
    ksplit = _ksplit(n, h)
    dw_part = torch.empty((2, ksplit, h, h), **f32)
    dwl, dwr = torch.empty((h, h), **f32), torch.empty((h, h), **f32)
    db_part = torch.empty((-(-n // 256), h), **f32)
    dbl = torch.empty((h,), **f32)
    t_part = town = None
    if acc_code is not None:
        t_part = torch.empty((n // _BM, ncode, h), **f32)
        town = torch.empty((tg, h), **f32)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    fn = cuda_build.load("sage_simple").sage_bwd_simple
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 11
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(dz), _ptr(y), _ptr(inv), _ptr(agg), _ptr(x), _ptr(w_l),
             _ptr(w_r), _ptr(band), _ptr(table_prev), _ptr(code), _ptr(gwin),
             _ptr(acc_code), _ptr(dout), _ptr(dout32), _ptr(dzeff),
             _ptr(dagg), _ptr(dxp), _ptr(dx), _ptr(dw_part), _ptr(dwl),
             _ptr(dwr), _ptr(db_part), _ptr(dbl), _ptr(t_part), _ptr(town),
             _ptr(wsplit), _ptr(dsplit), n, h, tile, width, gw, t0, tg,
             int(acc_code is not None), int(skip), ksplit, drop, thr, s0, s1,
             scale, int(x.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sage_bwd_simple launch failed: CUDA error {err}")
    return dagg, dxp, dx, dwl, dwr, dbl, town


def _bwd_operand_checks(dz, y, inv, agg, x, w_l, w_r, floats, ints, band):
    n, h = x.shape
    check_operands(floats, ints, band, x, _check)
    _check(inv.device == x.device and inv.is_contiguous(),
           "all tensors on one CUDA device, contiguous")
    _check(inv.dtype == torch.float32 and inv.numel() == n, "inv f32 [N]")
    for t in (dz, y, agg):
        _check(tuple(t.shape) == (n, h), "dz, y, agg [N, H]")
    _check(tuple(w_l.shape) == (h, h) and tuple(w_r.shape) == (h, h),
           "W_l, W_r [H, H]")


def sage_layer_bwd(dz, y, inv, agg, x, w_l, w_r, band, *, tile: int,
                   width: int, table_prev=None, code=None, gwin=None,
                   gw: int = 0, t0: int = 0, acc_code=None,
                   has_super: bool = False, skip: bool = False,
                   rate: float = 0.0, seed=None):
    """The merged backward (arguments and results as
    `sage_layer_bwd_plain`). CUDA tensors launch the kernel of
    `kernel_variant` (or raise); CPU tensors take the plain version."""
    kw = dict(tile=tile, width=width, table_prev=table_prev, code=code,
              gwin=gwin, gw=gw, t0=t0, acc_code=acc_code,
              has_super=has_super, skip=skip, rate=rate, seed=seed)
    if x.device.type == "cuda":
        return _launch_bwd(dz, y, inv, agg, x, w_l, w_r, band, **kw)
    if x.device.type == "cpu":
        return sage_layer_bwd_plain(dz, y, inv, agg, x, w_l, w_r, band, **kw)
    raise ValueError(f"sage_layer_bwd: unsupported device {x.device}")


def _launch_bwd_tile(dz, y, inv, agg, x, w_l, w_r, *, tile, skip, rate, seed,
                     acc_code, tg):
    """The checks every variant shares, then the variant's kernel:
    csrc/sage_layer_bwd.cu::sage_layer_bwd_tile (engine) or
    sage_simple.cu::sage_bwd_simple without a band (#3's float32 /
    any-width variant: #2's passes but the band pass, the own table over
    the whole [tg, H] table by global codes)."""
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    engine = variant_of(x, _check) == "engine"
    n, h = x.shape
    has_super = acc_code is not None
    floats = [dz, y, agg, x, w_l, w_r]
    _bwd_operand_checks(dz, y, inv, agg, x, w_l, w_r, floats,
                        [acc_code] if has_super else [], None)
    _check(tile % _BM == 0 and n % tile == 0, "tile % 64 == 0, N % tile == 0")
    if has_super:
        _check(acc_code.numel() == n, "one int32 accumulate code per row")
        _check(tg > 0 and tg % 2 == 0, "tg = 2 * T0")
    if not engine:
        dagg, dxp, _, dwl, dwr, dbl, tbwd = _simple_bwd_call(
            dz, y, inv, agg, x, w_l, w_r, None, tile=tile, width=0,
            table_prev=None, code=None, gwin=None, gw=tg // 2, t0=tg // 2,
            tg=tg, acc_code=acc_code, ncode=tg, skip=skip, rate=rate,
            seed=seed)
        cuda_build.count_launch(LAUNCHES, "sage_layer_bwd_tile_simple")
        return dagg, dxp, dwl, dwr, dbl, tbwd
    check_engine(floats, None, tile, 0, _check)

    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dout, dagg, dxp = (torch.empty_like(x) for _ in range(3))
    db_part = torch.empty((n // _BM, h), **f32)
    dw_part = torch.empty((2, _KSPLIT, h, h), **f32)
    dwl, dwr = torch.empty((h, h), **f32), torch.empty((h, h), **f32)
    dbl = torch.empty((h,), **f32)
    t_part = tbwd = None
    if has_super:
        # per-block partials over the whole table (global codes): [N/64,
        # tg, H] f32, a cost that only supernode batches with spill pay
        t_part = torch.empty((n // _BM, tg, h), **f32)
        tbwd = torch.empty((tg, h), **f32)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    lib = cuda_build.load("sage_layer_bwd")
    fn = lib.sage_layer_bwd_tile
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(dz), _ptr(y), _ptr(inv), _ptr(agg), _ptr(x), _ptr(w_l),
             _ptr(w_r), _ptr(acc_code), _ptr(dout), _ptr(dagg), _ptr(dxp),
             _ptr(db_part), _ptr(t_part), _ptr(dw_part), _ptr(dwl),
             _ptr(dwr), _ptr(dbl), _ptr(tbwd), n, h, tile, tg,
             int(has_super), int(skip), drop, thr, s0, s1, scale,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"sage_layer_bwd_tile launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "sage_layer_bwd_tile")
    return dagg, dxp, dwl, dwr, dbl, tbwd


def sage_layer_bwd_tile(dz, y, inv, agg, x, w_l, w_r, *, tile: int,
                        skip: bool = False, rate: float = 0.0, seed=None,
                        acc_code=None, tg: int = 0):
    """The split backward's tile kernel (arguments and results as
    `sage_layer_bwd_tile_plain`). CUDA tensors launch the kernel of
    `kernel_variant` (or raise); CPU tensors take the plain version."""
    kw = dict(tile=tile, skip=skip, rate=rate, seed=seed, acc_code=acc_code,
              tg=tg)
    if x.device.type == "cuda":
        return _launch_bwd_tile(dz, y, inv, agg, x, w_l, w_r, **kw)
    if x.device.type == "cpu":
        return sage_layer_bwd_tile_plain(dz, y, inv, agg, x, w_l, w_r, **kw)
    raise ValueError(f"sage_layer_bwd_tile: unsupported device {x.device}")


def supports_fused_layer(ctx, x, aggr: str, normalize: bool) -> bool:
    """Static eligibility of the fused layer for this batch/config (a
    banded_pallas context)."""
    if ctx is None or ctx.band is None or not ctx.use_pallas:
        return False
    return (
        aggr in ("add", "sum")
        and normalize
        and x.shape[-1] % 128 == 0
        and not ctx.batch.has_spill2_edges
    )


def _super_tables(x, node_graph, node_mask, sn, g_cap, tg):
    """Per-graph star correction table [tg, H]: rows [0, G) the graph's
    supernode features, rows [T0, T0+G) graph_sum - supernode features,
    zero rows for graphs without a supernode and in the alignment gaps."""
    t0 = tg // 2
    gsum = segment.segment_sum_dense(x, node_graph, g_cap, keep=node_mask)
    xsn = x[sn.long()]
    has_super = (sn < x.shape[0] - 1).to(x.dtype)[:, None]
    t1 = xsn * has_super
    t2 = (gsum - xsn) * has_super
    gap = torch.zeros((t0 - g_cap, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([t1, gap, t2, gap], dim=0)


def star_codes(batch):
    """(code, gwin, gw, acc) of a supernode batch: the local windows when
    the batch carries them, else the full-table codes (GW == T0)."""
    t0, _ = star_table_geometry(batch.n_graph_cap)
    if batch.gwin is not None:
        return (batch.lcode, batch.gwin, min(LOCAL_STAR_ROWS, t0),
                batch.lacc)
    return batch.gcode, None, t0, batch.gacc


def star_apply(ct, table, gcode_flat, tg: int):
    """ct + table[gcode] in ct's dtype (the JAX package's `_star_apply`,
    its one-hot product written as the gather it equals); the sentinel code
    tg adds nothing."""
    t = torch.cat([table.to(ct.dtype),
                   table.new_zeros((1, table.shape[1]), dtype=ct.dtype)])
    return ct + t[gcode_flat.long()]


class _StarSource(torch.autograd.Function):
    """Opens a star-threading chain at the encoder boundary: forward is
    (x, zeros [tg, H] float32); backward folds the ghost's cotangent (the
    first fused layer's deferred star table) into dx."""

    @staticmethod
    def forward(ctx, x, gcode_flat, tg):
        ctx.gcode_flat, ctx.tg, ctx.dtype = gcode_flat, tg, x.dtype
        ctx.set_materialize_grads(False)
        return x.view_as(x), x.new_zeros((tg, x.shape[1]),
                                         dtype=torch.float32)

    @staticmethod
    def backward(ctx, dx, dt):
        if dt is None:
            return dx, None, None
        if dx is None:
            dx = dt.new_zeros((ctx.gcode_flat.numel(), dt.shape[1]),
                              dtype=ctx.dtype)
        return star_apply(dx, dt, ctx.gcode_flat, ctx.tg), None, None


def star_source(x, ctx):
    """``(x, t0)``: t0 is a ghost [tg, H] zeros whose cotangent, the first
    fused layer's deferred star table, is added to x's gradient at the
    batch's global codes (`star_apply`)."""
    batch = ctx.batch
    _, tg = star_table_geometry(batch.n_graph_cap)
    return _StarSource.apply(x, batch.gcode.reshape(-1), tg)


def _spill_kw(spill, msgs):
    """The banded/forward kernels' spill operands for messages ``msgs``
    (rows of x or of dagg at the spill senders)."""
    return dict(spill_offsets=spill["offsets"], spill_lo=spill["lo"],
                spill_hi=spill["hi"], spill_messages=msgs)


def _layer_fwd(x, w_l, b_l, w_r, spec, save_res: bool = False):
    """The forward kernel with the spec's operands; the spill messages are
    gathered from x here (XLA glue in the JAX package)."""
    fwd = spec["fwd"]
    if spec["spill"] is not None:
        fwd = dict(fwd, **_spill_kw(spec["spill"], x[spec["spill"]["s"]]))
    return sage_layer_fwd(x, w_l, b_l, w_r, spec["band"], save_res=save_res,
                          **fwd)


class _FusedLayer(torch.autograd.Function):
    """The fused layer with its custom backward (the JAX package's
    ``_fused_layer`` custom VJP).

    Differentiable inputs: x, w_l, b_l, w_r and the ghost ``t_in``. Outputs
    ``(z, t_out, ftab)``: ``t_out`` is a ghost zeros table whose cotangent
    is the next layer's deferred star table (added to dz at the star codes
    before the mask when ``apply_prev``); ``t_in``'s cotangent is this
    layer's own star table. Without threading (``t_in`` None) the own star
    is folded into dx here. ``ftab`` (the next layer's forward table) and
    the star ``table`` (built from x outside, or threaded) carry zero
    cotangent by declaration: the symmetric star operator's whole gradient
    already arrives through the own table.

    A batch without spill edges takes the merged backward
    (`sage_layer_bwd`). One with spill edges takes the split backward
    (JAX _fused_layer_bwd, has_spill branch): `sage_layer_bwd_tile`, then
    `banded_matmul` of dagg with the spill window of dagg[spill_s], the own
    star table by global codes and dxp added; nothing is deferred, so
    ``t_in``'s cotangent is None.
    """

    @staticmethod
    def forward(ctx, x, w_l, b_l, w_r, t_in, spec):
        z, ftab, y, inv, agg = _layer_fwd(x, w_l, b_l, w_r, spec,
                                          save_res=True)
        ctx.save_for_backward(x, w_l, w_r, y, inv, agg)
        ctx.spec = spec
        ctx.b_dtype = b_l.dtype
        ctx.thread = t_in is not None
        ctx.set_materialize_grads(False)
        t_out = x.new_zeros((spec["tg"], x.shape[1]), dtype=torch.float32)
        if ftab is None:
            ftab = x.new_zeros((0,), dtype=torch.float32)
        ctx.mark_non_differentiable(ftab)
        return z, t_out, ftab

    @staticmethod
    @traced("sage.bwd")
    def backward(ctx, dz, dt_out, _dftab):
        x, w_l, w_r, y, inv, agg = ctx.saved_tensors
        spec = ctx.spec
        dz = torch.zeros_like(x) if dz is None else dz.contiguous()
        if spec["spill"] is not None:
            dx, dwl, dwr, dbl = _split_backward(dz, dt_out, y, inv, agg, x,
                                                w_l, w_r, spec)
            dt_in = None
        else:
            dx, dwl, dwr, dbl, dt_in = _merged_backward(
                dz, dt_out, y, inv, agg, x, w_l, w_r, spec, ctx.thread)
        return (dx, dwl.to(w_l.dtype), dbl.to(ctx.b_dtype),
                dwr.to(w_r.dtype), dt_in, None)


def _merged_backward(dz, dt_out, y, inv, agg, x, w_l, w_r, spec, thread):
    """dx, dW_l, dW_r, db_l and t_in's cotangent of a spill-free batch: one
    merged call; the own star table leaves through t_in when threaded, else
    it is folded into dx here."""
    table_prev = None
    if spec["apply_prev"]:
        if dt_out is None:
            dt_out = x.new_zeros((spec["tg"], x.shape[1]))
        table_prev = dt_out.to(x.dtype).contiguous()
    dx, dwl, dwr, dbl, town = sage_layer_bwd(
        dz, y, inv, agg, x, w_l, w_r, spec["band"],
        table_prev=table_prev, **spec["bwd"])
    dt_in = None
    if town is not None:
        if thread:
            dt_in = town
        else:
            dx = star_apply(dx, town, spec["gcode"].reshape(-1), spec["tg"])
    return dx, dwl, dwr, dbl, dt_in


def _split_backward(dz, dt_out, y, inv, agg, x, w_l, w_r, spec):
    """dx, dW_l, dW_r, db_l of a spill batch (pallas_sage_layer.py:
    1203-1227): the next layer's table enters dz by `star_apply` (a zeros
    table adds nothing), then the tile kernel and the banded SpMM."""
    if spec["apply_prev"] and dt_out is not None:
        dz = star_apply(dz, dt_out, spec["gcode"].reshape(-1), spec["tg"])
    dagg, dxp, dwl, dwr, dbl, tbwd = sage_layer_bwd_tile(
        dz, y, inv, agg, x, w_l, w_r, **spec["bwd_tile"])
    star = {}
    if tbwd is not None:
        star = dict(gcode=spec["gcode"], table=tbwd.to(x.dtype))
    spill = spec["spill"]
    dx = banded_matmul(spec["band"], dagg, tile=spec["fwd"]["tile"],
                       width=spec["fwd"]["width"], out_dtype=x.dtype,
                       acc=dxp, **_spill_kw(spill, dagg[spill["s"]]), **star)
    return dx, dwl, dwr, dbl


@traced("sage.fwd")
def fused_sage_layer(x, w_l, b_l, w_r, ctx, *, skip: bool, rate: float = 0.0,
                     seed=None, deterministic: bool = True, star_in=None,
                     star_next: bool = False, table_in=None,
                     emit_table: bool = False):
    """One full shared-SAGE layer: conv + normalize + relu (+skip) +
    dropout, differentiable in x and the weights.

    ``seed``: two ints (dropout words, ops/dropout.py); needed when
    training with ``rate`` > 0. ``table_in``: the previous layer's emitted
    star table (float32), else the table is built here from x (outside the
    gradient). Star threading (supernode batches without spill edges): pass
    ``star_in`` (the previous layer's star_out, or
    ``star_source(x0, ctx)[1]``) to get ``(z, star_out, ftab)`` back, and
    set ``star_next`` on every layer whose star_out the next layer
    consumes. Without ``star_in`` returns ``(z, ftab)`` with self-contained
    gradients. ``ftab`` is the next layer's table when ``emit_table``
    (local windows only), else None. Batches with spill edges add the spill
    window in the forward and take the split backward. Requires
    ``supports_fused_layer(...)``.
    """
    batch = ctx.batch
    rate = float(rate) if not deterministic else 0.0
    _check_dropout(rate, seed)
    has_super = batch.has_supernode_edges
    thread = star_in is not None
    if thread and (not has_super or batch.has_spill_edges):
        raise ValueError("star threading requires a supernode batch without "
                         "spill edges")
    if emit_table and (not has_super or batch.gwin is None):
        raise ValueError("emit_table requires a supernode batch with local "
                         "star windows")
    t0, tg = star_table_geometry(batch.n_graph_cap)
    table = code = gwin = acc = None
    gw = 0
    if has_super:
        code, gwin, gw, acc = star_codes(batch)
        if table_in is not None:
            table = table_in.to(x.dtype)
        else:
            table = _super_tables(x.detach(), batch.node_graph,
                                  batch.node_mask, batch.supernode_index,
                                  batch.n_graph_cap, tg)
    spill = None
    if batch.has_spill_edges:
        spill = dict(s=batch.spill_senders.long(), offsets=batch.spill_offsets,
                     lo=batch.spill_lo, hi=batch.spill_hi)
    spec = dict(
        band=ctx.band, spill=spill, tg=tg,
        fwd=dict(tile=batch.band_tile, width=batch.band_width, table=table,
                 code=code, gwin=gwin, gw=gw, t0=t0,
                 acc_code=acc if emit_table else None, skip=skip,
                 emit=emit_table, rate=rate, seed=seed))
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_l, b_l, w_r))
    if not needs_grad:
        z, ftab = _layer_fwd(x, w_l, b_l, w_r, spec)
        if thread:
            return z, x.new_zeros((tg, x.shape[1]), dtype=torch.float32), ftab
        return z, ftab
    spec.update(
        apply_prev=has_super and star_next,
        gcode=batch.gcode if has_super else None,
        bwd=dict(tile=batch.band_tile, width=batch.band_width, code=code,
                 gwin=gwin, gw=gw, t0=t0, acc_code=acc, has_super=has_super,
                 skip=skip, rate=rate, seed=seed),
        bwd_tile=dict(tile=batch.band_tile, skip=skip, rate=rate, seed=seed,
                      acc_code=batch.gacc if has_super else None, tg=tg))
    z, t_out, ftab = _FusedLayer.apply(x, w_l, b_l, w_r, star_in, spec)
    ftab = ftab if emit_table else None
    return (z, t_out, ftab) if thread else (z, ftab)
