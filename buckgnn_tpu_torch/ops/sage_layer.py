"""Fully fused GraphSAGE layer forward — the serving hot path.

The port of buckgnn_tpu/ops/pallas_sage_layer.py (forward only). One call
computes the whole shared-SAGE layer (Models/BuckGNN.py:113-119, 338-352):

    agg  = band_t @ x_slab (+ star selection)   -> cast to x.dtype
    out  = agg @ W_l + x_t @ W_r + b_l           (f32)
    y    = out * rsqrt(max(rowsum(out^2), 1e-24))
    z    = relu(y) (+ x_t)                       -> cast to x.dtype

and, with ``emit``, the next layer's supernode star table summed from z.

`sage_layer_fwd` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``csrc/sage_layer_fwd.cu`` (bf16 only) and counts
the launch in ``LAUNCHES``; on CPU tensors it runs `sage_layer_plain`, the
plain PyTorch version with the same casts. Spill edges and dropout are not
on the serving path: the wrapper raises on them. The custom backward comes
with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from buckgnn_tpu_torch.graph.batch import LOCAL_STAR_ROWS, star_table_geometry
from buckgnn_tpu_torch.ops import segment

# launches of each kernel wrapper (reset by callers that count a run)
LAUNCHES = {"sage_layer_fwd": 0}

_BM = 64  # rows per kernel block (csrc/sage_layer_fwd.cu)

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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _slab_starts(n: int, tile: int, width: int, device) -> torch.Tensor:
    slab = tile + width
    t = torch.arange(n // tile, device=device)
    return (t * tile - width // 2).clamp(0, max(n - slab, 0))


def _window_rows(gwin, gw: int, t0: int, n_tiles: int, device):
    """[n_tiles, 2*GW] table rows of each tile's star window: wb.. and
    T0+wb.. (gwin None: the whole table, GW == T0, wb == 0)."""
    wb = (torch.zeros(n_tiles, dtype=torch.long, device=device)
          if gwin is None else gwin.long())
    ar = torch.arange(gw, device=device)
    return torch.cat([wb[:, None] + ar, t0 + wb[:, None] + ar], dim=1)


def sage_layer_plain(x, w_l, b_l, w_r, band, *, tile: int, width: int,
                     table=None, code=None, gwin=None, gw: int = 0,
                     t0: int = 0, acc_code=None, skip: bool = False,
                     emit: bool = False):
    """Plain PyTorch version of the fused layer, operation by operation as
    the TPU kernel: products of x.dtype values accumulated in float32.

    ``band``: [n_tiles, T, T+W] int8 counts. ``table``: [tg, H] star table
    or None (no supernode). ``code``: per-row selector over the 2*GW window
    rows ([n_tiles, T] or [n_tiles, T, 1]; 2*GW selects nothing). ``gwin``:
    [n_tiles] window bases, or None for the whole table (GW == T0).
    ``acc_code``: per-row accumulate codes for ``emit``. Returns
    ``(z, ftab)``; ftab is the [tg, H] float32 next-layer table or None.
    """
    n, h = x.shape
    n_tiles = n // tile
    dt = x.dtype
    starts = _slab_starts(n, tile, width, x.device)
    idx = starts[:, None] + torch.arange(tile + width, device=x.device)
    xs = x[idx].float()                                   # [n_tiles, S, H]
    b = band.reshape(n_tiles, tile, tile + width).to(dt).float()
    acc = torch.bmm(b, xs)                                # [n_tiles, T, H]
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
    y = out * torch.rsqrt(sq.clamp_min(1e-24))
    r = torch.relu(y)
    if skip:
        r = r + x.float()
    z = r.to(dt)
    ftab = None
    if emit:
        ftab = emit_table_plain(z, acc_code, gwin, gw, t0, tile)
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
        raise ValueError(f"sage_layer_fwd kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(x, w_l, b_l, w_r, band, *, tile, width, table, code, gwin, gw,
            t0, acc_code, skip, emit):
    from buckgnn_tpu_torch.utils import cuda_build

    n, h = x.shape
    has_super = table is not None
    bf16 = [x, w_l, b_l, w_r] + ([table] if has_super else [])
    ints = ([code] if has_super else []) + (
        [gwin] if gwin is not None else []) + ([acc_code] if emit else [])
    dev = x.device
    for t in bf16 + ints + [band]:
        _check(t.device == dev, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
    for t in bf16:
        _check(t.dtype == torch.bfloat16, "bfloat16 activations/weights")
        _check(t.data_ptr() % 32 == 0, "32-byte aligned bf16 tensors")
    for t in ints:
        _check(t.dtype == torch.int32, "int32 codes")
    _check(band.dtype == torch.int8, "int8 band")
    _check(h in (128, 256, 512), "H in (128, 256, 512)")
    _check(tile % _BM == 0 and n % tile == 0, "tile % 64 == 0, N % tile == 0")
    _check((tile + width) % 16 == 0 and width % 2 == 0, "T+W % 16 == 0")
    _check(n >= tile + width, "N >= T+W")
    _check(band.numel() == n * (tile + width), "band [N/T, T, T+W]")
    _check(tuple(w_l.shape) == (h, h) and tuple(w_r.shape) == (h, h)
           and b_l.numel() == h, "W_l, W_r [H, H] and b_l [H]")
    tg = 2 * t0
    if has_super:
        _check(tuple(table.shape) == (tg, h), "table [2*T0, H]")
        _check(code.numel() == n, "one code per row")
        _check((2 * gw) % 16 == 0 and (gw % 16 == 0 or gw == t0),
               "star window of whole 16-row fragments")
        _check(gwin is None or gwin.numel() == n // tile, "gwin [N/T]")
        _check(gwin is not None or gw == t0, "full-table selection: GW == T0")
    if emit:
        _check(has_super and gwin is not None and 2 * gw <= 2 * LOCAL_STAR_ROWS,
               "emit needs the local star windows")
        _check(acc_code.numel() == n, "one accumulate code per row")

    z = torch.empty_like(x)
    partial = ftab = None
    if emit:
        partial = torch.empty((n // _BM, 2 * gw, h), dtype=torch.float32,
                              device=dev)
        ftab = torch.empty((tg, h), dtype=torch.float32, device=dev)
    lib = cuda_build.load("sage_layer_fwd")
    fn = lib.sage_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(x), _ptr(band), _ptr(w_l), _ptr(w_r), _ptr(b_l),
             _ptr(table), _ptr(code), _ptr(gwin), _ptr(acc_code), _ptr(z),
             _ptr(partial), _ptr(ftab), n, h, tile, width, gw, t0, tg,
             int(has_super), int(skip), int(emit), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sage_layer_fwd launch failed: CUDA error {err}")
    LAUNCHES["sage_layer_fwd"] += 1
    return z, ftab


def sage_layer_fwd(x, w_l, b_l, w_r, band, *, tile: int, width: int,
                   table=None, code=None, gwin=None, gw: int = 0,
                   t0: int = 0, acc_code=None, skip: bool = False,
                   emit: bool = False):
    """The fused layer (arguments as `sage_layer_plain`). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    kw = dict(tile=tile, width=width, table=table, code=code, gwin=gwin,
              gw=gw, t0=t0, acc_code=acc_code, skip=skip, emit=emit)
    if x.device.type == "cuda":
        return _launch(x, w_l, b_l, w_r, band, **kw)
    if x.device.type == "cpu":
        return sage_layer_plain(x, w_l, b_l, w_r, band, **kw)
    raise ValueError(f"sage_layer_fwd: unsupported device {x.device}")


def supports_fused_layer(ctx, x, aggr: str, normalize: bool) -> bool:
    """Static eligibility of the fused layer for this batch/config."""
    if ctx is None or ctx.band is None:
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


def fused_sage_layer(x, w_l, b_l, w_r, ctx, *, skip: bool, rate: float = 0.0,
                     deterministic: bool = True, table_in=None,
                     emit_table: bool = False):
    """One full shared-SAGE layer: conv + normalize + relu (+skip).

    ``table_in``: the previous layer's emitted star table (float32), else
    the table is built here from x. Returns ``(z, ftab)``; ``ftab`` is the
    next layer's table when ``emit_table`` (local windows only), else None.
    Requires ``supports_fused_layer(...)``.
    """
    batch = ctx.batch
    if not deterministic and rate > 0.0:
        raise NotImplementedError(
            "dropout in the fused layer comes with the training slice "
            "(ROADMAP queue 2, kernel 2)")
    if batch.has_spill_edges:
        raise NotImplementedError(
            "spill edges in the fused layer come with the spill slice "
            "(ROADMAP queue 1, item 5)")
    has_super = batch.has_supernode_edges
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
            table = _super_tables(x, batch.node_graph, batch.node_mask,
                                  batch.supernode_index, batch.n_graph_cap,
                                  tg)
    return sage_layer_fwd(
        x, w_l, b_l, w_r, ctx.band, tile=batch.band_tile,
        width=batch.band_width, table=table, code=code, gwin=gwin, gw=gw,
        t0=t0, acc_code=acc if emit_table else None, skip=skip,
        emit=emit_table)
