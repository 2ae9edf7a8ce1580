"""Fully fused edge-augmented GraphNetBlock: forward and backward kernels.

The port of buckgnn_tpu/ops/pallas_ea_block.py. One forward call computes
the whole block of Models/BuckGNN.py:528-566 with the stack's skip and
dropout (:103-106), for every edge slot of the receiver-tiled windows and
every node:

    p    = x @ [W_sp | W_er]                     per node -> x.dtype
    e1   = relu(p_r[recv] + p_s[send] + e @ W_ee + b_e0)       -> x.dtype
    e2f  = e1 @ W_e1 + b_e1                      (f32; e2 = x.dtype)
    m1   = relu(p_p[send] + e2 @ W_pe + b_p0)                   -> x.dtype
    sm   = segment sum of m1 over each receiver's slots         -> x.dtype
    agg  = (sm @ W_p1 + cnt * b_p1) / max(cnt, 1)               -> x.dtype
    g1   = relu([x | agg] @ W_g0 + b_g0)                        -> x.dtype
    x1f  = g1 @ W_g1 + b_g1                      (f32; x1 = x.dtype)
    b1   = relu(x1 @ W_b0 + b_b0)                               -> x.dtype
    x2   = x1f + b1 @ W_b1 + b_b1                (f32)
    zx   = dropout(x2 (+ x)),  ze = dropout(e2f (+ e))          -> x.dtype

with W_sp = [W_es | W_px] (the sender parts of edge_mlp and phi), p_s and
p_p its two halves and p_r = x @ W_er. These are the TPU kernel's cast
points (pallas_ea_block.py:165-226), except that p is computed once per
node: the TPU computes it once per slab row, and its slabs overlap. In
encoder mode (layer 0) ``e`` is the raw [T, W, 8] window and the 3-layer
edge encoder (8 -> 128 -> 128 -> H, zero-padded weights, biases in rows
8-10 of the bias stack) runs first, inside the call. ``save_res`` also
returns e1 and m1, the backward's residuals.

Geometry: the batch's windows are flattened to E = T * W slots; an
`EAContext`, built once per forward, gives each slot its global sender
(slab start + offset, or the far table's sender, or -1 for a pad) and
receiver (-1 for a pad), each node its run of slots [rlo, rhi) (slots are
receiver-sorted within a tile) and each node its sender-sorted slots
(``sorder[soff[n]:soff[n+1]]``). Pads reach neither agg nor a gradient.

The backward (`ea_block_bwd`) replays the chain from the stored e1 and
m1 (pallas_ea_block.py:383-657) and returns the folded dx, de_win (not in
encoder mode), every weight gradient and the bias stack's gradient in
float32. The TPU kernel leaves dx as a tile-centre block, a [2*width, H]
halo and a receiver-tiled far table, and XLA folds them (`_fold_dx`); here
each node sums its sender-sorted slots' [de1 | dzm] once, which makes the
halo and far folds one pass: s = sum over the node's slots -> x.dtype,
dx += s @ W_sp^T.

Dropout: two keep masks per call from the port's hash (ops/dropout.py),
the edge mask on rows 0..E-1 (slot t*W + w) and the node mask on rows
E..E+N-1, so the backward regenerates both from the two seed words. The
words are not the TPU's: the port matches the JAX package at rate 0 only.

`ea_block_fwd` and `ea_block_bwd` launch the hand-written kernels
(csrc/ea_block_fwd.cu, csrc/ea_block_bwd.cu; bf16 only) on CUDA tensors,
counted in ``LAUNCHES``, and run the plain versions (`ea_block_fwd_plain`,
`ea_block_bwd_plain`) on CPU tensors. `fused_ea_block` is the block as the
model calls it: weights sliced and cast outside a ``torch.autograd.
Function`` (the JAX package's ``_fused_block`` / ``_fused_block_enc``
custom VJPs), so that autograd transposes the slicing and sums the tied
layers' bf16 weight gradients in float32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.nn import functional as F

from buckgnn_tpu_torch.ops import ea_windowed as eaw
from buckgnn_tpu_torch.ops.dropout import (
    apply_dropout, dropout_scale, dropout_threshold,
)

LAUNCHES = {"ea_block_fwd": 0, "ea_block_bwd": 0}

WKEYS = ("wer", "wee", "wsp", "we1", "wpe", "wp1", "wg0", "wg1", "wb0",
         "wb1")
ENC_WKEYS = ("wen0", "wen1", "wen2")
ENC_IN = 8     # raw edge-feature lanes of the encoder window
ENC_HID = 128  # the encoder's padded hidden width

# How close the forward kernel's outputs must be to the plain version's on
# the same bf16 inputs, as (atol as a fraction of rms(ref), rtol):
# |got - ref| <= atol * rms(ref) + rtol * |ref| (sage_layer.gate_tol).
# Both sides take the same bf16 products with f32 sums in another order,
# so every bf16 value of the chain (p, e1, e2, m1, sm, agg, g1, x1, b1 and
# the outputs) can round to its neighbour; one ulp is at most 2^-7 of a value, and a flipped value
# early in the chain moves the later ones by its ulp times a weight row:
# rtol 1.6e-2 takes two ulps, and atol 5% of rms(ref) takes a flip carried
# through a product. A forward without its far senders, without the
# cnt * b_p1 term or without the skip moves entries by O(rms) and fails.
KERNEL_FWD_TOL = (5e-2, 1.6e-2)
# The backward kernel against the plain version, as the largest relative
# Frobenius error ||got - ref|| / ||ref|| of each output. Each side
# recomputes the forward's relu masks (of e1, m1, g1, b1) from its own bf16
# values, and a pre-activation within the forward's rounding noise of zero
# can flip its mask: that moves one element by its whole cotangent, so an
# elementwise gate would have to pass errors of rms size. chip_smoke.py on
# an H100 (NVIDIA H100 80GB HBM3, 700 W), at the ea-virtual shape and on
# its 12-tile ragged batch: dx at most 0.23%, de_win 0.11%, the weight and
# bias gradients at most 0.94% (dW_b0, under the most recomputed masks).
# A backward without the slab-overlap (halo) part of dx moves it by 24% at
# the ea-virtual shape, one without the far part by 19% (11% and 4.9% on
# the test batch of tests/test_torch_port_ea_block.py), so dx and de_win
# take 1e-2; the weight and bias gradients 3e-2.
# A norm over a whole tensor cannot see a fault confined to a few rows, so
# dx and de_win are also held row by row ("dx_row", "de_win_row"): the
# largest per-row relative error, `row_rel_err`. A mask flip moves one
# element of a row by its cotangent, which is a larger share of a row than
# of the tensor. chip_smoke.py on the same card, at the ea-virtual shape
# and on both ragged batches: dx at most 5.5% per row, de_win 1.8%. At the
# ea-virtual shape the faults of `sender_faults` that touch a few rows
# (one node's sender run, one far rank, the clamped first tile's halo)
# read 0.39%, 0.24% and 0.82% in dx's norm, which passes, and 81%, 29% and
# 54% per row; so both rows take 0.12, between the two. A weight pass that
# skips one of its 16 row chunks moves dW_b1 by 24%, and a dW_sp without
# the far slots 32%.
KERNEL_BWD_TOL = {"dx": 1e-2, "de_win": 1e-2, "dw": 3e-2, "dx_row": 0.12,
                  "de_win_row": 0.12}
# rows with a norm under this share of the rms row norm are judged against
# that floor (a near-zero row has no scale of its own)
ROW_FLOOR = 0.1


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| in float32 (inf if got is not finite)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest per-row ||got_r - ref_r|| / max(||ref_r||, ROW_FLOOR *
    rms row norm) of two [rows, H] tensors (inf if got is not finite)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = ref.norm(dim=1)
    floor = ROW_FLOOR * scale.pow(2).mean().sqrt().clamp_min(1e-30)
    return float(((got - ref).norm(dim=1) / scale.clamp_min(floor)).max())


def bwd_errors(got, ref, ctx: EAContext) -> dict[str, float]:
    """Each backward output's reading against a reference: the relative
    norms of dx, de_win (valid slots), every dW ("d" + key) and dbias, and
    the largest per-row relative errors of dx and de_win. ``got`` and
    ``ref`` are (dx, de_win, dw, dbias) as `ea_block_bwd` returns them."""
    pairs = {"dx": (got[0], ref[0])}
    if ref[1] is not None:
        v = ctx.recv >= 0
        h = ref[1].shape[-1]
        pairs["de_win"] = (got[1].reshape(-1, h)[v],
                           ref[1].reshape(-1, h)[v])
    errs = {k: rel_err(a, r) for k, (a, r) in pairs.items()}
    errs.update({f"{k}_row": row_rel_err(a, r) for k, (a, r) in pairs.items()})
    errs.update({f"d{k}": rel_err(got[2][k], ref[2][k]) for k in ref[2]})
    errs["dbias"] = rel_err(got[3], ref[3])
    return errs


def bwd_tol(key: str) -> float:
    """The gate of a `bwd_errors` key (weights and bias take "dw")."""
    return KERNEL_BWD_TOL.get(key, KERNEL_BWD_TOL["dw"])


def sender_faults(batch, ctx: EAContext) -> dict[str, EAContext]:
    """Faulty contexts for the backward's gates, each with some live slots'
    senders dropped (send = -1), so that the plain backward leaves them out
    of the sender fold of dx and of dW_sp (the forward's residuals come in
    whole): the slab-overlap halo (senders in the slab, outside the
    receiver's tile), the far rows, one node's sender run (the sender of the
    middle live slot), one far rank (the most used one of the tile with the
    most far slots) and the first tile's halo (its slab clamped at 0)."""
    tile = batch.band_tile
    slab = tile + batch.band_width
    code = batch.win_sidx.reshape(-1).long()
    live = ctx.send >= 0
    far = live & (code >= slab)
    recv_tile = torch.where(ctx.recv >= 0, ctx.recv // tile, -1)
    halo = live & (ctx.send // tile != recv_tile) & ~far
    slot_tile = torch.arange(ctx.n_slots, device=code.device) // ctx.w_cap
    k = ctx.send[live][int(live.sum()) // 2]
    t = torch.bincount(slot_tile[far], minlength=ctx.n_tiles).argmax()
    far_t = far & (slot_tile == t)
    r = torch.bincount(code[far_t] - slab).argmax() + slab
    drops = {"no-halo": halo, "no-far-fold": far,
             "one-sender-run": ctx.send == k,
             "one-far-rank": far_t & (code == r),
             "clamped-tile-halo": halo & (slot_tile == 0)}
    for name, d in drops.items():
        if not bool(d.any()):
            raise ValueError(f"fault {name}: no slot to drop in this batch")
    return {name: dataclasses.replace(ctx, send=torch.where(d, -1, ctx.send))
            for name, d in drops.items()}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass
class EAContext:
    """Flattened window geometry of one batch (see the module docstring).
    ``send``/``recv``: [E] int32 global ids, -1 for pads; ``rlo``/``rhi``:
    [N] int32 slot runs; ``sorder``: [E] int32 slots sorted by sender (pads
    last), ``soff``: [N + 1] int32; ``cnt``: [N] float32 in-degree (CSR
    row lengths, pad edges included, as the JAX block divides by)."""

    n_nodes: int
    n_tiles: int
    w_cap: int
    send: torch.Tensor
    recv: torch.Tensor
    rlo: torch.Tensor
    rhi: torch.Tensor
    sorder: torch.Tensor
    soff: torch.Tensor
    cnt: torch.Tensor

    @property
    def n_slots(self) -> int:
        return self.n_tiles * self.w_cap


def make_ea_context(batch) -> EAContext:
    """The `EAContext` of a windowed batch (built once per forward)."""
    tile, _, slab, n_tiles, n = eaw.window_geometry(batch)
    w_cap = batch.win_sidx.shape[1]
    ct = batch.win_far_tsend.shape[1]
    dev = batch.device
    t = torch.arange(n_tiles, device=dev)
    starts = eaw.slab_starts(batch)
    code = batch.win_sidx.long()
    in_slab = code < slab
    is_far = (code >= slab) & (code < slab + ct)
    far_ids = torch.gather(batch.win_far_tsend.long(), 1,
                           (code - slab).clamp(0, ct - 1))
    send = torch.where(in_slab, starts[:, None] + code,
                       torch.where(is_far, far_ids, -1)).reshape(-1)
    ridx = batch.win_ridx.long()
    valid = ridx < tile
    recv = torch.where(valid, t[:, None] * tile + ridx, -1)
    # monotone key over the flat slots: 2 * receiver, and for a tile's
    # trailing pads 2 * (next tile's first node) - 1
    key = torch.where(valid, 2 * recv,
                      2 * (t[:, None] + 1) * tile - 1).reshape(-1)
    nodes2 = 2 * torch.arange(n, device=dev)
    rlo = torch.searchsorted(key, nodes2)
    rhi = torch.searchsorted(key, nodes2, right=True)
    skey = torch.where(send >= 0, send, n)
    sorder = torch.argsort(skey, stable=True)
    soff = torch.searchsorted(skey[sorder],
                              torch.arange(n + 1, device=dev))
    i32 = torch.int32
    return EAContext(n_nodes=n, n_tiles=n_tiles,
                     w_cap=w_cap, send=send.to(i32),
                     recv=recv.reshape(-1).to(i32), rlo=rlo.to(i32),
                     rhi=rhi.to(i32), sorder=sorder.to(i32),
                     soff=soff.to(i32), cnt=eaw.window_count(batch))


# the kernels' passes (csrc/ea_block_fwd.cu, csrc/ea_block_bwd.cu)
FWD_PASSES = ("fwd_proj", "fwd_edge", "fwd_node")
BWD_PASSES = ("bwd_node1", "bwd_edge", "bwd_node2", "bwd_weights")


def pass_flops(n: int, ev: int, h: int, *, enc: bool = False
               ) -> dict[str, int]:
    """Operations (two per multiply-add) of the products each kernel pass
    runs for ``n`` nodes and ``ev`` valid slots at width ``h``, keyed by
    `FWD_PASSES` and `BWD_PASSES`. Products over slots count valid slots
    only (the kernels compute the pads and drop them); the backward counts
    its recomputed forward products. In encoder mode the encoder's layers
    count too, its first (K = 8, f32 FMAs in the kernels) as a product."""
    c = ENC_HID
    hh = h * h
    enc_f = (ENC_IN * c + c * c + c * h) if enc else 0  # encoder forward
    enc_d = (c * h + c * c) if enc else 0  # its data gradients
    enc_w = (c * h + c * c + ENC_IN * c) if enc else 0  # its weights'
    return {
        "fwd_proj": 2 * n * 3 * hh,  # x @ [W_sp | W_er]
        "fwd_edge": 2 * ev * (3 * hh + enc_f),  # W_ee, W_e1, W_pe
        "fwd_node": 2 * n * 6 * hh,  # W_p1, W_g0 (2H in), W_g1, W_b0, W_b1
        # the five recomputed, then W_b1^T, W_b0^T, W_g1^T, W_g0[H:]^T,
        # W_p1^T
        "bwd_node1": 2 * n * 10 * hh,
        # e2, then W_pe^T, W_e1^T, W_ee^T (and the encoder's recompute and
        # data gradients)
        "bwd_edge": 2 * ev * (4 * hh + enc_f + enc_d),
        # W_g0[:H]^T (dxt), W_er^T, W_sp^T (2H in)
        "bwd_node2": 2 * n * 4 * hh,
        # dW over nodes: W_b1, W_b0, W_g1, W_g0 (2), W_p1, W_er, W_sp (2);
        # over slots: W_pe, W_e1, W_ee (and the encoder's three)
        "bwd_weights": 2 * (n * 9 * hh + ev * (3 * hh + enc_w)),
    }


def supports_fused_encoder(batch, h: int, fe: int) -> bool:
    """In-kernel edge-encoder fusion for layer 0: the 3-layer encoder
    (hidden > 128) with at most 8 raw edge features."""
    return supports_fused_ea(batch, h) and h > 128 and fe <= ENC_IN


def supports_fused_ea(batch, h: int) -> bool:
    """Static eligibility of the fused EA block for this batch/width."""
    return (
        eaw.supports_windowed(batch)
        and batch.win_far_tsend is not None
        and h % 128 == 0
        and batch.band_width % 16 == 0
        and batch.band_width <= batch.band_tile
        and batch.n_node_cap % batch.band_tile == 0
    )


def _check_dropout(rate: float, seed) -> None:
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs two seed words")


def _mm(a, b):
    return a.float() @ b.float()


def _gathered(p: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows p[ids] as float32, a zero row where ids < 0."""
    pz = torch.cat([p, p.new_zeros((1, p.shape[1]))])
    idx = torch.where(ids < 0, p.shape[0], ids.long())
    return pz[idx].float()


def _segment(v: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 sums of the rows of v by ids (rows with ids < 0 dropped)."""
    keep = ids >= 0
    out = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=v.device)
    out.index_add_(0, ids[keep].long(), v[keep].float())
    return out


def _encoder(raw, w, bias, dt):
    """The 3-layer edge encoder from the raw [E, 8] window: (h1, h2, e_in)
    in dt, as the TPU kernel's _enc_chain (pallas_ea_block.py:141-163)."""
    c = ENC_HID
    h1 = torch.relu(_mm(raw, w["wen0"]) + bias[8, :c]).to(dt)
    h2 = torch.relu(_mm(h1, w["wen1"]) + bias[9, :c]).to(dt)
    return h1, h2, (_mm(h2, w["wen2"]) + bias[10]).to(dt)


def _node_chain(x, sm, cnt, w, bias, dt):
    """agg, g1, x1f, x1, b1 of the node side, from the bf16 sm."""
    h = x.shape[1]
    deg = cnt.clamp_min(1.0)[:, None]
    agg = ((_mm(sm, w["wp1"]) + cnt[:, None] * bias[3]) / deg).to(dt)
    g1 = torch.relu(_mm(x, w["wg0"][:h]) + _mm(agg, w["wg0"][h:])
                    + bias[4]).to(dt)
    x1f = _mm(g1, w["wg1"]) + bias[5]
    x1 = x1f.to(dt)
    b1 = torch.relu(_mm(x1, w["wb0"]) + bias[6]).to(dt)
    return agg, g1, x1f, x1, b1


def ea_block_fwd_plain(x, e_win, w, bias, ctx: EAContext, *, skip: bool,
                       rate: float = 0.0, seed=None, save_res: bool = False,
                       enc: bool = False):
    """Plain PyTorch version of the fused block forward, with the kernel's
    casts (module docstring). ``x`` [N, H]; ``e_win`` [T, W, H] (or the raw
    [T, W, 8] window in encoder mode); ``w`` the weight dict (``WKEYS``, and
    ``ENC_WKEYS`` in encoder mode) in x.dtype, [in, out]; ``bias`` float32
    [8 or 11, H]. Returns ``(zx, ze)``, with ``save_res`` ``(zx, ze, e1s,
    m1s)``; ze, e1s, m1s [T, W, H] in x.dtype."""
    _check_dropout(rate, seed)
    if enc and skip:
        raise ValueError("encoder mode is layer 0: no skip")
    n, h = x.shape
    dt = x.dtype
    e = ctx.n_slots
    proj = _mm(x, torch.cat([w["wsp"], w["wer"]], 1)).to(dt)
    gs = _gathered(proj[:, :2 * h], ctx.send)
    pr = _gathered(proj[:, 2 * h:], ctx.recv)
    ein = e_win.reshape(e, -1)
    if enc:
        ein = _encoder(ein, w, bias, dt)[2]
    e1 = torch.relu(_mm(ein, w["wee"]) + pr + gs[:, :h] + bias[0]).to(dt)
    e2f = _mm(e1, w["we1"]) + bias[1]
    m1 = torch.relu(_mm(e2f.to(dt), w["wpe"]) + gs[:, h:]
                    + bias[2]).to(dt)
    sm = _segment(m1, ctx.recv, n).to(dt)
    _, _, x1f, _, b1 = _node_chain(x, sm, ctx.cnt, w, bias, dt)
    x2 = x1f + _mm(b1, w["wb1"]) + bias[7]
    if skip:
        x2 = x2 + x.float()
        e2f = e2f + ein.float()
    if rate > 0.0:
        e2f = apply_dropout(e2f, seed, rate)
        x2 = apply_dropout(x2, seed, rate, row0=e)
    zx = x2.to(dt)
    shape = (ctx.n_tiles, ctx.w_cap, h)
    ze = e2f.to(dt).reshape(shape)
    if save_res:
        return zx, ze, e1.reshape(shape), m1.reshape(shape)
    return zx, ze


def ea_block_bwd_plain(dzx, dze, e1s, m1s, x, e_win, w, bias,
                       ctx: EAContext, *, skip: bool, rate: float = 0.0,
                       seed=None, enc: bool = False):
    """Plain PyTorch version of the fused block backward, step by step as
    the TPU kernel (pallas_ea_block.py:475-623) with its casts, from the
    forward's residuals e1s and m1s. Returns ``(dx, de_win, dw, dbias)``:
    dx [N, H] and de_win [T, W, H] (None in encoder mode) in x.dtype; dw a
    dict of float32 gradients of every weight of ``w``; dbias float32 like
    ``bias``. dx holds the folded sender gradient (halo and far rows)."""
    _check_dropout(rate, seed)
    n, h = x.shape
    dt = x.dtype
    e = ctx.n_slots
    z = torch.zeros((), device=x.device)
    ein = e_win.reshape(e, -1)
    raw = ein
    if enc:
        hen1, hen2, ein = _encoder(raw, w, bias, dt)
    e1 = e1s.reshape(e, h)
    m1 = m1s.reshape(e, h)
    e2 = (_mm(e1, w["we1"]) + bias[1]).to(dt)
    sm = _segment(m1, ctx.recv, n).to(dt)
    agg, g1, _, x1, b1 = _node_chain(x, sm, ctx.cnt, w, bias, dt)
    dzx_eff = dzx.float()
    dze_eff = dze.reshape(e, h).float()
    if rate > 0.0:
        dze_eff = apply_dropout(dze_eff, seed, rate)
        dzx_eff = apply_dropout(dzx_eff, seed, rate, row0=e)
    cnt = ctx.cnt[:, None]
    # ---- node side: beta, gamma, the mean and phi's second layer ----
    dx2 = dzx_eff
    dx2_c = dx2.to(dt)
    db1 = _mm(dx2_c, w["wb1"].t())
    dzb_f = torch.where(b1.float() > 0, db1, z)
    dzb = dzb_f.to(dt)
    dx1 = dx2 + _mm(dzb, w["wb0"].t())
    dx1_c = dx1.to(dt)
    dg1 = _mm(dx1_c, w["wg1"].t())
    dzg_f = torch.where(g1.float() > 0, dg1, z)
    dzg = dzg_f.to(dt)
    dxt = _mm(dzg, w["wg0"][:h].t())
    dagg_d = _mm(dzg, w["wg0"][h:].t()) / cnt.clamp_min(1.0)
    dagg_c = dagg_d.to(dt)
    dsm = _mm(dagg_c, w["wp1"].t()).to(dt)
    # ---- edge side ----
    dm1 = _gathered(dsm, ctx.recv)
    dzm_f = torch.where(m1.float() > 0, dm1, z)
    dzm = dzm_f.to(dt)
    de2 = dze_eff + _mm(dzm, w["wpe"].t())
    de2_c = de2.to(dt)
    de1_f = torch.where(e1.float() > 0, _mm(de2_c, w["we1"].t()), z)
    de1 = de1_f.to(dt)
    deo = _mm(de1, w["wee"].t())
    if skip:
        deo = deo + dze_eff
    # ---- the receiver and sender folds into dx ----
    r_de1 = _segment(de1, ctx.recv, n).to(dt)
    s_node = _segment(torch.cat([de1, dzm], 1), ctx.send, n).to(dt)
    dx = (_mm(r_de1, w["wer"].t()) + _mm(s_node, w["wsp"].t())) + dxt
    if skip:
        dx = dx + dzx_eff
    xa = torch.cat([x, agg], 1)
    dw = dict(wb1=_mm(b1.t(), dx2_c), wb0=_mm(x1.t(), dzb),
              wg1=_mm(g1.t(), dx1_c), wg0=_mm(xa.t(), dzg),
              wp1=_mm(sm.t(), dagg_c), wpe=_mm(e2.t(), dzm),
              we1=_mm(e1.t(), de2_c), wee=_mm(ein.t(), de1),
              wer=_mm(x.t(), r_de1), wsp=_mm(x.t(), s_node))
    rows = [de1_f.sum(0), de2.sum(0), dzm_f.sum(0), (cnt * dagg_d).sum(0),
            dzg_f.sum(0), dx1.sum(0), dzb_f.sum(0), dx2.sum(0)]
    de_win = None
    if enc:
        deo_c = deo.to(dt)
        dz2_f = torch.where(hen2.float() > 0, _mm(deo_c, w["wen2"].t()), z)
        dz2 = dz2_f.to(dt)
        dz1_f = torch.where(hen1.float() > 0, _mm(dz2, w["wen1"].t()), z)
        dw.update(wen2=_mm(hen2.t(), deo_c), wen1=_mm(hen1.t(), dz2),
                  wen0=_mm(raw.t(), dz1_f.to(dt)))
        rows += [F.pad(dz1_f.sum(0), (0, h - ENC_HID)),
                 F.pad(dz2_f.sum(0), (0, h - ENC_HID)), deo.sum(0)]
    else:
        de_win = deo.to(dt).reshape(ctx.n_tiles, ctx.w_cap, h)
    return dx.to(dt), de_win, dw, torch.stack(rows)


# ---- the CUDA kernels -----------------------------------------------------

def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused EA block kernel: {what}")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _dropout_args(rate: float, seed):
    if rate <= 0.0:
        return 0, 0, 0, 0, 1.0
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return 1, dropout_threshold(rate), s0, s1, dropout_scale(rate)


def _check_common(x, e_win, w, bias, ctx, enc, extra_bf16=()):
    n, h = x.shape
    e = ctx.n_slots
    keys = WKEYS + (ENC_WKEYS if enc else ())
    bf16 = [x, e_win, *(w[k] for k in keys), *extra_bf16]
    ints = [ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.sorder, ctx.soff]
    dev = x.device
    for t in bf16 + ints + [bias, ctx.cnt]:
        _check(t.device == dev, "all tensors on one CUDA device")
        _check(t.is_contiguous(), "contiguous tensors")
    for t in bf16:
        _check(t.dtype == torch.bfloat16, "bfloat16 activations/weights")
        _check(t.data_ptr() % 32 == 0, "32-byte aligned bf16 tensors")
    for t in ints:
        _check(t.dtype == torch.int32, "int32 geometry")
    _check(bias.dtype == torch.float32 and ctx.cnt.dtype == torch.float32,
           "float32 bias stack and counts")
    _check(h in (128, 256, 512), "H in (128, 256, 512)")
    _check(n % 64 == 0 and n == ctx.n_nodes, "N % 64 == 0, N of the context")
    _check(tuple(bias.shape) == ((11 if enc else 8), h), "bias [8|11, H]")
    shapes = dict(wer=(h, h), wee=(h, h), wsp=(h, 2 * h), we1=(h, h),
                  wpe=(h, h), wp1=(h, h), wg0=(2 * h, h), wg1=(h, h),
                  wb0=(h, h), wb1=(h, h), wen0=(ENC_IN, ENC_HID),
                  wen1=(ENC_HID, ENC_HID), wen2=(ENC_HID, h))
    for k in keys:
        _check(tuple(w[k].shape) == shapes[k], f"{k} {shapes[k]}")
    if enc:
        _check(h > ENC_HID, "encoder mode needs H > 128")
        _check(e_win.numel() == e * ENC_IN, "raw window [T, W, 8]")
    else:
        _check(e_win.numel() == e * h, "edge window [T, W, H]")
    for t, size in ((ctx.send, e), (ctx.recv, e), (ctx.sorder, e),
                    (ctx.rlo, n), (ctx.rhi, n), (ctx.soff, n + 1),
                    (ctx.cnt, n)):
        _check(t.numel() == size, "context sizes")


def _weight_ptrs(w, enc):
    return ([_ptr(w[k]) for k in WKEYS]
            + [_ptr(w[k]) if enc else _ptr(None) for k in ENC_WKEYS])




def _scratch(lib, name, n, e, h, enc, dev):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4
    nbytes = int(fn(n, e, h, int(enc)))
    return torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)


def _launch_fwd(x, e_win, w, bias, ctx, *, skip, rate, seed, save_res, enc):
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    _check(not (enc and skip), "encoder mode is layer 0: no skip")
    _check_common(x, e_win, w, bias, ctx, enc)
    n, h = x.shape
    e = ctx.n_slots
    shape = (ctx.n_tiles, ctx.w_cap, h)
    zx = torch.empty_like(x)
    ze = torch.empty(shape, dtype=x.dtype, device=x.device)
    e1s = torch.empty(shape, dtype=x.dtype, device=x.device) if save_res \
        else None
    m1s = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = cuda_build.load("ea_block_fwd")
    scratch = _scratch(lib, "ea_block_fwd_scratch_bytes", n, e, h, enc,
                       x.device)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    fn = lib.ea_block_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 7
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    geometry = (ctx.send, ctx.recv, ctx.rlo, ctx.rhi, ctx.cnt)
    err = fn(_ptr(x), _ptr(e_win), *_weight_ptrs(w, enc), _ptr(bias),
             *map(_ptr, geometry), _ptr(scratch), _ptr(zx), _ptr(ze),
             _ptr(e1s), _ptr(m1s), n, e, h, int(enc), int(skip),
             int(save_res), drop, thr, s0, s1, scale,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ea_block_fwd launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "ea_block_fwd")
    if save_res:
        return zx, ze, e1s, m1s
    return zx, ze


def ea_block_fwd(x, e_win, w, bias, ctx: EAContext, *, skip: bool,
                 rate: float = 0.0, seed=None, save_res: bool = False,
                 enc: bool = False):
    """The fused block forward (arguments and results as
    `ea_block_fwd_plain`). CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    kw = dict(skip=skip, rate=rate, seed=seed, save_res=save_res, enc=enc)
    if x.device.type == "cuda":
        return _launch_fwd(x, e_win, w, bias, ctx, **kw)
    if x.device.type == "cpu":
        return ea_block_fwd_plain(x, e_win, w, bias, ctx, **kw)
    raise ValueError(f"ea_block_fwd: unsupported device {x.device}")


def _launch_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx, *, skip, rate,
                seed, enc):
    from buckgnn_tpu_torch.utils import cuda_build

    _check_dropout(rate, seed)
    _check(not (enc and skip), "encoder mode is layer 0: no skip")
    _check_common(x, e_win, w, bias, ctx, enc, (dzx, dze, e1s, m1s))
    n, h = x.shape
    e = ctx.n_slots
    _check(tuple(dzx.shape) == (n, h), "dzx [N, H]")
    for t in (dze, e1s, m1s):
        _check(t.numel() == e * h, "dze, e1s, m1s [T, W, H]")
    dev = x.device
    dx = torch.empty_like(x)
    de_win = None if enc else torch.empty(
        (ctx.n_tiles, ctx.w_cap, h), dtype=x.dtype, device=dev)
    keys = WKEYS + (ENC_WKEYS if enc else ())
    dw = {k: torch.empty(w[k].shape, dtype=torch.float32, device=dev)
          for k in keys}
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=dev)
    lib = cuda_build.load("ea_block_bwd")
    scratch = _scratch(lib, "ea_block_bwd_scratch_bytes", n, e, h, enc, dev)
    drop, thr, s0, s1, scale = _dropout_args(rate, seed)
    fn = lib.ea_block_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 43 + [ctypes.c_int] * 6
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    geometry = (ctx.recv, ctx.rlo, ctx.rhi, ctx.sorder, ctx.soff, ctx.cnt)
    dw_ptrs = [_ptr(dw.get(k)) for k in WKEYS + ENC_WKEYS]
    err = fn(_ptr(dzx), _ptr(dze), _ptr(e1s), _ptr(m1s), _ptr(x),
             _ptr(e_win), *_weight_ptrs(w, enc), _ptr(bias),
             *map(_ptr, geometry), _ptr(scratch), _ptr(dx), _ptr(de_win),
             *dw_ptrs, _ptr(dbias), n, e, h, int(enc), int(skip), drop, thr,
             s0, s1, scale, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ea_block_bwd launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "ea_block_bwd")
    return dx, de_win, dw, dbias


def engine_product(a: torch.Tensor, w: torch.Tensor, *,
                   transpose: bool = False) -> torch.Tensor:
    """The EA kernels' product engine alone (csrc/ea_common.cuh), for its
    card test: float32 ``a @ w`` (w [K, N], read MN-major) or, with
    ``transpose``, ``a @ w.T`` (w [N, K], read K-major), from bf16 CUDA
    tensors; N in (128, 256, 512), K a multiple of 64 up to 512, or 1024
    (first half streamed, second half in the row tile)."""
    from buckgnn_tpu_torch.utils import cuda_build

    m, k = a.shape
    n = w.shape[0] if transpose else w.shape[1]
    _check(a.is_cuda and w.device == a.device, "CUDA tensors")
    _check(a.dtype == w.dtype == torch.bfloat16, "bfloat16 operands")
    _check(a.is_contiguous() and w.is_contiguous(), "contiguous operands")
    _check(tuple(w.shape) == ((n, k) if transpose else (k, n)), "w shape")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = cuda_build.load("ea_block_fwd").ea_engine_product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_ptr(a), _ptr(w), _ptr(out), m, k, n, int(transpose),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ea_engine_product failed: CUDA error {err}")
    return out


def ea_block_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx: EAContext, *,
                 skip: bool, rate: float = 0.0, seed=None, enc: bool = False):
    """The fused block backward (arguments and results as
    `ea_block_bwd_plain`). CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    kw = dict(skip=skip, rate=rate, seed=seed, enc=enc)
    if x.device.type == "cuda":
        return _launch_bwd(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx, **kw)
    if x.device.type == "cpu":
        return ea_block_bwd_plain(dzx, dze, e1s, m1s, x, e_win, w, bias, ctx,
                                  **kw)
    raise ValueError(f"ea_block_bwd: unsupported device {x.device}")


# ---- the block as the model calls it --------------------------------------

class _FusedBlock(torch.autograd.Function):
    """The fused block with its custom backward (the JAX package's
    ``_fused_block`` / ``_fused_block_enc`` custom VJPs in 'fold' mode).
    Differentiable inputs: x, e_win (not in encoder mode: the raw window is
    data), the bias stack and the weights (in ``spec['keys']`` order). Each
    weight's gradient is cast to the weight's dtype, as ``_cast_dwd``
    (pallas_ea_block.py:107-111) does."""

    @staticmethod
    def forward(ctx_, x, e_win, bias, spec, *weights):
        w = dict(zip(spec["keys"], weights))
        zx, ze, e1s, m1s = ea_block_fwd(x, e_win, w, bias, spec["ctx"],
                                        save_res=True, **spec["kw"])
        ctx_.save_for_backward(x, e_win, bias, e1s, m1s, *weights)
        ctx_.spec = spec
        return zx, ze

    @staticmethod
    def backward(ctx_, dzx, dze):
        x, e_win, bias, e1s, m1s, *weights = ctx_.saved_tensors
        spec = ctx_.spec
        w = dict(zip(spec["keys"], weights))
        dx, de_win, dw, dbias = ea_block_bwd(
            dzx.contiguous(), dze.contiguous(), e1s, m1s, x, e_win, w, bias,
            spec["ctx"], **spec["kw"])
        return (dx, de_win, dbias, None,
                *(dw[k].to(w[k].dtype) for k in spec["keys"]))


def block_weights(block, cdt: torch.dtype, encoder=None):
    """(w, bias) of a `models.blocks.GraphNetBlock` for the kernels: its
    Dense weights as [in, out] in ``cdt``, sliced into the kernels' dict
    (pallas_ea_block.py:964-1008), and the float32 bias stack; with an
    ``encoder`` (the model's edge_encoder MLP) also the zero-padded encoder
    weights and bias rows 8-10. Built from the parameters under autograd."""
    h = block.hidden_channels

    def k(lin):
        return lin.weight.t().to(cdt)

    k_e0 = k(block.edge_mlp.lin_0)
    k_p0 = k(block.node_mlp_phi.lin_0)
    w = dict(
        wer=k_e0[:h], wee=k_e0[2 * h:],
        wsp=torch.cat([k_e0[h:2 * h], k_p0[:h]], 1),
        we1=k(block.edge_mlp.lin_1), wpe=k_p0[h:],
        wp1=k(block.node_mlp_phi.lin_1),
        wg0=k(block.node_mlp_gamma.lin_0),
        wg1=k(block.node_mlp_gamma.lin_1),
        wb0=k(block.node_mlp_beta.lin_0),
        wb1=k(block.node_mlp_beta.lin_1))
    rows = [m.bias for m in (
        block.edge_mlp.lin_0, block.edge_mlp.lin_1, block.node_mlp_phi.lin_0,
        block.node_mlp_phi.lin_1, block.node_mlp_gamma.lin_0,
        block.node_mlp_gamma.lin_1, block.node_mlp_beta.lin_0,
        block.node_mlp_beta.lin_1)]
    if encoder is not None:
        k0, k1, k2 = k(encoder.lin_0), k(encoder.lin_1), k(encoder.lin_2)
        fe, c0 = k0.shape
        w.update(wen0=F.pad(k0, (0, ENC_HID - c0, 0, ENC_IN - fe)),
                 wen1=F.pad(k1, (0, 0, 0, ENC_HID - k1.shape[0])), wen2=k2)
        rows += [F.pad(encoder.lin_0.bias, (0, h - c0)),
                 F.pad(encoder.lin_1.bias, (0, h - ENC_HID)),
                 encoder.lin_2.bias]
    w = {key: v.contiguous() for key, v in w.items()}
    return w, torch.stack(rows).float()


def fused_ea_block(x, e_win, block, ctx: EAContext, *, skip: bool,
                   rate: float = 0.0, seed=None, deterministic: bool = True,
                   encoder=None, far_grad: str = "fold", far_local: int = 0,
                   x_full=None):
    """One full GraphNetBlock + skip + dropout (the JAX package's
    ``fused_ea_block``), differentiable in x, e_win and the parameters of
    ``block`` (and of ``encoder``). ``encoder`` (layer 0, requires
    `supports_fused_encoder`): ``e_win`` is then the raw [T, W, fe] window
    and the model's edge_encoder runs inside the call; the raw window
    carries no gradient. ``seed``: two ints, needed when training with
    ``rate`` > 0. Returns ``(zx, ze)``. Requires `supports_fused_ea`."""
    if far_grad != "fold" or x_full is not None:
        raise NotImplementedError(
            f"far_grad={far_grad!r} / x_full: the tile-sharded multi-chip EA "
            "path (ROADMAP queue 1, item 9)")
    rate = float(rate) if not deterministic else 0.0
    _check_dropout(rate, seed)
    enc = encoder is not None
    if enc:
        if skip:
            raise ValueError("encoder fusion is layer 0 (no skip)")
        fe = e_win.shape[2]
        e_win = F.pad(e_win.to(x.dtype), (0, ENC_IN - fe)).contiguous()
    w, bias = block_weights(block, x.dtype, encoder)
    kw = dict(skip=skip, rate=rate, seed=seed, enc=enc)
    keys = WKEYS + (ENC_WKEYS if enc else ())
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or e_win.requires_grad or bias.requires_grad
        or any(w[k].requires_grad for k in keys))
    if not needs_grad:
        return ea_block_fwd(x, e_win, w, bias, ctx, **kw)
    spec = dict(ctx=ctx, kw=kw, keys=keys)
    return _FusedBlock.apply(x, e_win, bias, spec, *(w[k] for k in keys))
