"""Drive the PyTorch/CUDA port (buckgnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require CUDA; print the card's name and power limit; turn TF32 off;
  2. build every CUDA kernel of the port from the sources (nvcc, sm_90a),
     one nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card, at the
     flagship shape (weights with a nonzero bias) and on one small ragged
     batch: the forward's serving and training variants (z, the emitted
     table, the residuals y, inv and agg, and the dropped positions at
     dropout 0.1), and the backward (dx, dW_l, dW_r, db_l and the own star
     table, with the next layer's star on and off, the skip on and off, at
     dropout 0 and 0.1); show that the gates fail a wrong norm, a dropped
     bias, a norm backward without its s term and a backward that ignores
     the next layer's star;
  4. serve the flagship model (6 layers, hidden 512, bf16, 128 supernode
     panels) through eval_step: a few requests on the packed batch, the
     serving benchmark and the INFERENCE_TIMER protocol; check the kernel
     launch counts and finite outputs, and hold the whole forward against
     the plain path on the card. Then train it (dropout 0.1, Adam, lr
     1e-3): a few checked steps, the training benchmark and a profile of
     the step, with the launch counts of that run (6 of each kernel per
     step); and hold one step's loss and gradients against the plain path
     on the card, from the same dropout seeds;
  5. time each kernel beside its bound, its plain version and a PyTorch
     composition of the same function.
Prints JSON lines (serving and training numbers, then the kernel table),
the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import torch

from buckgnn_tpu_torch.bench import (
    build_serve_setup, build_train_setup, pack_exact, run_serve_bench,
    run_train_bench,
)
from buckgnn_tpu_torch.eval.timer import time_gnn_forward
from buckgnn_tpu_torch.graph.batch import select_band_geometry, star_table_geometry
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context
from buckgnn_tpu_torch.ops.dropout import dropout_scale, keep_mask
from buckgnn_tpu_torch.utils import cuda_build

# kernel vs plain (allclose-style, atol + rtol * |ref|), reasons beside
# their definitions: z within sl.KERNEL_Z_TOL, the emitted table within
# sl.KERNEL_TABLE_TOL of the plain emission of the kernel's own z.
# whole 6-layer forward, kernel path vs plain path: the per-layer bf16
# flips are averaged by the mean pool over ~800 rows, so pred (|pred| ~
# 0.1) moved by about 1e-4 on the card; 2e-3 leaves room for other data.
PRED_TOL = (2e-3, 2e-3)
# one train step, kernel path vs plain path from the same dropout seeds:
# the loss as the forward's pred; each parameter's gradient by the norm of
# its difference over its norm. Each layer's bf16 roundings (z, dout, dagg,
# dx) can flip to the neighbouring value, 2^-8 relative, in a small share
# of entries, and the gradients are sums over ~1e5 rows of such products:
# flips of random sign move them by far less than 1%; a wrong mask, a lost
# star or a lost norm term moves them by O(1).
GRAD_TOL = 2e-2
PEAK_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM (data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM (data sheet)
TPU_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:231"
TPU_BWD_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:706"
SEED = (0x1234567, 0x89ABCDEF)  # dropout seed words of the layer checks
RATE = 0.1  # the flagship's dropout rate (TrainConfig default)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def within(got, ref, tol):
    atol, rtol = tol
    err = (got.float() - ref.float()).abs()
    ok = (bool(torch.isfinite(got.float()).all())
          and not bool((err > atol + rtol * ref.float().abs()).any()))
    return ok, float(err.max())


def check_close(name, got, ref, tol):
    ok, max_err = within(got, ref, tol)
    print(json.dumps({"check": name, "max_abs_err": max_err, "atol": tol[0],
                      "rtol": tol[1], "ok": ok}))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {max_err})")
    return max_err


def check_caught(name, wrong, ref, tol):
    """A deliberately wrong layer output must fail the gate `tol`."""
    ok, max_err = within(wrong, ref, tol)
    print(json.dumps({"gate": name, "max_abs_err": max_err, "atol": tol[0],
                      "rtol": tol[1], "caught": not ok}))
    if ok:
        fail(f"{name}: the kernel-vs-plain gate lets a wrong layer pass")


def check_weights(h, x, mask, seed):
    """(W_l, b_l, W_r) in bf16 from a seeded generator: lecun-normal
    weights and a bias as large as a row of x @ W_r (|x| rms per entry),
    so a kernel that drops or misplaces b_l fails the z gate."""
    g = torch.Generator().manual_seed(seed)
    w_l, w_r = (torch.randn(h, h, generator=g) / math.sqrt(h)
                for _ in range(2))
    rms = float(x[mask].float().pow(2).mean().sqrt())
    b_l = torch.randn(h, generator=g) * rms
    return tuple(t.to(x.device, torch.bfloat16) for t in (w_l, b_l, w_r))


def layer_inputs(batch, x, weights, windows, emit, skip):
    if not windows:
        batch = batch.replace(gwin=None, lcode=None, lacc=None)
    code, gwin, gw, acc = sl.star_codes(batch)
    t0, tg = star_table_geometry(batch.n_graph_cap)
    table = sl._super_tables(x, batch.node_graph, batch.node_mask,
                             batch.supernode_index, batch.n_graph_cap, tg)
    w_l, b_l, w_r = weights
    kw = dict(tile=batch.band_tile, width=batch.band_width, table=table,
              code=code, gwin=gwin, gw=gw, t0=t0,
              acc_code=acc if emit else None, skip=skip, emit=emit)
    return (x, w_l, b_l, w_r, make_agg_context(batch).band), kw, batch


def kernel_vs_plain(name, batch, x, weights, windows, emit, skip):
    args, kw, b = layer_inputs(batch, x, weights, windows, emit, skip)
    z, tab = sl.sage_layer_fwd(*args, **kw)
    zp, _ = sl.sage_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    m = b.node_mask
    err = check_close(f"{name}/z", z[m], zp[m], sl.KERNEL_Z_TOL)
    if emit:
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], kw["tile"])
        err = max(err, check_close(f"{name}/table", tab, tabp,
                                   sl.KERNEL_TABLE_TOL))
    return err


def gate_catches_faults(batch, x, weights):
    """The z gate fails a layer whose norm is rsqrt of 7/8 of the sum of
    squares (z = relu(y) scaled by sqrt(8/7) without the skip), and one
    that drops b_l: both from the plain version on the flagship inputs."""
    args, kw, b = layer_inputs(batch, x, weights, True, False, False)
    m = b.node_mask
    zp, _ = sl.sage_layer_plain(*args, **kw)
    scaled = (zp.float() * math.sqrt(8 / 7)).to(zp.dtype)
    check_caught("flagship/norm-7/8", scaled[m], zp[m], sl.KERNEL_Z_TOL)
    args = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
    no_bias, _ = sl.sage_layer_plain(*args, **kw)
    check_caught("flagship/no-bias", no_bias[m], zp[m], sl.KERNEL_Z_TOL)


def train_fwd_vs_plain(name, batch, x, weights, windows, emit):
    """The training variant (skip on, dropout RATE) against the plain one:
    z and the residuals within their gates, and the dropped positions
    exactly those of the hashed keep mask on both sides."""
    args, kw, b = layer_inputs(batch, x, weights, windows, emit, True)
    kw.update(save_res=True, rate=RATE, seed=SEED)
    z, tab, y, inv, agg = sl.sage_layer_fwd(*args, **kw)
    zp, _, yp, invp, aggp = sl.sage_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    m = b.node_mask
    err = 0.0
    for what, got, ref, tol in (("z", z, zp, sl.KERNEL_Z_TOL),
                                ("y", y, yp, sl.KERNEL_Z_TOL),
                                ("agg", agg, aggp, sl.KERNEL_Z_TOL),
                                ("inv", inv, invp, sl.KERNEL_INV_TOL)):
        e = check_close(f"{name}/train/{what}", got[m], ref[m], tol)
        if what != "inv":
            err = max(err, e)
    # dropped entries are zero on both sides; a kept entry the plain
    # version holds above the z gate's atol is nonzero in the kernel (a
    # kept entry near zero may round to zero on one side only)
    dropped = ~keep_mask(SEED, x.shape[0], x.shape[1], RATE, x.device)
    kept_big = ~dropped & (zp.float().abs() > sl.KERNEL_Z_TOL[0])
    same = (bool((z[dropped] == 0).all()) and bool((zp[dropped] == 0).all())
            and bool((z[kept_big] != 0).all()))
    print(json.dumps({"check": f"{name}/train/dropped",
                      "share": float(dropped.float().mean()), "ok": same}))
    if not same:
        fail(f"{name}: the kernel drops other positions than the plain "
             "version")
    if emit:
        tabp = sl.emit_table_plain(z, kw["acc_code"], kw["gwin"], kw["gw"],
                                   kw["t0"], kw["tile"])
        err = max(err, check_close(f"{name}/train/table", tab, tabp,
                                   sl.KERNEL_TABLE_TOL))
    return err


def bwd_inputs(batch, x, weights, windows, apply_prev, skip, rate, seed):
    """Arguments of one backward call: the residuals of the kernel's own
    training forward, a seeded dz of x's scale and (apply_prev) a seeded
    next-layer table of a star sum's scale."""
    args, kw, b = layer_inputs(batch, x, weights, windows, False, skip)
    fkw = dict(kw, save_res=True, rate=rate, seed=SEED if rate else None)
    _, _, y, inv, agg = sl.sage_layer_fwd(*args, **fkw)
    g = torch.Generator(device=x.device).manual_seed(seed)
    dz = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    code, gwin, gw, acc = sl.star_codes(b)
    bkw = dict(tile=kw["tile"], width=kw["width"], code=code, gwin=gwin,
               gw=gw, t0=kw["t0"], acc_code=acc, has_super=True, skip=skip,
               rate=rate, seed=SEED if rate else None)
    if apply_prev:
        bkw["table_prev"] = (torch.randn(kw["table"].shape, generator=g,
                                         device=x.device) * 8).to(x.dtype)
    x_, w_l, _, w_r, band = args
    return (dz, y, inv, agg, x_, w_l, w_r, band), bkw, b


BWD_NAMES = ("dx", "dw_l", "dw_r", "db_l", "town")


def bwd_errors(got, ref, node_mask):
    """{output: (ok, max abs err)} of the backward's gates."""
    out = {}
    for name, g, r in zip(BWD_NAMES, got, ref):
        if name == "dx":
            g, r = g[node_mask], r[node_mask]
        out[name] = within(g, r, sl.gate_tol(r, sl.KERNEL_BWD_TOL[name]))
    return out


def bwd_vs_plain(name, batch, x, weights, windows, apply_prev, skip, rate):
    args, kw, b = bwd_inputs(batch, x, weights, windows, apply_prev, skip,
                             rate, seed=3)
    got = sl.sage_layer_bwd(*args, **kw)
    ref = sl.sage_layer_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = bwd_errors(got, ref, b.node_mask)
    ok = all(v[0] for v in errs.values())
    print(json.dumps({"check": f"{name}/bwd", "ok": ok,
                      "max_abs_err": {k: v[1] for k, v in errs.items()},
                      "tol": sl.KERNEL_BWD_TOL}))
    if not ok:
        fail(f"{name}/bwd: kernel disagrees with its plain version {errs}")
    return max(v[1] for v in errs.values())


def bwd_gate_catches_faults(batch, x, weights):
    """The backward gates fail a plain backward whose norm backward drops
    its s term (dout = dy * inv) and one that ignores the next layer's
    star table, each held against the kernel on the flagship inputs."""
    args, kw, b = bwd_inputs(batch, x, weights, True, True, True, RATE,
                             seed=4)
    got = sl.sage_layer_bwd(*args, **kw)
    real = sl._norm_backward
    sl._norm_backward = lambda dz, y, inv: torch.where(y > 0.0, dz, 0.0) * inv
    try:
        no_s = sl.sage_layer_bwd_plain(*args, **kw)
    finally:
        sl._norm_backward = real
    no_prev = sl.sage_layer_bwd_plain(*args, **dict(kw, table_prev=None))
    for fault, wrong in (("no-s-term", no_s), ("no-apply-prev", no_prev)):
        errs = bwd_errors(wrong, got, b.node_mask)
        caught = not all(v[0] for v in errs.values())
        print(json.dumps({"gate": f"flagship/bwd/{fault}", "caught": caught,
                          "max_abs_err": {k: v[1] for k, v in errs.items()}}))
        if not caught:
            fail(f"{fault}: the backward gate lets a wrong backward pass")


def event_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def library_layer(x, w_l, b_l, w_r, band, *, tile, width, table, code, gwin,
                  gw, t0, acc_code, skip, emit):
    """The same layer as one PyTorch composition in bf16 (bmm + matmul +
    norm), a yardstick only: the port never calls it."""
    n, h = x.shape
    nt = n // tile
    starts = sl._slab_starts(n, tile, width, x.device)
    xs = x[starts[:, None] + torch.arange(tile + width, device=x.device)]
    acc = torch.bmm(band.to(x.dtype), xs)
    rows = sl._window_rows(gwin, gw, t0, nt, x.device)
    sel = (code.reshape(nt, tile, 1)
           == torch.arange(2 * gw, device=x.device)).to(x.dtype)
    agg = (acc + torch.bmm(sel, table[rows])).reshape(n, h)
    out = torch.addmm(b_l, agg, w_l) + x @ w_r
    y = out * torch.rsqrt((out.float() ** 2).sum(-1, keepdim=True)
                          .clamp_min(1e-24)).to(x.dtype)
    z = torch.relu(y) + x if skip else torch.relu(y)
    ftab = None
    if emit:
        sela = (acc_code.reshape(nt, 1, tile)
                == torch.arange(2 * gw, device=x.device)[:, None]).to(x.dtype)
        tb = torch.bmm(sela, z.reshape(nt, tile, h)).float()
        ftab = torch.zeros((2 * t0, h), dtype=torch.float32, device=x.device)
        ftab.index_add_(0, rows.reshape(-1), tb.reshape(-1, h))
    return z, ftab


def library_bwd(dz, y, inv, agg, x, w_l, w_r, band, *, keep, tile, width,
                table_prev, code, gwin, gw, t0, acc_code, has_super, skip,
                rate, seed):
    """The same backward as a PyTorch composition in bf16 (gathers, bmm,
    matmul, index_add), a yardstick only: the port never calls it. The
    keep mask comes in precomputed (``keep``), as a library dropout would
    store it."""
    n, h = x.shape
    nt = n // tile
    rows = sl._window_rows(gwin, gw, t0, nt, x.device)
    sel = (code.reshape(nt, tile, 1)
           == torch.arange(2 * gw, device=x.device)).to(x.dtype)
    dze = dz + torch.bmm(sel, table_prev[rows]).reshape(n, h)
    if rate:
        dze = torch.where(keep, dze * dropout_scale(rate), 0.0)
    yf = y.float()
    dy = torch.where(yf > 0, dze.float(), 0.0)
    dout = ((dy - yf * (dy * yf).sum(-1, keepdim=True))
            * inv[:, None]).to(x.dtype)
    both = dout @ torch.cat([w_l.t(), w_r.t()], 1)
    dagg, dxp = both[:, :h], both[:, h:]
    if skip:
        dxp = dxp + dze
    dw = torch.cat([agg, x], 1).t() @ dout
    db = dout.float().sum(0)
    sela = (acc_code.reshape(nt, 1, tile)
            == torch.arange(2 * gw, device=x.device)[:, None]).to(x.dtype)
    tb = torch.bmm(sela, dagg.reshape(nt, tile, h)).float()
    town = torch.zeros((2 * t0, h), dtype=torch.float32, device=x.device)
    town.index_add_(0, rows.reshape(-1), tb.reshape(-1, h))
    starts = sl._slab_starts(n, tile, width, x.device)
    slab = dagg[starts[:, None] + torch.arange(tile + width,
                                               device=x.device)]
    dx = dxp + torch.bmm(band.to(x.dtype), slab).reshape(n, h)
    return dx, dw[:h], dw[h:], db, town


def layer_bound(args, kw):
    """Least time for one layer call: each input read once and each output
    written once at the HBM rate, against its dense bf16 products at the
    tensor-core peak."""
    x, w_l, b_l, w_r, band = args
    n, h = x.shape
    s = kw["tile"] + kw["width"]
    g2 = 2 * kw["gw"]
    flops = 2 * n * s * h + 2 * n * g2 * h + 2 * 2 * n * h * h
    ins = [x, w_l, b_l, w_r, band, kw["table"], kw["code"], kw["gwin"],
           kw["acc_code"]]
    nbytes = sum(t.numel() * t.element_size() for t in ins if t is not None)
    nbytes += x.numel() * x.element_size()  # z
    if kw["emit"]:
        flops += 2 * n * g2 * h
        nbytes += kw["table"].shape[0] * h * 4  # ftab
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def bwd_bound(args, kw):
    """Least time for one backward call: [dagg | dxp] = dout @ [W_l^T |
    W_r^T] and dW = [agg | x]^T @ dout (4 N H^2 each), the band product
    (2 N (T+W) H) and the two star selections (2 N 2GW H each, one without
    apply_prev) at the bf16 tensor-core peak, against each input read once
    and each output written once at the HBM rate."""
    dz, y, inv, agg, x, w_l, w_r, band = args
    n, h = x.shape
    g2 = 2 * kw["gw"]
    stars = 2 if kw.get("table_prev") is not None else 1
    flops = (8 * n * h * h + 2 * n * (kw["tile"] + kw["width"]) * h
             + stars * 2 * n * g2 * h)
    ins = [dz, y, inv, agg, x, w_l, w_r, band, kw.get("table_prev"),
           kw["code"], kw["gwin"], kw["acc_code"]]
    nbytes = sum(t.numel() * t.element_size() for t in ins if t is not None)
    nbytes += x.numel() * x.element_size() + (2 * h * h + h) * 4  # dx, dW, db
    nbytes += 2 * kw["t0"] * h * 4  # town
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def step_profile(label, step, step_ms, card, steps=3):
    """Device time of a few steps by kernel (torch.profiler), and the
    device's busy share of the host-clock step time. Only the device-side
    kernel events count: an operator's own row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"profile": f"{label}, device ms per step by kernel",
            "card": card, "device_ms": busy_ms, "step_ms": step_ms,
            "busy_share": busy_ms / step_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": c // steps}
                    for k, ms, c in rows[:14]]}


def step_grads(setup, gen_seed):
    """Loss and every parameter's gradient of one train-step forward and
    backward (no optimizer step), dropout seeds from ``gen_seed``."""
    from buckgnn_tpu_torch.train.losses import get_loss_function
    from buckgnn_tpu_torch.train.trainer import make_loss_and_metrics

    model, batch, cfg = setup["state"].model, setup["batch"], setup["cfg"]
    compute_loss, _ = make_loss_and_metrics(
        get_loss_function(cfg.loss_function), cfg, setup["normalizer"])
    model.zero_grad(set_to_none=True)
    pred, aux = model(batch, deterministic=False,
                      generator=torch.Generator().manual_seed(gen_seed))
    loss = compute_loss(pred, aux, batch)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def train_vs_plain(setup):
    """One train step's loss and gradients, kernel path against the plain
    path on the card, from the same dropout seeds."""
    loss, grads = step_grads(setup, gen_seed=11)
    real = sl._launch, sl._launch_bwd
    sl._launch, sl._launch_bwd = sl.sage_layer_plain, sl.sage_layer_bwd_plain
    try:
        loss_p, grads_p = step_grads(setup, gen_seed=11)
    finally:
        sl._launch, sl._launch_bwd = real
    check_close("flagship/train/loss", loss, loss_p, PRED_TOL)
    rel = {k: float((grads[k].float() - grads_p[k].float()).norm()
                    / grads_p[k].float().norm().clamp_min(1e-30))
           for k in grads}
    ok = all(bool(torch.isfinite(g).all()) for g in grads.values()) and \
        max(rel.values()) <= GRAD_TOL
    print(json.dumps({"check": "flagship/train/grads", "ok": ok,
                      "tol": GRAD_TOL, "rel_err": rel}))
    if not ok:
        fail(f"train-step gradients: kernel path disagrees with the plain "
             f"path {rel}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": built}))
    for name in cuda_build.SOURCES:
        with open(cuda_build.lib_path(name)[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"{name} ptxas: {line.strip()}")

    # ---- flagship setup -------------------------------------------------
    t0 = time.perf_counter()
    setup = build_serve_setup(device=dev)
    batch, model = setup["batch"], setup["model"]
    print(json.dumps({
        "setup_s": time.perf_counter() - t0, "n_node_cap": batch.n_node_cap,
        "n_real_nodes": int(batch.node_mask.sum()),
        "n_edges": setup["n_edges"], "n_graphs": setup["n_graphs"],
        "band_tile": batch.band_tile, "band_width": batch.band_width,
        "local_windows": batch.gwin is not None,
        "spill": batch.has_spill_edges}))
    if batch.gwin is None or batch.has_spill_edges:
        fail("flagship batch must have local star windows and no spill")
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        weights = model.shared_graphsage_block.fused_weights(x0.dtype)

    # ---- 3. kernel vs plain --------------------------------------------
    # the model's bias starts at zero: the checks draw their own weights
    tw = check_weights(x0.shape[1], x0, batch.node_mask, seed=1)
    errs = [
        kernel_vs_plain("flagship/local+emit/skip", batch, x0, tw,
                        True, True, True),
        kernel_vs_plain("flagship/local/noskip", batch, x0, tw,
                        True, False, False),
        kernel_vs_plain("flagship/full-table/skip", batch, x0, tw,
                        False, False, True),
        train_fwd_vs_plain("flagship/local+emit", batch, x0, tw, True, True),
        train_fwd_vs_plain("flagship/full-table", batch, x0, tw, False,
                           False),
    ]
    gate_catches_faults(batch, x0, tw)
    bwd_errs = [
        bwd_vs_plain(f"flagship/local/prev{int(p)}/skip{int(k)}/rate{r}",
                     batch, x0, tw, True, p, k, r)
        for p in (True, False) for k in (True, False) for r in (0.0, RATE)]
    bwd_errs.append(bwd_vs_plain("flagship/full-table/prev1/skip1",
                                 batch, x0, tw, False, True, True, RATE))
    bwd_gate_catches_faults(batch, x0, tw)
    small = normalize_dataset(generate_dataset(
        7, seed=5, min_side=10, max_side=20, use_super_node=True,
        use_virtual_edges=False))[0]
    sb = pack_exact(small, 7, 64, 256, dev)
    with torch.no_grad():
        xs = model.node_encoder(sb.nodes)
    sw = check_weights(xs.shape[1], xs, sb.node_mask, seed=2)
    local = sb.gwin is not None
    rname = f"ragged/n{sb.n_node_cap}"
    errs.append(kernel_vs_plain(f"{rname}/local+emit/skip", sb, xs, sw,
                                local, local, True))
    errs.append(train_fwd_vs_plain(rname, sb, xs, sw, local, local))
    bwd_errs += [bwd_vs_plain(f"{rname}/prev1/skip{int(k)}", sb, xs, sw,
                              local, True, k, RATE) for k in (True, False)]
    bwd_errs.append(bwd_vs_plain(f"{rname}/full-table/prev1/skip1", sb, xs,
                                 sw, False, True, True, RATE))

    # ---- 4a. serving: a main path ----------------------------------------
    eval_step = setup["eval_step"]
    forwards = [0]

    def counted(b):
        forwards[0] += 1
        return eval_step(b)

    sample = setup["dataset"][0]
    tile, width = select_band_geometry([sample])
    sl.reset_launch_counts()
    answers = [counted(batch) for _ in range(3)]
    serve = run_serve_bench(dict(setup, eval_step=counted), n_warmup=2,
                            n_steps=10)
    timer = time_gnn_forward(counted, sample, batch_size=128, n_warmup=2,
                             n_timed=10, device=dev,
                             band_kw=dict(band_tile=tile, band_width=width,
                                          rcm=True))
    torch.cuda.synchronize()
    serve_launches = dict(sl.LAUNCHES)
    want = model.num_layers * forwards[0]
    print(json.dumps({"path": "serve", "forwards": forwards[0],
                      "launches": serve_launches,
                      "expected_sage_layer_fwd": want}))
    if serve_launches != {"sage_layer_fwd": want, "sage_layer_bwd": 0}:
        fail(f"serving launched {serve_launches}, expected {want} forward "
             "launches and no backward")
    g = batch.graph_mask
    for m, (pred, _) in answers:
        if pred.shape != (batch.n_graph_cap,) or not bool(
                torch.isfinite(pred[g].float()).all()):
            fail("non-finite or misshapen prediction")
        if not all(math.isfinite(float(v)) for v in m.values()):
            fail(f"non-finite loss/metrics {m}")

    # whole forward against the plain path on the card
    real_launch = sl._launch
    sl._launch = sl.sage_layer_plain
    try:
        mp, (pred_p, _) = eval_step(batch)
    finally:
        sl._launch = real_launch
    m, (pred, _) = answers[-1]
    check_close("flagship/forward/pred", pred[g], pred_p[g], PRED_TOL)
    check_close("flagship/forward/loss", m["loss"], mp["loss"], PRED_TOL)
    check_close("flagship/forward/mape", m["mape"], mp["mape"], PRED_TOL)
    print(json.dumps(step_profile(
        "flagship serve step", lambda: eval_step(batch),
        serve["infer_step_ms"], card)))

    # ---- 4b. training: this slice's main path ----------------------------
    t0 = time.perf_counter()
    train = build_train_setup(device=dev)
    tmodel, tbatch = train["state"].model, train["batch"]
    print(json.dumps({"train_setup_s": time.perf_counter() - t0,
                      "dropout_rate": tmodel.dropout_rate,
                      "lr": train["lr"],
                      "weight_decay": train["cfg"].weight_decay}))
    step, steps = train["train_step"], [0]

    def counted_step(b, lr, gen):
        steps[0] += 1
        return step(b, lr, gen)

    before = {k: p.detach().clone() for k, p in tmodel.named_parameters()}
    sl.reset_launch_counts()
    checked = [counted_step(tbatch, train["lr"], train["generator"])
               for _ in range(3)]
    bench = run_train_bench(dict(train, train_step=counted_step),
                            n_warmup=2, n_steps=10)
    torch.cuda.synchronize()
    train_launches = dict(sl.LAUNCHES)
    want = tmodel.num_layers * steps[0]
    print(json.dumps({"path": "train", "steps": steps[0],
                      "launches": train_launches,
                      "expected_each": want}))
    if train_launches != {"sage_layer_fwd": want, "sage_layer_bwd": want}:
        fail(f"training launched {train_launches}, expected {want} of each")
    losses = [float(mt["loss"]) for mt in checked]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss {losses}")
    for k, p in tmodel.named_parameters():
        if not bool(torch.isfinite(p).all()):
            fail(f"non-finite parameter {k} after training")
        if torch.equal(p.detach(), before[k]):
            fail(f"parameter {k} did not change in training")
    train_vs_plain(train)
    print(json.dumps(step_profile(
        "flagship train step",
        lambda: step(tbatch, train["lr"], train["generator"]),
        bench["train_step_ms"], card)))

    # ---- 5. kernel timing at the main path's shape ----------------------
    args, kw, _ = layer_inputs(batch, x0, weights, True, True, True)
    ms = event_ms(lambda: sl.sage_layer_fwd(*args, **kw))
    plain_ms = event_ms(lambda: sl.sage_layer_plain(*args, **kw), reps=5)
    lib_ms = event_ms(lambda: library_layer(*args, **kw))
    bound_ms, bound_by, flops, nbytes = layer_bound(args, kw)
    # the training variant: residuals and dropout (the bound adds y, agg
    # and inv to the bytes written)
    tkw = dict(kw, save_res=True, rate=RATE, seed=SEED)
    train_ms = event_ms(lambda: sl.sage_layer_fwd(*args, **tkw))
    train_plain_ms = event_ms(lambda: sl.sage_layer_plain(*args, **tkw),
                              reps=5)
    n, h = x0.shape
    res_bytes = 2 * n * h * x0.element_size() + n * 4
    train_bound_ms = max(flops / PEAK_BF16,
                         (nbytes + res_bytes) / PEAK_BYTES) * 1e3
    bargs, bkw, _ = bwd_inputs(batch, x0, weights, True, True, True, RATE,
                               seed=5)
    bwd_ms = event_ms(lambda: sl.sage_layer_bwd(*bargs, **bkw))
    bwd_plain_ms = event_ms(lambda: sl.sage_layer_bwd_plain(*bargs, **bkw),
                            reps=5)
    keep = keep_mask(SEED, n, h, RATE, dev)
    bwd_lib_ms = event_ms(lambda: library_bwd(*bargs, keep=keep, **bkw))
    bwd_bound_ms, bwd_bound_by, bwd_flops, bwd_bytes = bwd_bound(bargs, bkw)

    print(json.dumps({
        "serve": "flagship 6L h512 bf16, 128 supernode panels",
        "card": card, "infer_step_ms": serve["infer_step_ms"],
        "infer_samples_per_s": serve["infer_samples_per_s"],
        "infer_edges_per_s": serve["infer_edges_per_s"],
        "n_edges": serve["n_edges"], "n_graphs": serve["n_graphs"],
        "loss": serve["metrics"]["loss"], "mape": serve["metrics"]["mape"],
        "timer_batch_ms": timer["batch_time_s"] * 1e3,
        "timer_samples_per_s": timer["samples_per_s"],
        "timer_latency_per_sample_ms": timer["latency_per_sample_ms"],
        "timer_n_node_cap": timer["n_node_cap"],
        "layer_flops": flops, "layer_bytes": nbytes}))
    print(json.dumps({
        "train": "flagship 6L h512 bf16, 128 supernode panels, dropout 0.1, "
                 "Adam lr 1e-3",
        "card": card, "train_step_ms": bench["train_step_ms"],
        "train_edges_per_s": bench["train_edges_per_s"],
        "n_edges": bench["n_edges"], "n_graphs": bench["n_graphs"],
        "checked_losses": losses, "loss": bench["metrics"]["loss"],
        "mape": bench["metrics"]["mape"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    print(json.dumps({
        "kernel": "sage_layer_fwd, training variant (save_res, dropout 0.1)",
        "card": card, "ms": train_ms, "plain_ms": train_plain_ms,
        "bound_ms": train_bound_ms, "serving_ms": ms}))
    print(json.dumps({
        "kernel": "sage_layer_bwd", "card": card, "ms": bwd_ms,
        "plain_ms": bwd_plain_ms, "library_ms": bwd_lib_ms,
        "bound_ms": bwd_bound_ms, "flops": bwd_flops, "bytes": bwd_bytes}))
    print(json.dumps({"kernels": [{
        "name": "sage_layer_fwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_fwd.cu",
        "replaces": TPU_KERNEL,
        "launches": train_launches["sage_layer_fwd"],
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
    }, {
        "name": "sage_layer_bwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_bwd.cu",
        "replaces": TPU_BWD_KERNEL,
        "launches": train_launches["sage_layer_bwd"],
        "max_abs_err": max(bwd_errs), "ms": bwd_ms,
        "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": bwd_lib_ms,
    }], "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
