"""Drive the PyTorch/CUDA port (buckgnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require CUDA; print the card's name and power limit; turn TF32 off;
  2. build every CUDA kernel of the port from the sources (nvcc, sm_90a),
     all sources at once;
  3. hold each kernel against its plain PyTorch version on the card, at the
     flagship shape (weights with a nonzero bias) and on one small ragged
     batch, and show that the gate fails a wrong norm and a dropped bias;
  4. serve the flagship model (6 layers, hidden 512, bf16, 128 supernode
     panels) through eval_step: a few requests on the packed batch, the
     serving benchmark and the INFERENCE_TIMER protocol; check the kernel
     launch counts and finite outputs, and hold the whole forward against
     the plain path on the card;
  5. time each kernel beside its bound, its plain version and a PyTorch
     composition of the same layer.
Prints JSON lines (serving numbers, then the kernel table), the
nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import torch

from buckgnn_tpu_torch.bench import build_serve_setup, pack_exact, run_serve_bench
from buckgnn_tpu_torch.eval.timer import time_gnn_forward
from buckgnn_tpu_torch.graph.batch import select_band_geometry, star_table_geometry
from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import sage_layer as sl
from buckgnn_tpu_torch.ops.banded import make_agg_context
from buckgnn_tpu_torch.utils import cuda_build

# kernel vs plain (allclose-style, atol + rtol * |ref|), reasons beside
# their definitions: z within sl.KERNEL_Z_TOL, the emitted table within
# sl.KERNEL_TABLE_TOL of the plain emission of the kernel's own z.
# whole 6-layer forward, kernel path vs plain path: the per-layer bf16
# flips are averaged by the mean pool over ~800 rows, so pred (|pred| ~
# 0.1) moved by about 1e-4 on the card; 2e-3 leaves room for other data.
PRED_TOL = (2e-3, 2e-3)
PEAK_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM (data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM (data sheet)
TPU_KERNEL = "buckgnn_tpu/ops/pallas_sage_layer.py:231"


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


def serve_profile(eval_step, batch, step_ms, card, steps=3):
    """Device time of a few serve steps by kernel (torch.profiler), and the
    device's busy share of the host-clock step time. Only the device-side
    kernel events count: an operator's own row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eval_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eval_step(batch)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"profile": "flagship serve step, device ms per step by kernel",
            "card": card, "device_ms": busy_ms, "step_ms": step_ms,
            "busy_share": busy_ms / step_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": c // steps}
                    for k, ms, c in rows[:12]]}


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
    ]
    gate_catches_faults(batch, x0, tw)
    small = normalize_dataset(generate_dataset(
        7, seed=5, min_side=10, max_side=20, use_super_node=True,
        use_virtual_edges=False))[0]
    sb = pack_exact(small, 7, 64, 256, dev)
    with torch.no_grad():
        xs = model.node_encoder(sb.nodes)
    errs.append(kernel_vs_plain(
        f"ragged/n{sb.n_node_cap}/local+emit/skip", sb, xs,
        check_weights(xs.shape[1], xs, sb.node_mask, seed=2),
        sb.gwin is not None, sb.gwin is not None, True))

    # ---- 4. serving: the main path -------------------------------------
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
    launches = dict(sl.LAUNCHES)
    want = model.num_layers * forwards[0]
    print(json.dumps({"forwards": forwards[0], "launches": launches,
                      "expected_sage_layer_fwd": want}))
    if launches["sage_layer_fwd"] != want:
        fail(f"sage_layer_fwd launched {launches['sage_layer_fwd']} times, "
             f"expected {want}")
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

    # ---- 5. kernel timing at the main path's shape ----------------------
    args, kw, _ = layer_inputs(batch, x0, weights, True, True, True)
    ms = event_ms(lambda: sl.sage_layer_fwd(*args, **kw))
    plain_ms = event_ms(lambda: sl.sage_layer_plain(*args, **kw), reps=5)
    lib_ms = event_ms(lambda: library_layer(*args, **kw))
    bound_ms, bound_by, flops, nbytes = layer_bound(args, kw)

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
    print(json.dumps(serve_profile(eval_step, batch, serve["infer_step_ms"],
                                   card)))
    print(json.dumps({"kernels": [{
        "name": "sage_layer_fwd", "route": "cuda",
        "source": "buckgnn_tpu_torch/csrc/sage_layer_fwd.cu",
        "replaces": TPU_KERNEL,
        "launches": launches["sage_layer_fwd"],
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
    }], "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
