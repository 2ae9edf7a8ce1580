"""Time the band kernel (#4, and #2's band pass), the CSR segment sum (#7)
and the SAGE forward (#1, which shares the band kernel's phase-1 code) of
one copy of the port, on one CUDA card.

    python3 tools/band_csr_timing.py [ROOT [LABEL]]

ROOT is the directory that holds the ``buckgnn_tpu_torch`` package to time
(default: this checkout); run it once per copy, in turns in one session
(for example an unpacked ``git archive`` of the parent commit, then this
checkout, then both again), to compare two versions on one card. Prints
one JSON line: the card's name and power limit and, in device ms per call
(CUDA events over 30 calls after 3 warm-ups):

- ``banded_matmul`` at the virtual-edge cell's shape (``config="virtual"``:
  N = 103,424, tile 256, width 64, H = 512, the batch's spill window) on
  seeded bf16 x and acc, with the spill and acc terms both on (the split
  backward's dx, #4), acc alone (#2's band pass), spill alone, neither,
  and neither with a float32 output;
- ``csr_segment_sum`` on the csr-virtual cell's batch (the encoder output,
  H = 512) over the receiver CSR (``fwd``) and the transposed one
  (``bwd``), each also on a copy whose last row's run (the dead row's pad
  edges) is cut to 10 edges (``*_capped``); at H = 128; and on the
  800-degree hub graph of ``chip_smoke.py::hub_graph`` (``hub_fwd``);
- ``sage_layer_fwd`` serving, over 50 calls: on the flagship batch with
  the model's weights, local star windows, emit and skip (``fwd``), and
  its spill variant on the virtual-edge batch (``fwd_spill``), the
  operands as ``chip_smoke.py`` builds them (this checkout's script).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def event_ms(fn, reps=30, warmup=3):
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


def band_times(dev):
    from buckgnn_tpu_torch.bench import build_serve_setup
    from buckgnn_tpu_torch.ops import banded_matmul as bm
    from buckgnn_tpu_torch.ops.banded import make_agg_context

    b = build_serve_setup(device=dev, config="virtual")["batch"]
    g = torch.Generator(device=dev).manual_seed(1)
    x, acc = (torch.randn((b.n_node_cap, 512), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    band = make_agg_context(b).band
    spill = dict(spill_offsets=b.spill_offsets, spill_lo=b.spill_lo,
                 spill_hi=b.spill_hi,
                 spill_messages=x[b.spill_senders.long()].contiguous())
    base = dict(tile=b.band_tile, width=b.band_width,
                out_dtype=torch.bfloat16)
    cases = {"spill+acc": dict(base, acc=acc, **spill),
             "acc": dict(base, acc=acc), "spill": dict(base, **spill),
             "none": base, "none_f32": dict(base, out_dtype=torch.float32)}
    return {f"band_{k}": event_ms(lambda: bm.banded_matmul(band, x, **kw))
            for k, kw in cases.items()}


def csr_times(dev):
    from buckgnn_tpu_torch.bench import build_serve_setup
    from buckgnn_tpu_torch.ops import csr_segment as cs

    setup = build_serve_setup(device=dev, config="csr-virtual")
    bt = setup["batch"]
    ctx = cs.make_csr_context(bt.senders, bt.receivers, bt.n_node_cap)
    with torch.no_grad():
        x = setup["model"].node_encoder(bt.nodes)

    def run(x, idx, off):
        return event_ms(lambda: cs.csr_segment_sum(x, idx, off))

    def capped(idx, off, keep=10):
        last = off.numel() - 2
        off2 = off.clone()
        off2[last + 1] = off[last] + keep
        return idx[:int(off[last]) + keep].contiguous(), off2

    out = {"csr_fwd": run(x, ctx.senders, ctx.row_off),
           "csr_fwd_capped": run(x, *capped(ctx.senders, ctx.row_off)),
           "csr_bwd": run(x, ctx.t_idx, ctx.t_off),
           "csr_bwd_capped": run(x, *capped(ctx.t_idx, ctx.t_off)),
           "csr_fwd_h128": run(x[:, :128].contiguous(), ctx.senders,
                               ctx.row_off),
           "csr_dead_row_run": int(ctx.row_off[-1] - ctx.row_off[-2])}
    rng = np.random.default_rng(5)
    n = 512
    r = np.concatenate([rng.integers(0, n - 1, size=2000), np.full(800, 3)])
    s = rng.integers(0, n - 1, size=len(r))
    order = np.argsort(r, kind="stable")
    hs, hr = (torch.from_numpy(a[order].astype(np.int32)).to(dev)
              for a in (s, r))
    hub = cs.make_csr_context(hs, hr, n)
    xh = torch.randn((n, 512), device=dev).to(torch.bfloat16)
    out["hub_fwd"] = run(xh, hub.senders, hub.row_off)
    return out


def fwd_times(dev):
    from buckgnn_tpu_torch.bench import build_serve_setup
    from buckgnn_tpu_torch.ops import sage_layer as sl

    sys.path.insert(1, REPO)
    import chip_smoke

    out = {}
    for name, config in (("fwd", "flagship"), ("fwd_spill", "virtual")):
        setup = build_serve_setup(device=dev, config=config)
        b, model = setup["batch"], setup["model"]
        with torch.no_grad():
            x0 = model.node_encoder(b.nodes)
            w = model.shared_graphsage_block.fused_weights(x0.dtype)
        if b.has_spill_edges:
            args, kw = chip_smoke.spill_inputs(b, x0, w, True)
        else:
            args, kw, _ = chip_smoke.layer_inputs(b, x0, w, True, True, True)
        out[name] = event_ms(lambda: sl.sage_layer_fwd(*args, **kw), reps=50)
    return out


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
    label = sys.argv[2] if len(sys.argv) > 2 else root
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, root)
    import buckgnn_tpu_torch

    if not buckgnn_tpu_torch.__file__.startswith(root):
        sys.exit(f"imported {buckgnn_tpu_torch.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(json.dumps({"label": label, "card": card, **band_times(dev),
                      **csr_times(dev), **fwd_times(dev)}), flush=True)


if __name__ == "__main__":
    main()
