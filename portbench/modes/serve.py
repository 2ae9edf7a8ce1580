"""The serve loop: one client in a closed loop, the way a screening
script waits for each answer.

Set-up makes ``batches`` batches of distinct panels, builds and normalizes
their graphs together (one fitted normalizer, as a deployment has) and
packs each batch, builds the port's model with the benchmark's weights and
its ``eval_step`` (train/trainer.py::make_eval_step), and answers each
batch twice (every shape warm). In the window request k is batch k mod
``batches``: ``eval_step`` is sent, its predictions copied to the host,
and only then the next request sent. A request's latency is its send to
its answer on the host clock; requests answered inside the window count.

After the window the reference predicts every panel of every batch once,
and each answered request is compared with it: the reading is the widest
gap of a panel's prediction, over the rms of its batch's reference
predictions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import faults, program
from portbench.program import sync
from portbench.reference import graphs as ref_graphs
from portbench.reference import layout as ref_layout

WARM_REQUESTS = 2


def setup(run):
    cfg = run.c.cfg
    from portbench.traffic.generator import make_panels

    t_in = time.perf_counter()
    panels = make_panels(run.c.traffic, cfg["batch_size"], run.seed)
    split = {"panels": time.perf_counter() - t_in}
    port = program.prepare(run, panels)
    batches = port["batches"]
    eval_step = program.make_eval(port["model"], cfg, port["normalizer"])
    if run.fault:
        eval_step = faults.plant_serve(run.fault, eval_step)
    t_warm = time.perf_counter()
    for _ in range(WARM_REQUESTS):
        for b in batches:
            eval_step(b)
    sync(run.device)
    split.update(host_data=port["setup_data_s"],
                 model_and_weights=t_warm - port["t_model"],
                 warm_requests=time.perf_counter() - t_warm)
    return dict(model=port["model"], batches=batches, step=eval_step,
                panels=panels, weights=port["weights"], answers=[],
                split=split,
                counters=dict(setup_data_s=port["setup_data_s"],
                              kernel_build_s=port["kernel_build_s"],
                              shapes=port["shapes"]))


def window(run, st, seconds: float) -> dict:
    tracer, step, batches = run.tracer, st["step"], st["batches"]
    graphs = [s["graphs"] for s in st["counters"]["shapes"]]
    sync(run.device)
    lat, answered, k, last = [], 0, 0, 0.0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        b = k % len(batches)
        with tracer.span("send"):
            _, (pred, _) = step(batches[b])
        with tracer.span("readback"):
            p = pred[:graphs[b]].cpu()
        t1 = time.perf_counter()
        st["answers"].append((b, p))
        if t1 <= t_end:
            lat.append(t1 - t0)
            answered += graphs[b]
            last = t1
        k += 1
    calls = {b: sum(1 for a, _ in st["answers"] if a == b)
             for b in range(len(batches))}
    lat_ms = np.asarray(lat) * 1e3
    p95 = float(np.percentile(lat_ms, 95)) if len(lat) else float("nan")
    beyond = int((lat_ms > p95).sum())
    # the answers inside the window, over the time they took
    rate = answered / (last - t_start) if answered else 0.0
    return dict(e2e=dict(serve_panels_per_s=rate,
                         serve_p95_ms=p95),
                attempted=k, counters=dict(calls=calls, passes="serve"),
                notes=[f"window: {k} requests sent, {len(lat)} answered "
                       f"inside {seconds} s, {beyond} beyond the 95th "
                       f"percentile, median {float(np.median(lat_ms))} ms"])


def free(run, st) -> None:
    st["layouts"] = [program.layout(b, run.c.ref.EDGE_SLOTS)
                    for b in st["batches"]]
    for k in ("model", "batches", "step"):
        st.pop(k, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def program_results(run, st) -> dict:
    return dict(answers=st["answers"])


def reference_results(run, st, prec: str) -> dict:
    """The reference's predictions of each batch's panels in ``prec``."""
    cfg = run.c.cfg
    if "ref_batches" not in st:
        graphs = [ref_graphs.build(p, program.graph_kind(run.c),
                                   cfg["virtual_edge_percentage"])
                  for b in st["panels"] for p in b]
        normed, stats = ref_graphs.normalize(graphs)
        bs = cfg["batch_size"]
        st["ref_batches"] = [
            ref_layout.build(normed[i * bs:(i + 1) * bs], lay, stats, cfg,
                             run.device)
            for i, lay in enumerate(st["layouts"])]
    fwd = run.c.ref.forward
    with torch.no_grad():
        preds = [fwd(st["weights"], d, 0.0, None, prec).cpu()
                 for d in st["ref_batches"]]
    return dict(preds=preds)


def readings(run, st, prog: dict, ref: dict) -> dict:
    """pred_gap: the widest gap of any answered panel's prediction from the
    reference's, over the rms of its batch's reference predictions."""
    rms = [float(p.double().pow(2).mean().sqrt()) for p in ref["preds"]]
    gaps = [float((p.double() - ref["preds"][b].double()).abs().max())
            / rms[b] for b, p in prog["answers"]]
    st["gaps"] = gaps
    return dict(pred_gap=max(gaps) if gaps else float("nan"))


def failed(run, st, checks: dict) -> int:
    limit = checks["pred_gap"]["limit"]
    return sum(1 for g in st["gaps"] if not g <= limit)


def control_results(run, st) -> dict:
    """The control in the program's place: each batch answered by the
    reference in TF32."""
    preds = reference_results(run, st, "tf32")["preds"]
    return dict(answers=list(enumerate(preds)))
