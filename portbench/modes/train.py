"""The train loop: a closed loop of the port's train step over one
packed batch.

Set-up builds one object, the port's model with its Adam state and its
``train_step`` (train/trainer.py::make_train_step), loads the benchmark's
weights into it and drives it through its first `CHECKED_STEPS` steps on
the window's own batch, with dropout seeds from a generator seeded from
the run seed; those steps also warm every shape. It keeps the losses, the
first gradient as Adam's first moment holds it, and the parameters after
the last; then the window continues the same object. A step is dispatched
with no host fetch; at most two are in flight. The window counts the
steps whose end (a CUDA event) falls inside it.

After the window the reference follows the checked steps from the same
weights and seeds (reference/common.py::train_steps), and the readings
compare, each by its worst case: the loss of each step, the norm of each
leaf's first gradient, and the norm of each leaf's change over the steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import faults, program
from portbench.program import sync
from portbench.reference import graphs as ref_graphs
from portbench.reference import layout as ref_layout
from portbench.reference.common import train_steps

CHECKED_STEPS = 3
IN_FLIGHT = 2
# a leaf whose reference gradient norm is under this share of the median
# leaf's is nought to rounding (a bias under a normalization): under Adam
# it moves by round-off alone, and its change is not compared
NOUGHT = 1e-3


class Clock:
    """Completion times of dispatched work, in seconds from `start`: CUDA
    events on the card, the host clock (after a synchronous step) on the
    CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int):
        if self.cuda:
            self.marks[i].synchronize()

    def seconds(self) -> list[float]:
        if self.cuda:
            return [self.t0.elapsed_time(e) * 1e-3 for e in self.marks]
        return [t - self.t0 for t in self.marks]


def setup(run):
    cfg = run.c.cfg
    from portbench.traffic.generator import make_panels

    t_in = time.perf_counter()
    panels = make_panels(run.c.traffic, cfg["batch_size"], run.seed)[0]
    split = {"panels": time.perf_counter() - t_in}
    port = program.prepare(run, [panels])
    model, batch, weights = port["model"], port["batches"][0], port["weights"]
    t_opt = time.perf_counter()
    train_step, _, opt = program.make_steps(model, cfg, port["normalizer"])
    if run.fault:
        train_step = faults.plant_train(run.fault, train_step, model, opt)
    dropout_seed = run.derive_seed(run.seed, 2)
    gen = torch.Generator().manual_seed(dropout_seed)
    lr = cfg["optimizer"]["lr"]
    beta1 = cfg["optimizer"]["betas"][0]
    names = dict(model.named_parameters())
    losses, first = [], None
    t_steps = time.perf_counter()
    for k in range(CHECKED_STEPS):
        losses.append(train_step(batch, lr, gen)["loss"])
        if k == 0:
            sync(run.device)
            first = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).clone()
                     if p in opt.state else torch.zeros_like(p)
                     for n, p in names.items()}
    sync(run.device)
    t2 = time.perf_counter()
    after = {n: p.detach().clone() for n, p in names.items()}
    # the optimizer's construction is the process's first torch.optim use,
    # which imports torch._dynamo
    split.update(host_data=port["setup_data_s"],
                 model_and_weights=t_opt - port["t_model"],
                 optimizer=t_steps - t_opt, checked_steps=t2 - t_steps)
    return dict(model=model, opt=opt, batch=batch, step=train_step, gen=gen,
                lr=lr, panels=panels, weights=weights, layout=None,
                dropout_seed=dropout_seed, split=split,
                losses=[float(v) for v in losses], first=first, after=after,
                counters=dict(setup_data_s=port["setup_data_s"],
                              kernel_build_s=port["kernel_build_s"],
                              shapes=port["shapes"]))


def window(run, st, seconds: float) -> dict:
    dev, tracer = run.device, run.tracer
    step, batch, lr, gen = st["step"], st["batch"], st["lr"], st["gen"]
    sync(dev)
    clock = Clock(dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    clock.start()
    t_end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < t_end:
        if k >= IN_FLIGHT:
            with tracer.span("wait"):
                clock.wait(k - IN_FLIGHT)
        with tracer.span("step"):
            loss = step(batch, lr, gen)["loss"]
            nonfinite += (~torch.isfinite(loss)).long()
        clock.mark()
        k += 1
    with tracer.span("sync"):
        sync(dev)
    inside = [t for t in clock.seconds() if t <= seconds]
    done = len(inside)
    g = st["counters"]["shapes"][0]["graphs"]
    st["nonfinite"] = int(nonfinite)
    # the steps that ended inside the window, over the time they took
    rate = done * g / inside[-1] if done else 0.0
    return dict(e2e=dict(train_panels_per_s=rate),
                attempted=k, counters=dict(calls={0: k}, passes="train"),
                notes=[f"window: {k} steps dispatched, {done} ended inside "
                       f"{seconds} s, {g} panels a step"])


def free(run, st) -> None:
    """Drop the port's device state; the host layout of its batch stays
    for the reference to check."""
    st["layout"] = program.layout(st["batch"], run.c.ref.EDGE_SLOTS)
    for k in ("model", "opt", "batch", "step"):
        st.pop(k, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def program_results(run, st) -> dict:
    change = {n: st["after"][n] - st["weights"][n] for n in st["after"]}
    return dict(losses=st["losses"], grad=st["first"], change=change)


def reference_batch(run, st):
    if "ref_batch" not in st:
        cfg = run.c.cfg
        graphs = [ref_graphs.build(p, program.graph_kind(run.c),
                                   cfg["virtual_edge_percentage"])
                  for p in st["panels"]]
        normed, stats = ref_graphs.normalize(graphs)
        st["ref_batch"] = ref_layout.build(normed, st["layout"], stats, cfg,
                                           run.device)
    return st["ref_batch"]


def reference_results(run, st, prec: str) -> dict:
    """The reference's checked steps in ``prec`` ("float32"; "tf32" is the
    control) from the benchmark's weights and the same dropout seeds."""
    cfg = run.c.cfg
    d = reference_batch(run, st)
    params = {k: v.clone() for k, v in st["weights"].items()}
    gen = torch.Generator().manual_seed(st["dropout_seed"])
    res = train_steps(run.c.ref.forward, params, d, cfg,
                      CHECKED_STEPS, gen, prec)
    change = {n: res["params"][n] - st["weights"][n] for n in params}
    return dict(losses=res["losses"], grad=res["grad"], change=change)


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def readings(run, st, prog: dict, ref: dict) -> dict:
    """loss_gap: the worst step's |loss - ref| / |ref|; loss1_gap the
    first step's. grad_gap and change_gap: the worst leaf's gap between
    the program's norm and the reference's, over the larger of that leaf's
    reference norm and the median leaf's (``*_median_gap``: the median
    leaf's gap); leaves whose reference gradient is nought to rounding
    (`NOUGHT`) are left out. The cell's limits file names the readings it
    compares."""
    steps = [abs(a - b) / abs(b) for a, b in
             zip(prog["losses"], ref["losses"])]
    rg = _norms(ref["grad"])
    med = float(np.median(list(rg.values())))
    keep = [k for k, v in rg.items() if v >= NOUGHT * med]
    out = dict(loss_gap=max(steps), loss1_gap=steps[0])
    st["detail"] = dict(loss_steps=steps, left_out=sorted(set(rg) - set(keep)))
    for name in ("grad", "change"):
        pn, rn = _norms(prog[name]), _norms(ref[name])
        m = float(np.median([rn[k] for k in keep]))
        gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], m) for k in keep}
        out[f"{name}_gap"] = max(gaps.values())
        out[f"{name}_median_gap"] = float(np.median(list(gaps.values())))
        worst = sorted(gaps, key=gaps.get)[-3:]
        st["detail"][name] = [(k, gaps[k], rn[k], m) for k in worst]
    return out


def failed(run, st, checks: dict) -> int:
    return st.get("nonfinite", 0)


def control_results(run, st) -> dict:
    """The control in the program's place: the reference in TF32."""
    return reference_results(run, st, "tf32")
