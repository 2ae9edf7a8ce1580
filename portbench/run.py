"""The benchmark of the PyTorch/CUDA port of buckgnn-tpu: one run of one
cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
(an entry of ``workloads`` in ``BENCHMARK.json``) names a configuration
(``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``, whose ``mode`` names the loop in
``portbench/modes/``). Set-up makes the panels and weights from the seed,
runs the port's host path and warms the cell's own shapes; then the
loop's window runs for ``--seconds``. With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics; with
``--trace 1`` a window of at most `TRACE_SECONDS` runs under
``torch.profiler`` and the line carries the per-layer metrics, each read
by its own file ``portbench/metrics/<name>.py``, with the device's busy
time and a breakdown. After the window the port's state is freed and the
plain reference (``portbench/reference/``) judges what the timed path
produced against the limits of ``portbench/limits/<workload>.json``.

Without a CUDA card, or with fewer cards than the cell asks for, the run
fails and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the compiled byte code of every module a run imports, torch's too, at a
# fixed path inside the checkout (see `keep_bytecode`)
PYC_DIR = os.path.join(ROOT, ".pycache")
# the longest window a traced run profiles
TRACE_SECONDS = 4.0
# modules the process may not hold once the window has closed, compared by
# their whole top-level name (buckgnn_tpu_torch is not buckgnn_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "buckgnn_tpu")


def keep_bytecode() -> None:
    """Compile each imported module once per checkout: Python's byte code
    goes to `PYC_DIR`, also where the environment turns writing it off
    (PYTHONDONTWRITEBYTECODE) or the installed packages ship none, which
    leaves every run compiling torch and torch._dynamo anew (about 20 s
    of set-up, and most of its spread). Called before torch is
    imported."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYC_DIR


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    """A module from a file whose name may hold dots (a metric's file)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, workload: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports: those
    that list it under ``workloads`` or list no cells."""
    def mine(m):
        return workload in m.get("workloads", [workload])
    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def resolve(root: str, workload: str) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, its traffic and its
    configuration's reference module (``portbench/reference/<name>.py``),
    each found by name under ``root``."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(root, cfg_entry["file"])
    traffic = load_json(root, "portbench", "traffic",
                        f"{cell['traffic']}.json")
    ref = load_file_module(
        os.path.join(root, "portbench", "reference",
                     f"{cfg['reference']}.py"),
        f"portbench_reference_{cfg['reference']}")
    e2e, per_layer = cell_metrics(spec, workload)
    return SimpleNamespace(root=root, spec=spec, cell=cell, cfg=cfg,
                           traffic=traffic, ref=ref, e2e=e2e,
                           per_layer=per_layer)


def require_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} found")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def derive_seed(seed: int, what: int) -> int:
    from portbench.traffic.generator import panel_seed

    return panel_seed(seed, 2**32 + what)


def make_weights(param_spec: dict, seed: int, device) -> dict:
    """Every parameter from the seed, on the device in one draw: a weight
    [out, in] is normal / sqrt(in), a bias a tenth of that."""
    import torch

    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    sizes = [math.prod(s) for s in param_spec.values()]
    buf = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(param_spec.items(), sizes):
        weight = name.replace(".bias", ".weight")
        fan_in = param_spec[weight][1]
        scale = (1.0 if name == weight else 0.1) / math.sqrt(fan_in)
        out[name] = buf[off:off + n].view(shape) * scale
        off += n
    return out


class Tracer:
    """The benchmark's own host spans and, in a traced run, the profiler
    over the window."""

    def __init__(self, on: bool):
        self.on, self.prof = on, None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with self.span("window"):
                yield
        self.prof = prof


def read_trace(prof) -> SimpleNamespace:
    """Device operations and host spans of the traced window (profiler
    time, microseconds): kernels, copies and sets as (name, start, end),
    the benchmark's spans, the window span."""
    from torch.autograd import DeviceType

    kernels, spans, window = [], [], None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host span's mirror on the device timeline is no operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("portbench.")):
                kernels.append((e.name, t0, t1))
        elif e.name.startswith("portbench."):
            if e.name == "portbench.window":
                window = (t0, t1)
            else:
                spans.append((e.name[len("portbench."):], t0, t1))
    kernels.sort(key=lambda k: k[1])
    spans.sort(key=lambda s: s[1])
    busy, merged = 0.0, []
    for _, a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    return SimpleNamespace(kernels=kernels, spans=spans, window=window,
                           busy_us=busy, merged=merged)


def breakdown(tr) -> dict:
    """The ten device operations that took most time, and the idle gaps of
    the window summed by the benchmark span the host was in."""
    by_name: dict = {}
    for name, a, b in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    w0, w1 = tr.window
    edges = [w0] + [x for ab in tr.merged for x in ab] + [w1]
    gaps: dict = {}
    counts: dict = {}
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while j + 1 < len(tr.spans) and tr.spans[j + 1][1] <= a:
            j += 1
        name = "host"
        if tr.spans and tr.spans[j][1] <= a < tr.spans[j][2]:
            name = tr.spans[j][0]
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        counts[name] = counts.get(name, 0) + 1
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[f"{n} x{counts[n]}", s] for n, s in idle]}


def read_per_layer(c, ctx) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in c.per_layer:
        path = os.path.join(c.root, "portbench", "metrics",
                            f"{m['name']}.py")
        mod = load_file_module(path, f"portbench_metric_{len(out)}")
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(c, readings: dict) -> tuple[bool, dict]:
    """Each reading beside its limit (``portbench/limits/<cell>.json``);
    the run is correct when every one is finite and within it."""
    limits = load_json(c.root, "portbench", "limits",
                       f"{c.cell['name']}.json")["limits"]
    missing = set(limits) - set(readings)
    if missing:
        raise RuntimeError(f"no reading of {sorted(missing)}")
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings[name]
        ok &= math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def new_run(c, seed: int, trace: bool = False, device=None, fault=None):
    """(the loop's module, the run's namespace) of one run of the cell
    ``c`` (`resolve`): float32 products with TF32 off. ``device`` None is
    the first CUDA card; ``fault`` plants one of portbench/faults.py's
    faults in the timed path (tests and calibration only)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = importlib.import_module(f"portbench.modes.{c.traffic['mode']}")
    run = SimpleNamespace(c=c, seed=seed,
                          device=torch.device(device or "cuda"), fault=fault,
                          tracer=Tracer(trace), weights_fn=make_weights,
                          derive_seed=derive_seed)
    return mode, run


def run_cell(c, seed: int, seconds: float, trace: bool, device=None,
             fault=None) -> dict:
    """One run of the cell ``c`` (`resolve`); returns the result line's
    object (`new_run` for ``device`` and ``fault``)."""
    import torch

    t_imports = time.perf_counter()
    mode, run = new_run(c, seed, trace, device, fault)
    device = run.device
    st = mode.setup(run)
    window_s = min(seconds, TRACE_SECONDS) if trace else seconds
    setup_s = time.perf_counter() - T_START
    with run.tracer.window():
        measured = mode.window(run, st, window_s)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    result_metrics = {}
    extra = {}
    if trace:
        tr = read_trace(run.tracer.prof)
        ctx = SimpleNamespace(cfg=c.cfg, ref=c.ref, mode=c.traffic["mode"],
                              trace=tr, window_s=(tr.window[1] - tr.window[0])
                              * 1e-6, **st["counters"], **measured["counters"])
        result_metrics = read_per_layer(c, ctx)
        extra = dict(busy_s=tr.busy_us * 1e-6, window_s=ctx.window_s)
        bd = breakdown(tr)
    else:
        values = dict(measured["e2e"], setup_s=setup_s)
        for m in c.e2e:
            result_metrics[m["name"]] = {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
    split = " ".join(f"{k} {v:.4f}" for k, v in st["split"].items())
    log(f"setup: setup_s {setup_s}; kernel build or load "
        f"{st['counters']['kernel_build_s']} s; split: imports "
        f"{t_imports - T_START:.4f} {split}")
    for line in measured.get("notes", []):
        log(line)
    mode.free(run, st)
    readings = mode.readings(run, st, mode.program_results(run, st),
                             mode.reference_results(run, st, "float32"))
    if device.type == "cuda":
        log(f"reference: peak {torch.cuda.max_memory_allocated(device)} "
            "bytes on the card")
    correct, checks = judge(c, readings)
    for name in sorted(set(readings) - set(checks)):
        log(f"reading {name} {readings[name]!r} (not compared)")
    failed = mode.failed(run, st, checks)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": int(c.cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    device_info.update(extra)
    out = {"correct": bool(correct and failed == 0),
           "attempted": int(measured["attempted"]), "failed": int(failed),
           "metrics": result_metrics, "device": device_info}
    if trace:
        out["breakdown"] = bd
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    keep_bytecode()
    c = resolve(ROOT, args.workload)
    require_devices(int(c.cell["chips"]))
    out = run_cell(c, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad}: the benchmark may not load JAX or "
            "the JAX package")
        return 3
    for name, chk in out["checks"].items():
        log(f"check {name} {chk['value']!r} limit {chk['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
