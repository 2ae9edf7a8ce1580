"""The readings that the limits of ``portbench/limits/<cell>.json`` are
set from, in one process: for each seed the program's own (a run's
set-up, a short window, the reference's comparison), the control's (the
reference computed in TF32 put in the program's place) and, with
``--faults``, each fault of portbench/faults.py planted in the timed path.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \
        [--seconds 2] [--faults 1] [--panel-seeds 5,6] [--out FILE]

``--panel-seeds`` reads each seed on each of these panel draws in place of
the traffic's fixed ``panel_seed``: the benchmark's runs time one draw,
and the limits hold over others, whose geometry (band layout, spill
edges, the last tile's clamp) differs. One JSON line per seed, draw and
reading on standard output (and appended to FILE). Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import faults, run as bench


def readings_of(c, seed: int, seconds: float, fault=None,
                control: bool = False) -> dict:
    device = "cuda" if torch.cuda.is_available() else "cpu"
    mode, r = bench.new_run(c, seed, device=device, fault=fault)
    st = mode.setup(r)
    mode.window(r, st, seconds)
    mode.free(r, st)
    ref = mode.reference_results(r, st, "float32")
    out = {"program": mode.readings(r, st, mode.program_results(r, st), ref)}
    if "detail" in st:
        out["program_detail"] = st["detail"]
    if control:
        out["control"] = mode.readings(r, st, mode.control_results(r, st),
                                       ref)
    del st
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--panel-seeds", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    c = bench.resolve(bench.ROOT, args.workload)
    names = faults.TRAIN if c.traffic["mode"] == "train" else faults.SERVE
    draws = ([int(s) for s in args.panel_seeds.split(",")]
             if args.panel_seeds else [c.traffic["panel_seed"]])
    fixed = dict(c.traffic)
    for draw in draws:
        c.traffic = dict(fixed, panel_seed=draw)
        for seed in (int(s) for s in args.seeds.split(",")):
            rows = [dict(kind="sound+control", **readings_of(
                c, seed, args.seconds, control=True))]
            if args.faults:
                rows += [dict(kind=f"fault:{f}",
                              **readings_of(c, seed, 1.0, f))
                         for f in names]
            for row in rows:
                line = json.dumps(dict(workload=args.workload, seed=seed,
                                       panel_seed=draw, **row))
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
