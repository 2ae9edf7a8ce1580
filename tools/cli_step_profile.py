"""Where the command line's train steps spend their time, on one CUDA card.

    python3 tools/cli_step_profile.py [ROOT]

ROOT (default: this checkout) holds the ``buckgnn_tpu_torch`` package and
the ``chip_smoke.py`` to run: unpack another version into an ignored
directory and run both in one call, in turns, to compare them. Makes
``chip_smoke.py``'s phase-11 folders (three ``python -m buckgnn_tpu_torch
datagen`` processes at once), runs one epoch of ``cli train`` at the
flagship's flags on D, and at the JAX package's default flags on E in
float32 (their default) and in bfloat16 (the unfused 'xla' route), keeps
the trainer's train step and batches, then times each train batch (host
clock over 10 steps after 3 warm-ups, ending in a synchronize) and
profiles it (``chip_smoke.py::step_profile``: device ms by kernel over 3
steps, busy share). Prints one JSON line. About a minute with the build.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
    sys.path.insert(0, root)
    os.chdir(root)
    from unittest import mock

    import torch

    import chip_smoke as cs
    from buckgnn_tpu_torch import cli
    from buckgnn_tpu_torch.train import trainer
    from buckgnn_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        cs.fail("this script needs a CUDA card")
    cuda_build.build_all()
    card = cs.card_line()
    out = {"root": root, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "buckgnn_tpu_torch", "datagen",
             "--out-dir", os.path.join(tmp, rel), *flags],
            stdout=subprocess.DEVNULL)
            for rel, flags in cs.CLI_DATAGEN.items()]
        if any(p.wait() for p in procs):
            cs.fail("datagen failed")
        runs = {"flagship": ["--data-dir", os.path.join(tmp, "D"),
                             *cs.CLI_FLAGSHIP],
                "default": ["--data-dir", os.path.join(tmp, "E")],
                "default-bf16": ["--data-dir", os.path.join(tmp, "E"),
                                 "--compute-dtype", "bfloat16"]}
        for label, argv in runs.items():
            made = []
            real = trainer.make_train_step

            def keeping(*a, **k):
                made.append(real(*a, **k))
                return made[-1]

            with mock.patch.object(trainer, "MetricsWriter",
                                   cs.RecordingWriter), \
                    mock.patch.object(trainer, "make_train_step", keeping), \
                    cs.recorded_packs(trainer) as packs, \
                    contextlib.redirect_stdout(io.StringIO()):
                cli.main(["train", *argv, "--num-epochs", "1",
                          "--output-dir", os.path.join(tmp, label)])
            step, gen = made[0][0], torch.Generator().manual_seed(0)
            rows = []
            for i, b in enumerate(packs[0]):
                def run():
                    return step(b, 1e-3, gen)

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 10 * 1e3
                prof = cs.step_profile(f"cli {label} train step, batch {i}",
                                       run, ms, card)
                rows.append({
                    "batch": i, "n_node_cap": b.n_node_cap,
                    "real_nodes": int(b.node_mask.sum()),
                    "real_edges": int(b.edge_mask.sum()),
                    "edge_cap": int(b.edge_mask.shape[0]),
                    "spill": b.has_spill_edges, "step_ms": ms,
                    "device_ms": prof["device_ms"],
                    "busy_share": prof["busy_share"], "top": prof["top"][:6]})
            out[label] = rows
            del made, packs
    print(json.dumps(out))


if __name__ == "__main__":
    main()
