"""Time the train step of benchmark cells under one copy of the port, on one
CUDA card.

    python3 tools/train_step_timing.py ROOT [CELL ...]

ROOT is the directory that holds the ``buckgnn_tpu_torch`` package and the
``chip_smoke.py`` to time (an unpacked ``git archive`` of a commit, or
this checkout); the CELLs are keys of ``bench.py::CELLS`` (default
csr-virtual and flagship). Run it once per copy, in turns in one session
(parent, change, change, parent, ...), to compare two versions on one
card: a step that changes only in a long process such as
``chip_smoke.py``'s may be the host, not the code. It imports
``chip_smoke.py`` first (the script's imports), builds the kernels, and
prints one JSON line: for each cell, five ``run_train_bench`` step times
(ms; 3 warm-ups and 20 steps each) on the cell's packed batch.
"""

import json
import os
import sys


def main():
    root = os.path.abspath(sys.argv[1])
    cells = sys.argv[2:] or ["csr-virtual", "flagship"]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke  # noqa: F401  (the smoke script's imports)
    from buckgnn_tpu_torch.bench import build_train_setup, run_train_bench
    from buckgnn_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    out = {"root": sys.argv[1], "card": chip_smoke.card_line()}
    for cell in cells:
        setup = build_train_setup(device=dev, config=cell)
        out[cell] = [run_train_bench(setup)["train_step_ms"]
                     for _ in range(5)]
        del setup
    print(json.dumps(out))


if __name__ == "__main__":
    main()
