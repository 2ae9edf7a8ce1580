"""External-solver batch runner with BDF repair.

Re-implements the reference's Nastran batch harness
(Data_Generation/NastranRunner_EIGRL.py) as a solver-agnostic component:

- text-level BDF repair before solving (:26-111): drop GRID cards for
  nodes no element references, force the EIGRL card to ``0.0, nd`` (search
  from zero, nd modes), and pin the stiffener MAT1 4 card to
  E=76 GPa / nu=0.3,
- subprocess execution of a configurable solver command per BDF with a
  returncode/op2-existence check (:125-164),
- directory-level batch runs on a thread pool with scratch isolation and
  .log/.f04/.f06 cleanup (:149-184).

The solver command is a template (``{bdf}``/``{workdir}`` placeholders), so
tests run hermetically against a stub executable and production points at a
real Nastran install — the framework itself never depends on one.

A copy of buckgnn_tpu/datagen/runner.py, kept here so the port needs no
JAX: the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

__all__ = ["RunnerConfig", "find_orphan_nodes", "fix_bdf_text",
           "fix_bdf_file", "SolverRunner"]

_ELEMENT_NODE_FIELDS = {"CQUAD4": 4, "CTRIA3": 3, "CBAR": 2}


@dataclasses.dataclass
class RunnerConfig:
    """Solver invocation settings (NastranRunner_EIGRL.py:118-147)."""

    # e.g. "nastran {bdf} scr=yes bat=no out={workdir}" or a stub for tests
    solver_cmd: str = "nastran {bdf}"
    timeout_s: float = 600.0
    max_workers: int = 4
    eigrl_nd: int = 1
    cleanup_exts: tuple = (".log", ".f04", ".f06")
    fix_bdfs: bool = True


def find_orphan_nodes(lines: list[str]) -> set[int]:
    """GRID ids referenced by no CQUAD4/CTRIA3/CBAR element
    (find_hidden_nodes, NastranRunner_EIGRL.py:26-71). Small-field fixed
    format: fields are 8-char columns."""
    nodes: set[int] = set()
    used: set[int] = set()
    for line in lines:
        s = line.strip()
        if s.startswith("GRID"):
            try:
                nodes.add(int(line[8:16].strip()))
            except ValueError:
                continue
        else:
            for elem, nfields in _ELEMENT_NODE_FIELDS.items():
                if s.startswith(elem):
                    try:
                        for k in range(nfields):
                            nid = int(line[24 + 8 * k:32 + 8 * k].strip())
                            if nid > 0:
                                used.add(nid)
                    except (ValueError, IndexError):
                        pass
                    break
    return nodes - used


def fix_bdf_text(lines: list[str], eigrl_nd: int = 1) -> tuple[list[str], bool]:
    """Apply the reference's three repairs (modify_bdf_file,
    NastranRunner_EIGRL.py:74-111). Returns (new_lines, modified)."""
    modified = False
    orphans = find_orphan_nodes(lines)
    if orphans:
        out = []
        for line in lines:
            if line.strip().startswith("GRID"):
                try:
                    nid = int(line[8:16].strip())
                except ValueError:
                    out.append(line)
                    continue
                if nid in orphans:
                    modified = True
                    continue
            out.append(line)
        lines = out

    for i, line in enumerate(lines):
        if re.match(r"EIGRL\s+1\b", line.strip()) and "0.0" not in line:
            lines[i] = (f"EIGRL          1     0.0        "
                        f"{eigrl_nd:8d}\n")
            modified = True
            break
    for i, line in enumerate(lines):
        if re.match(r"MAT1\s+4\b", line.strip()):
            fixed = "MAT1           4  76000.              .3\n"
            if line != fixed:
                lines[i] = fixed
                modified = True
            break
    return lines, modified


def fix_bdf_file(path: str, eigrl_nd: int = 1) -> bool:
    with open(path) as f:
        lines = f.readlines()
    lines, modified = fix_bdf_text(lines, eigrl_nd)
    if modified:
        with open(path, "w") as f:
            f.writelines(lines)
    return modified


class SolverRunner:
    """Run an external FEA solver over BDF files
    (NastranRunner.run_nastran / process_directory,
    NastranRunner_EIGRL.py:125-184)."""

    def __init__(self, config: RunnerConfig | None = None):
        self.config = config or RunnerConfig()
        self.failures: list[tuple[str, str]] = []

    def run_one(self, bdf_path: str, workdir: str | None = None) -> str | None:
        """Solve one BDF; returns the .op2 path or None on failure."""
        cfg = self.config
        workdir = workdir or os.path.dirname(os.path.abspath(bdf_path))
        if cfg.fix_bdfs:
            fix_bdf_file(bdf_path, cfg.eigrl_nd)
        cmd = cfg.solver_cmd.format(bdf=bdf_path, workdir=workdir)
        try:
            proc = subprocess.run(
                cmd, shell=True, cwd=workdir, capture_output=True,
                timeout=cfg.timeout_s,
            )
        except subprocess.TimeoutExpired:
            self.failures.append((bdf_path, "timeout"))
            return None
        op2 = os.path.splitext(bdf_path)[0] + ".op2"
        if proc.returncode != 0 or not os.path.exists(op2):
            self.failures.append(
                (bdf_path,
                 f"rc={proc.returncode} "
                 f"{proc.stderr.decode(errors='replace')[-200:]}")
            )
            return None
        for ext in cfg.cleanup_exts:
            p = os.path.splitext(bdf_path)[0] + ext
            if os.path.exists(p):
                os.remove(p)
        return op2

    def process_directory(self, directory: str,
                          pattern: str = ".bdf") -> list[str]:
        """Solve every BDF in `directory` concurrently; returns the op2
        paths of the successes (failures recorded on self.failures)."""
        bdfs = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.endswith(pattern)
        )
        results: list[str] = []
        with ThreadPoolExecutor(max_workers=self.config.max_workers) as ex:
            for op2 in ex.map(self.run_one, bdfs):
                if op2 is not None:
                    results.append(op2)
        return results
