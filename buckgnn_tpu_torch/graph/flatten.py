"""Eigenvalue-distribution flattening — dataset balancing.

Re-implements Dataset_Preparation/Eigenvalue_Distribution.py: percentile
filtering (2.5-97.5, :849-866), fixed-width 0.05 bins (:49-56), and a uniform
per-bin cap (:809-836, 891-912) that turns a skewed 200k-case raw pool into
a flat ~40k training distribution (BASELINE.md). Operates on any array of
eigenvalues + ids; the OP2-scanning/caching layer of the reference collapses
to 'give me the eigenvalues'.

A copy of buckgnn_tpu/graph/flatten.py, kept here so the port needs no
JAX: the same code, so its outputs are bit-identical.
"""

from __future__ import annotations

import numpy as np

__all__ = ["flatten_distribution", "scan_eigenvalues"]

BIN_WIDTH = 0.05  # (Eigenvalue_Distribution.py:49-56)


def flatten_distribution(
    eigenvalues: np.ndarray,
    samples_per_bin: int | None = None,
    target_total: int | None = None,
    lower_pct: float = 2.5,
    upper_pct: float = 97.5,
    bin_width: float = BIN_WIDTH,
    seed: int = 0,
):
    """Select a subset of indices with a flattened eigenvalue histogram.

    Returns (selected_indices, info). Either ``samples_per_bin`` or
    ``target_total`` must be given (the reference example: cap 1040/bin to
    get ~40k of 200k, Eigenvalue_Distribution.py:306-309).
    """
    eigenvalues = np.asarray(eigenvalues, dtype=np.float64)
    rng = np.random.default_rng(seed)

    lo = np.percentile(eigenvalues, lower_pct)
    hi = np.percentile(eigenvalues, upper_pct)
    in_range = (eigenvalues >= lo) & (eigenvalues <= hi)
    idx = np.where(in_range)[0]

    bins = np.floor((eigenvalues[idx] - lo) / bin_width).astype(np.int64)
    uniq, inverse, counts = np.unique(bins, return_inverse=True,
                                      return_counts=True)

    if samples_per_bin is None:
        if target_total is None:
            raise ValueError("need samples_per_bin or target_total")
        # find the cap c such that sum(min(count, c)) ~= target_total
        c_lo, c_hi = 1, int(counts.max())
        while c_lo < c_hi:
            mid = (c_lo + c_hi) // 2
            if np.minimum(counts, mid).sum() < target_total:
                c_lo = mid + 1
            else:
                c_hi = mid
        samples_per_bin = c_lo

    selected = []
    for b in range(len(uniq)):
        members = idx[inverse == b]
        if len(members) > samples_per_bin:
            members = rng.choice(members, size=samples_per_bin, replace=False)
        selected.append(members)
    selected = np.sort(np.concatenate(selected))
    info = dict(
        lower=float(lo), upper=float(hi), samples_per_bin=int(samples_per_bin),
        n_bins=int(len(uniq)), n_selected=int(len(selected)),
        n_filtered=int(len(eigenvalues) - len(idx)),
        bin_counts=counts,
    )
    return selected, info


def scan_eigenvalues(dataset) -> np.ndarray:
    """Eigenvalues from GraphData list (the reference scans OP2 files with a
    CSV cache, Eigenvalue_Distribution.py:84-233; our graphs carry them)."""
    return np.array(
        [d.eigenvalue if d.eigenvalue is not None
         else float(np.reshape(d.y, (-1,))[0]) for d in dataset]
    )
