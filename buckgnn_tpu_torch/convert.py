"""Carry weights over from the JAX package's flax variables.

``state_from_flax(params, batch_stats=None)`` takes the flax ``params`` (and
the ``batch_stats`` collection of the batch norms) as nested dicts of
numpy arrays and returns a ``state_dict`` for `buckgnn_tpu_torch.models.
BuckGNN`: module paths join with ``.``, a Dense ``kernel`` [in, out]
becomes ``weight`` [out, in] (the split first Dense of a GraphNetBlock
MLP too: its kernel is one [sum(in), out] array), every other leaf keeps
its name (a bias; a batch norm's ``scale`` and ``bias``, and its running
``mean`` and ``var``, which become buffers). ``params_from_flax`` is the
``params`` part alone.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_flax(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            out.update(params_from_flax(value, key + "."))
        elif name == "kernel":
            w = np.array(np.asarray(value, dtype=np.float32).T, order="C")
            out[f"{prefix}weight"] = torch.from_numpy(w)
        else:
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def state_from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """The model's whole state: ``params`` and the batch norms' running
    statistics."""
    out = params_from_flax(params)
    if batch_stats:
        out.update(params_from_flax(batch_stats))
    return out
