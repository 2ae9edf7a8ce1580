"""Carry weights over from the JAX package's flax parameter tree.

``params_from_flax(tree)`` takes the flax ``params`` as a nested dict of
numpy arrays and returns a ``state_dict`` for `buckgnn_tpu_torch.models.
BuckGNN`: module paths join with ``.``, a Dense ``kernel`` [in, out]
becomes ``weight`` [out, in], a ``bias`` stays ``bias``.
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
            w = np.asarray(value, dtype=np.float32).T
            out[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(w))
        else:
            out[key] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(value, dtype=np.float32)))
    return out
