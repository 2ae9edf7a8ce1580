"""Carry weights and optimizer state over from the JAX package.

``state_from_flax(params, batch_stats=None)`` takes the flax ``params`` (and
the ``batch_stats`` collection of the batch norms) as nested dicts of
numpy arrays and returns a ``state_dict`` for `buckgnn_tpu_torch.models.
BuckGNN`: module paths join with ``.``, a Dense ``kernel`` [in, out]
becomes ``weight`` [out, in] (the split first Dense of a GraphNetBlock
MLP too: its kernel is one [sum(in), out] array), every other leaf keeps
its name (a bias; a batch norm's ``scale`` and ``bias``, and its running
``mean`` and ``var``, which become buffers). ``params_from_flax`` is the
``params`` part alone.

``adam_state_from_optax(opt_state, model)`` carries the Adam moments of the
JAX package's optax chain, and ``read_flax_msgpack(path)`` reads the
``state.msgpack`` its checkpoints hold (buckgnn_tpu/train/checkpoint.py)
without flax.
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


def adam_state_from_optax(opt_state, model: torch.nn.Module) -> dict:
    """The Adam moments of the JAX package's optimizer as a
    ``torch.optim.Adam.state_dict()`` over ``model.parameters()``.

    ``opt_state`` is the state of ``optax.chain(add_decayed_weights,
    scale_by_adam)`` (buckgnn_tpu/train/trainer.py:64-71) as a flax state
    dict, the ``opt_state`` of `read_flax_msgpack`: its ``'1'`` entry is
    ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; the decay step keeps
    none). Parameter i of ``model.parameters()`` gets ``step`` = count,
    ``exp_avg`` = mu and ``exp_avg_sq`` = nu of its flax leaf, a kernel
    transposed as `params_from_flax` does. The one group lists the
    parameters only: the learning rate, betas, eps and weight decay are
    the run's config, not optimizer state, and
    train/checkpoint.py::load_checkpoint loads the ``state`` into the
    run's own optimizer.
    """
    adam = opt_state["1"]
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: optax moment of shape "
                             f"{tuple(mu[name].shape)}, parameter of shape "
                             f"{tuple(p.shape)}")
        state[i] = {"step": step.clone(), "exp_avg": mu[name],
                    "exp_avg_sq": nu[name]}
    return {"state": state, "param_groups": [{"params": list(state)}]}


# flax.serialization's msgpack encoding (flax/serialization.py): arrays are
# an ext type holding msgpack of (shape, dtype name, C-order bytes); numpy
# scalars the same, unpacked to a 0-d array; leaves over 2^30 bytes are
# stored as {'__msgpack_chunked_array__': True, 'shape': {'0': ..},
# 'chunks': {'0': flat array, ..}}. (Its third ext type, a Python complex,
# no checkpoint holds.)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: the upper half of a float32 holds it exactly
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> dict:
    """A flax msgpack file (``flax.serialization.to_bytes``) as the nested
    dicts of numpy arrays and Python numbers that flax's ``msgpack_restore``
    gives, read without flax; bfloat16 leaves come back as float32 (exact).
    A JAX checkpoint's ``state.msgpack`` has ``params``, ``batch_stats``,
    ``opt_state`` (tuples become dicts keyed '0', '1', ..) and ``epoch``."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_unpack, raw=False)
    return _unchunk(tree)
