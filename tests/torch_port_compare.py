"""Exact comparison of the port's host-side outputs with the JAX
package's: the helpers of the test_torch_port_* files whose modules are
NumPy copies (folders, datagen, split, the CLI)."""

import enum

import numpy as np


def same(a, b, where="root"):
    """Recursive equality: arrays by value, shape and dtype; enums by
    name; objects by their attributes (dataclasses, namespaces); the rest
    by type and ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, \
            where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        same(vars(a), vars(b), f"{where}.{type(a).__name__}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def both(fn_name, mods, *args, **kw):
    """``fn_name(*args, **kw)`` from each of the two modules ``mods`` (the
    JAX package's, the port's): the same result, or the same exception
    type and message. Returns the port's ``(kind, value)``."""
    out = []
    for mod in mods:
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kw)))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("raise", (type(e).__name__, str(e))))
    assert out[0][0] == out[1][0], out
    same(out[0][1], out[1][1], fn_name)
    return out[1]
