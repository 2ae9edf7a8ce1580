"""The port's import surface and `ops/segment.py::segment_softmax_weights`.

Every public name a JAX package ``__init__.py`` imports (read with `ast`)
is an attribute of the port's counterpart, except the two data-parallel
helpers that `parallel/dp.py::local_batch` replaces; and the per-segment
softmax equals the JAX function, values and gradients (`jax.vjp`), on
sorted and unsorted ids with an empty segment.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.ops.segment import segment_softmax_weights as j_softmax
from buckgnn_tpu_torch.ops.segment import segment_softmax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# stack_batches / shard_stacked_batch: replaced by parallel/dp.py::local_batch
NOT_PORTED = {"stack_batches", "shard_stacked_batch"}
PACKAGES = ("", "graph", "ops", "train", "models", "eval", "parallel")


def _public_names(init_path):
    tree = ast.parse(open(init_path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", PACKAGES)
def test_init_reexports_the_jax_names(sub):
    path = os.path.join(REPO, "buckgnn_tpu", sub, "__init__.py")
    names = _public_names(path) - NOT_PORTED
    assert names, path
    port = importlib.import_module(
        "buckgnn_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, (sub, missing)
    if not sub:
        jax_pkg = importlib.import_module("buckgnn_tpu")
        assert port.__version__ == jax_pkg.__version__


def _case(sorted_ids, width, seed=0):
    rng = np.random.default_rng(seed)
    n, num = 40, 7
    # segment 3 gets no element; large logits test the shift
    ids = rng.choice([0, 1, 2, 4, 5, 6], n)
    if sorted_ids:
        ids = np.sort(ids)
    shape = (n,) if width is None else (n, width)
    logits = (rng.standard_normal(shape) * 4 + 30).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    return logits, ids.astype(np.int32), num, cot


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("width", [None, 3])
def test_segment_softmax_weights_matches_jax(sorted_ids, width):
    logits, ids, num, cot = _case(sorted_ids, width)
    ref, vjp = jax.vjp(lambda v: j_softmax(
        v, jnp.asarray(ids), num, indices_are_sorted=sorted_ids),
        jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = segment_softmax_weights(t, torch.from_numpy(ids), num,
                                  indices_are_sorted=sorted_ids)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-6)
    # each non-empty segment's weights sum to 1; the empty one has none
    sums = np.zeros((num,) + logits.shape[1:], np.float64)
    np.add.at(sums, ids, got.detach().numpy().astype(np.float64))
    present = np.isin(np.arange(num), ids)
    np.testing.assert_allclose(sums[present], 1.0, atol=1e-6)
    assert not present[3] and np.all(sums[3] == 0)
