"""The port's banded SpMM with the fused spill window (ops/banded_matmul.py).

`banded_matmul_plain`, the plain version of the CUDA kernel
``csrc/banded_matmul.cu``, is held to the JAX package's
`pallas_banded_matmul` (Pallas in interpret mode) with each of its options,
the spill window, the star-table selection and the accumulator add, on and
off, in float32 and bfloat16. Both sides get the same band, spill ranges,
codes and activations: a small virtual-edge batch packed by the port, with
random star codes over a table of tg rows and numpy data from a seed. Also
here: the spill term against a direct scatter of the spill edges, the
kernel's gate against a dropped spill, and the CPU wrapper.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.ops.pallas_banded import pallas_banded_matmul
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import sage_layer as sl

H = 128
TILE, WIDTH = 128, 64
TG = 16  # star table rows of the selection cases (codes 0..TG, TG = none)
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _batch():
    ds = generate_dataset(12, seed=2, min_side=5, max_side=9,
                          use_super_node=False, use_virtual_edges=True)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + TILE - 1) // TILE) * TILE
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    b = tb.pack_graphs(ds, ncap, ecap, 13, band_width=WIDTH, band_tile=TILE,
                       device="cpu")
    assert b.has_spill_edges and not b.has_spill2_edges
    assert ncap // TILE >= 4
    return b


def _operands(b, dtype, seed=0):
    """(band, x, options) with every option on; numpy data from ``seed``."""
    rng = np.random.default_rng(seed)
    n = b.n_node_cap
    x = torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32)).to(dtype)
    gcode = torch.from_numpy(rng.integers(0, TG + 1, size=(n // TILE, TILE, 1))
                             .astype(np.int32))
    table = torch.from_numpy(rng.normal(size=(TG, H)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32))
    opts = dict(spill=dict(spill_offsets=b.spill_offsets,
                           spill_lo=b.spill_lo, spill_hi=b.spill_hi,
                           spill_messages=x[b.spill_senders.long()]),
                table=dict(gcode=gcode, table=table.to(dtype)),
                acc=dict(acc=acc.to(dtype)))
    band = b.band.reshape(n // TILE, TILE, TILE + WIDTH)
    return band, x, opts


def _kwargs(opts, spill, table, acc):
    kw = {}
    for on, name in ((spill, "spill"), (table, "table"), (acc, "acc")):
        if on:
            kw.update(opts[name])
    return kw


def _jax(band, x, dtype, kw):
    jdt = JAX_DTYPE[dtype]
    jkw = {k: jnp.asarray(v.float().numpy()).astype(jdt)
           if v.is_floating_point() else jnp.asarray(v.numpy())
           for k, v in kw.items()}
    out = pallas_banded_matmul(jnp.asarray(band.numpy()),
                               jnp.asarray(x.float().numpy()).astype(jdt),
                               TILE, WIDTH, interpret=True, out_dtype=jdt,
                               **jkw)
    return np.array(out.astype(jnp.float32))


COMBOS = [(s, t, a) for s in (False, True) for t in (False, True)
          for a in (False, True)]


@pytest.mark.parametrize("spill,table,acc", COMBOS)
def test_plain_matches_jax_fp32(spill, table, acc):
    """float32: the same products summed in f32 on both sides, within
    1e-5 (relative, with the same absolute floor)."""
    b = _batch()
    band, x, opts = _operands(b, torch.float32)
    kw = _kwargs(opts, spill, table, acc)
    got = bm.banded_matmul_plain(band, x, tile=TILE, width=WIDTH,
                                 out_dtype=torch.float32, **kw)
    want = _jax(band, x, torch.float32, kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spill,table,acc", COMBOS)
def test_plain_matches_jax_bf16(spill, table, acc):
    """bfloat16 in and out: exact bf16 products summed in f32 and rounded
    once on both sides, so a value may round to its neighbour: held to the
    kernel's one-ulp gate, bm.KERNEL_BANDED_TOL."""
    b = _batch()
    band, x, opts = _operands(b, torch.bfloat16, seed=1)
    kw = _kwargs(opts, spill, table, acc)
    got = bm.banded_matmul_plain(band, x, tile=TILE, width=WIDTH,
                                 out_dtype=torch.bfloat16, **kw).float()
    want = torch.from_numpy(_jax(band, x, torch.bfloat16, kw))
    atol, rtol = sl.gate_tol(want, bm.KERNEL_BANDED_TOL)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_spill_term_is_the_scatter_of_the_spill_edges():
    """The window formula and the batch's lo/hi select, for every real
    row, exactly the messages of its spill edges: the spill term equals a
    scatter-add of x[spill_s] at spill_r (the dead node's padding rows
    aside)."""
    b = _batch()
    _, x, opts = _operands(b, torch.float32, seed=2)
    n = b.n_node_cap
    term = bm.spill_term_plain(x[b.spill_senders.long()], b.spill_offsets,
                               b.spill_lo, b.spill_hi, n // TILE, TILE,
                               torch.float32).reshape(n, H)
    want = torch.zeros((n, H)).index_add_(0, b.spill_receivers.long(),
                                          x[b.spill_senders.long()])
    m = b.node_mask
    assert int((b.spill_receivers != n - 1).sum()) > 0
    torch.testing.assert_close(term[m], want[m], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault,caught", [
    ("one_ulp", False), ("no_spill", True)])
def test_gate_catches_dropped_spill(fault, caught):
    """bm.KERNEL_BANDED_TOL passes an output with every value one bf16 ulp
    away and fails one computed without the spill messages."""
    b = _batch()
    band, x, opts = _operands(b, torch.bfloat16, seed=3)
    kw = _kwargs(opts, True, True, True)
    ref = bm.banded_matmul_plain(band, x, tile=TILE, width=WIDTH,
                                 out_dtype=torch.bfloat16, **kw)
    if fault == "one_ulp":
        got = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    else:
        got = bm.banded_matmul_plain(band, x, tile=TILE, width=WIDTH,
                                     out_dtype=torch.bfloat16,
                                     **_kwargs(opts, False, True, True))
    atol, rtol = sl.gate_tol(ref, bm.KERNEL_BANDED_TOL)
    bad = (got.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    assert bool(bad.any()) == caught


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors `banded_matmul` runs the plain version and launches
    nothing."""
    b = _batch()
    band, x, opts = _operands(b, torch.bfloat16, seed=4)
    kw = _kwargs(opts, True, True, True)
    before = sl.LAUNCHES["banded_matmul"]
    got = bm.banded_matmul(band, x, tile=TILE, width=WIDTH,
                           out_dtype=torch.bfloat16, **kw)
    assert sl.LAUNCHES["banded_matmul"] == before
    assert torch.equal(got, bm.banded_matmul_plain(
        band, x, tile=TILE, width=WIDTH, out_dtype=torch.bfloat16, **kw))
