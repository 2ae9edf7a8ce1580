"""The arithmetic of the float32 variants' product tile (csrc/simple.cuh).

On the card the float32 variants of #1-#6 split each float32 operand into
hi = tf32(x) and lo = tf32(x - hi) (PTX ``cvt.rna.tf32.f32``) and sum
hi.hi + hi.lo + lo.hi on the tensor cores. The kernel has no CPU mode;
its arithmetic is modelled by ``ops/banded_matmul.py``'s `tf32_round` and
`mm_3xtf32`, held here:
- `tf32_round` on hand-picked edge values (ties away from zero, the carry
  into the exponent, overflow to inf, subnormals, signed zeros, inf and
  nan) and, on random normal values, against the rounding worked out in
  float64;
- at the products' shapes of #3s and #6s (depth 512 for the node and edge
  products, a 2,048-row chunk of a weight gradient), `mm_3xtf32` within
  the float32 gate `SIMPLE_F32_TOL` of max|ref| of the JAX package's
  float32 ``jnp.dot(..., precision="highest")``, while one TF32 pass
  (hi.hi alone) falls outside it: the gate tells the two apart;
- bf16 values are tf32 values: they round to themselves, their lo part
  is zero, and the split product equals the one-pass product.

Inputs are made with numpy from a seed and given to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.ops import banded_matmul as bm


def _bits(x: torch.Tensor) -> list[int]:
    return [int(b) & 0xFFFFFFFF for b in x.view(torch.int32)]


def _f32(*bits: int) -> torch.Tensor:
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.int32)).view(
        torch.float32)


def test_tf32_round_edge_values():
    one = 0x3F800000
    cases = [  # (input bits, rounded bits)
        (one, one),                                # a tf32 value stays
        (one | 0x0FFF, one),                       # under half a unit: down
        (one | 0x1000, one + 0x2000),              # a tie: away from zero
        (0x80000000 | one | 0x1000,
         0x80000000 | (one + 0x2000)),             # a negative tie: away
        (one | 0x1001, one + 0x2000),              # over half a unit: up
        (one | 0x3000, one + 0x4000),              # a tie on an odd unit
        (0x3FFFF000, 0x40000000),                  # carry into the exponent
        (0x7F7FFFFF, 0x7F800000),                  # past the largest: inf
        (0x7F7FE000, 0x7F7FE000),                  # the largest tf32 value
        (0x00000FFF, 0x00000000),                  # a subnormal, down to 0
        (0x00001000, 0x00002000),                  # a subnormal tie: away
        (0x007FF000, 0x00800000),                  # subnormal to normal
        (0x80000000, 0x80000000),                  # -0 keeps its sign
        (0x00000000, 0x00000000),
        (0x7F800000, 0x7F800000),                  # inf
        (0xFF800000, 0xFF800000),                  # -inf
    ]
    got = bm.tf32_round(_f32(*(c[0] for c in cases)))
    assert _bits(got) == [c[1] for c in cases]
    nan = bm.tf32_round(torch.tensor([float("nan"), -float("nan")]))
    assert bool(torch.isnan(nan).all())


def test_tf32_round_matches_float64_rounding():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20000),
                        rng.standard_normal(2000) * 1e30,
                        rng.standard_normal(2000) * 1e-30]).astype(np.float32)
    got = bm.tf32_round(torch.from_numpy(x)).numpy()
    v = x.astype(np.float64)
    _, e = np.frexp(v)  # |v| = m * 2^e, 0.5 <= m < 1: 11 significant bits
    unit = np.ldexp(1.0, e - 11)
    want = np.sign(v) * np.floor(np.abs(v) / unit + 0.5) * unit
    np.testing.assert_array_equal(got, want.astype(np.float32))


# (a [M, K], b [K, N]) shapes: a node or edge product at depth 512, and a
# weight-gradient chunk x^T @ dz over 2,048 rows
SHAPES = {"product_k512": ((256, 512), (512, 128)),
          "dw_chunk_2048": ((128, 2048), (2048, 128))}


def _operands(name):
    (m, k), (_, n) = SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ref = np.array(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                            precision="highest"))
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ref)


def _err_over_max(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("name", list(SHAPES))
def test_3xtf32_holds_the_float32_gate(name):
    a, b, ref = _operands(name)
    exact = (a.double() @ b.double()).float()
    got = bm.mm_3xtf32(a, b)
    assert _err_over_max(got, ref) <= bm.SIMPLE_F32_TOL
    # the split keeps float32's accuracy: as close to the exact product as
    # the float32 reference itself, within a few of its roundings
    assert _err_over_max(got, exact) <= 4 * _err_over_max(ref, exact) + 1e-7


@pytest.mark.parametrize("name", list(SHAPES))
def test_one_tf32_pass_fails_the_float32_gate(name):
    a, b, ref = _operands(name)
    one_pass = bm.mm_3xtf32(a, b, lo=False)
    assert _err_over_max(one_pass, ref) > 5 * bm.SIMPLE_F32_TOL


def test_bf16_values_round_to_themselves():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32))
    a, b = a.bfloat16().float(), b.bfloat16().float()
    for x in (a, b):
        hi = bm.tf32_round(x)
        assert torch.equal(hi, x)
        assert int(torch.count_nonzero(bm.tf32_round(x - hi))) == 0
    assert torch.equal(bm.mm_3xtf32(a, b), bm.mm_3xtf32(a, b, lo=False))
