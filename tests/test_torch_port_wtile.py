"""The pre-split weight layout of the variants' weight tile (csrc/wtile.cuh).

The float32 / any-width variants run every product whose B is a weight as
stored on the weight tile, which takes the weight pre-split once a call
into its tf32 parts, transposed and with each 32-deep slice's depths in
``ops/banded_matmul.py::WTILE_DEPTH`` order. The kernel has no CPU mode;
its layout and arithmetic are modelled by `presplit_plain` and
`weight_tile_plain`, held here:
- the order is a permutation of each slice, in which a consumer thread's
  fragment (rows 16 w + l / 4 (+ 8), columns l % 4 and l % 4 + 4 of each
  8-deep step) is two whole runs of 4 depths a row;
- hi and lo are tf32 values, and hi + lo reproduces W to within 2^-22 of
  |W|;
- the layout maps back to tf32(W) and tf32(W - hi) bit for bit at H 128,
  384 and 512 and for #1's stacked [W_l; W_r], and a bf16 weight to its
  one part;
- the tile's sums over the permuted order (3xTF32, each slice's sum
  rounded once) stay within the float32 gate `SIMPLE_F32_TOL` of max|ref|
  of the float64 product, at #5's and #1's depths, and a bf16 product is
  its one-pass product.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.ops import banded_matmul as bm


def _weight(k, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(w).to(dtype)


def test_slice_order_is_the_fragments_loads():
    d = bm.WTILE_DEPTH
    assert sorted(d) == list(range(32))
    for q in range(4):  # lane % 4
        # column q of steps 0..3, then column q + 4: two runs of 4 depths
        cols = [d[8 * kk + q] for kk in range(4)]
        cols4 = [d[8 * kk + q + 4] for kk in range(4)]
        assert cols == list(range(4 * q, 4 * q + 4))
        assert cols4 == list(range(16 + 4 * q, 16 + 4 * q + 4))


@pytest.mark.parametrize("h", [128, 384, 512])
def test_parts_are_tf32_and_add_up_to_the_weight(h):
    w = _weight(h, h, h)
    p = bm.presplit_plain(w)
    assert p.shape == (2, h, h) and p.dtype == torch.float32
    low = p.view(torch.int32) & 0x1FFF
    assert int(torch.count_nonzero(low)) == 0
    hi, lo = bm.presplit_parts(p)
    rel = ((hi.double() + lo.double() - w.double()).abs()
           / w.double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -22


@pytest.mark.parametrize("h", [128, 384, 512])
def test_layout_maps_back_bit_for_bit(h):
    w = _weight(h, h, h + 1)
    hi, lo = bm.presplit_parts(bm.presplit_plain(w))
    want_hi = bm.tf32_round(w)
    assert torch.equal(hi.contiguous().view(torch.int32),
                       want_hi.view(torch.int32))
    assert torch.equal(lo.contiguous().view(torch.int32),
                       bm.tf32_round(w - want_hi).view(torch.int32))


@pytest.mark.parametrize("h", [128, 512])
def test_stacked_weights_map_back_bit_for_bit(h):
    w_l, w_r = _weight(h, h, 1), _weight(h, h, 2)
    p = bm.presplit_plain(w_l, w_r)
    assert p.shape == (2, h, 2 * h)
    hi, _ = bm.presplit_parts(p)
    want = bm.tf32_round(torch.cat([w_l, w_r]))
    assert torch.equal(hi.contiguous().view(torch.int32),
                       want.view(torch.int32))
    # W_l's depths fill the first H positions, slice by slice
    assert torch.equal(p[:, :, :h], bm.presplit_plain(w_l))


@pytest.mark.parametrize("h", [384, 640])
def test_bf16_weight_is_one_part(h):
    w = _weight(h, h, 7, torch.bfloat16)
    p = bm.presplit_plain(w)
    assert p.shape == (1, h, h)
    (got,) = bm.presplit_parts(p)
    assert torch.equal(got, w.float())


# (M, K, N): #5's node and edge products at depth 512, the projection's
# [H, 2H] weight, #1's stacked pair at depth 1,024
SHAPES = {"node_k512": (192, 512, 128), "proj_n256": (128, 512, 256),
          "sage_k1024": (160, 1024, 128)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_permuted_sums_hold_the_float32_gate(name):
    m, k, n = SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = _weight(k, n, 3)
    ref = a.double() @ w.double()
    got = bm.weight_tile_plain(a, bm.presplit_plain(w))
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= bm.SIMPLE_F32_TOL
    # as close as the split product in the natural order
    base = bm.mm_3xtf32(a, w).double()
    base_err = float((base - ref).abs().max() / ref.abs().max())
    assert err <= 4 * base_err + 1e-7


def test_bf16_product_is_one_pass():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((64, 384)).astype(
        np.float32)).bfloat16()
    w = _weight(384, 128, 12, torch.bfloat16)
    got = bm.weight_tile_plain(a, bm.presplit_plain(w))
    ref = bm.mm_3xtf32(a.float(), w.float(), lo=False)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-6)
