"""The backward's pre-split layouts on the variants' weight tile
(csrc/wtile.cuh), modelled by their plain versions.

The float32 / any-width SAGE backward (#2s, #3s) runs dagg | dxp = dout @
[W_l^T | W_r^T] on the weight tile from the transposed weights pre-split
(`presplit_t_plain`: W's rows, split, each 32-deep slice in WTILE_DEPTH
order), and its weight pass [dW_l; dW_r] = [agg | x]^T @ dout on the same
tile with A read transposed, from dout pre-split over its rows in
WTILE_TDEPTH order (`presplit_plain(..., order=WTILE_TDEPTH)`), in row
chunks (`weight_pass_plain`). The float32 / any-width EA backward (#6s)
runs its dz @ W^T on the same tile, its dx = [r_de1 | s] @ [W_er^T;
W_sp^T] from the two transposed weights stacked in depth
(`presplit_tk_plain`). The kernels have no CPU mode; held here:
- WTILE_TDEPTH is a permutation of each slice under which a quarter warp's
  transposed fragment reads (rows fr..fr + 7 of C, depths 8 kk + 2 q + j)
  fall on distinct shared-memory banks (float32) or on 16 words, two lanes
  each (bf16);
- both pre-splits map back to tf32(B) and tf32(B - hi) bit for bit at H
  128, 384 and 512 (the activation one at ragged row counts, its depths
  past the rows zero; the depth-stacked pair at H 128 and 384), their
  parts are tf32 values and add up to B within 2^-22;
- the weight pass over ragged row counts in chunks, and the transposed
  weights' products (SAGE's, EA's K = 3H dx and its encoder's N = 128
  product), stay within `SIMPLE_F32_TOL` of max|ref| of the float64
  product; bf16 takes one pass;
- `_ksplit` gives the weight pass chunks of at most 2,048 rows and at least
  two work items an SM.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from buckgnn_tpu_torch.ops import banded_matmul as bm
from buckgnn_tpu_torch.ops import sage_layer as sl


def _rand(shape, seed, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _banks(offsets):
    """(distinct banks, distinct 4-byte words) of one warp's loads at these
    byte offsets."""
    words = {o // 4 for o in offsets}
    return len({w % 32 for w in words}), len(words)


@pytest.mark.parametrize("size", [4, 2])
def test_transposed_fragment_reads_are_free_of_bank_conflicts(size):
    """The byte offsets at_fragment reads (element (k, m) of a 128-byte-row
    box at k * 128 + ((m * size / 16) ^ (k & 7)) * 16 + (m * size) % 16),
    for every warp, row half, wgmma step and column: float32 on 32 banks,
    bf16 on 16 words read by two lanes each (no conflict)."""
    d = bm.WTILE_TDEPTH
    assert sorted(d) == list(range(32))
    boxm = 128 // size
    for w in range(4):
        for h in range(2):
            for kk in range(4):
                for j in range(2):
                    offs = []
                    for lane in range(32):
                        q = lane % 4
                        fr = 16 * w + lane // 4
                        m = fr % boxm + 8 * h
                        k = d[8 * kk + q + 4 * j]
                        assert k == 8 * kk + 2 * q + j
                        cb = m * size
                        offs.append(k * 128 + (((cb >> 4) ^ (k & 7)) << 4)
                                    + (cb & 15))
                    banks, words = _banks(offs)
                    assert banks == words
                    assert words == (32 if size == 4 else 16)


# (H, stacked): SAGE's [W_l^T | W_r^T] side by side; the EA backward's
# [W_er^T; W_sp^T] stacked in depth (W_sp [H, 2H] as stored)
SPLIT_T_CASES = [(128, False), (384, False), (512, False), (128, True),
                 (384, True)]
SPLIT_T_IDS = ["128", "384", "512", "ea_dx-128", "ea_dx-384"]


@pytest.mark.parametrize("h,stacked", SPLIT_T_CASES, ids=SPLIT_T_IDS)
def test_transposed_weights_map_back_bit_for_bit(h, stacked):
    """[W_l^T | W_r^T]'s pre-split, and [W_er^T; W_sp^T]'s, is W's rows
    split in WTILE_DEPTH order, no transpose, and maps back to tf32(B),
    tf32(B - hi)."""
    if stacked:
        _check_stacked_t(h)
        return
    w_l, w_r = _rand((h, h), h, h ** -0.5), _rand((h, h), h + 1, h ** -0.5)
    p = bm.presplit_t_plain(w_l, w_r)
    assert p.shape == (2, 2 * h, h)
    order = bm._slice_order(h)
    for half, w in enumerate((w_l, w_r)):
        rows = p[:, half * h:(half + 1) * h]
        hi = bm.tf32_round(w[:, order])
        assert torch.equal(rows[0].view(torch.int32), hi.view(torch.int32))
        assert torch.equal(rows[1].view(torch.int32),
                           bm.tf32_round(w[:, order] - hi).view(torch.int32))
    hi, lo = bm.presplit_parts(p)
    b = torch.cat([w_l.t(), w_r.t()], 1)
    want = bm.tf32_round(b)
    assert torch.equal(hi.contiguous().view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(lo.contiguous().view(torch.int32),
                       bm.tf32_round(b - want).view(torch.int32))


def _check_stacked_t(h):
    """B = [W_er^T; W_sp^T] [3H, H]: row n of each part is [W_er | W_sp]'s
    row n in the slices' order, and the parts map back to B's."""
    w_er = _rand((h, h), h + 11, h ** -0.5)
    w_sp = _rand((h, 2 * h), h + 12, (2 * h) ** -0.5)
    p = bm.presplit_tk_plain(w_er, w_sp)
    assert p.shape == (2, h, 3 * h)
    rows = torch.cat([w_er, w_sp], 1)[:, bm._slice_order(3 * h)]
    hi = bm.tf32_round(rows)
    assert torch.equal(p[0].view(torch.int32), hi.view(torch.int32))
    assert torch.equal(p[1].view(torch.int32),
                       bm.tf32_round(rows - hi).view(torch.int32))
    back_hi, back_lo = bm.presplit_parts(p)
    b = torch.cat([w_er.t(), w_sp.t()])
    want = bm.tf32_round(b)
    assert torch.equal(back_hi.contiguous().view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(back_lo.contiguous().view(torch.int32),
                       bm.tf32_round(b - want).view(torch.int32))


@pytest.mark.parametrize("h", [128, 384, 512])
@pytest.mark.parametrize("rows", [96, 1000])
def test_activation_presplit_maps_back_bit_for_bit(h, rows):
    """dout [rows, H]'s pre-split in WTILE_TDEPTH order: [2, H, rows
    rounded up to 32], mapping back to tf32(dout) and tf32(dout - hi), the
    depths past the rows zero."""
    dout = _rand((rows, h), rows + h)
    p = bm.presplit_plain(dout, order=bm.WTILE_TDEPTH)
    k = -(-rows // 32) * 32
    assert p.shape == (2, h, k)
    hi, lo = bm.presplit_parts(p, bm.WTILE_TDEPTH)
    want = bm.tf32_round(dout)
    assert torch.equal(hi[:rows].contiguous().view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(lo[:rows].contiguous().view(torch.int32),
                       bm.tf32_round(dout - want).view(torch.int32))
    assert int(torch.count_nonzero(hi[rows:])) == 0
    assert int(torch.count_nonzero(lo[rows:])) == 0


@pytest.mark.parametrize("which", ["weights", "dout"])
def test_backward_parts_are_tf32_and_add_up(which):
    if which == "weights":
        w = _rand((384, 384), 5, 384 ** -0.5)
        p, order, b = bm.presplit_t_plain(w), bm.WTILE_DEPTH, w.t()
    else:
        b = _rand((544, 256), 6)
        p, order = bm.presplit_plain(b, order=bm.WTILE_TDEPTH), \
            bm.WTILE_TDEPTH
    assert int(torch.count_nonzero(p.view(torch.int32) & 0x1FFF)) == 0
    hi, lo = bm.presplit_parts(p, order)
    rel = ((hi.double() + lo.double() - b.double()).abs()
           / b.double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -22


def test_bf16_backward_presplits_are_one_part():
    w = _rand((640, 640), 7, 640 ** -0.5, torch.bfloat16)
    p = bm.presplit_t_plain(w)
    assert p.shape == (1, 640, 640)
    assert torch.equal(bm.presplit_parts(p)[0], w.t().float())
    d = _rand((200, 384), 8, dtype=torch.bfloat16)
    p = bm.presplit_plain(d, order=bm.WTILE_TDEPTH)
    assert p.shape == (1, 384, 224)
    assert torch.equal(bm.presplit_parts(p, bm.WTILE_TDEPTH)[0][:200],
                       d.float())


# (product, H): SAGE's dout @ [W_l^T | W_r^T]; the EA backward's dx =
# [r_de1 | s] @ [W_er^T; W_sp^T] (K = 3H) and its encoder's deoc @
# W_en2^T (N = 128)
PRODUCT_T_CASES = [("sage", 128), ("sage", 384), ("ea_dx", 128),
                   ("ea_enc", 384)]
PRODUCT_T_IDS = ["128", "384", "ea_dx-128", "ea_enc-384"]


@pytest.mark.parametrize("which,h", PRODUCT_T_CASES, ids=PRODUCT_T_IDS)
def test_transposed_weight_product_holds_the_float32_gate(which, h):
    """A product with a transposed weight on the weight tile's arithmetic
    from the transposed pre-split, against the float64 product."""
    if which == "sage":
        a = _rand((160, h), h + 2)
        w_l, w_r = _rand((h, h), h + 3, h ** -0.5), _rand((h, h), h + 4,
                                                          h ** -0.5)
        p, w = bm.presplit_t_plain(w_l, w_r), torch.cat([w_l, w_r])
    elif which == "ea_dx":
        a = _rand((160, 3 * h), h + 5)
        w = torch.cat([_rand((h, h), h + 6, h ** -0.5),
                       _rand((h, 2 * h), h + 7, (2 * h) ** -0.5)], 1)
        p = bm.presplit_tk_plain(w[:, :h], w[:, h:])
    else:
        a = _rand((160, h), h + 8)
        w = _rand((128, h), h + 9, h ** -0.5)
        p = bm.presplit_t_plain(w)
    got = bm.weight_tile_plain(a, p)
    assert got.shape == (160, w.shape[0])
    ref = a.double() @ w.double().t()
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= bm.SIMPLE_F32_TOL


# (rows, M, N, kchunk): ragged row counts, a last chunk shorter than the
# others and one not a whole slice
PASS_SHAPES = {"r1000_c256": (1000, 256, 128, 256),
               "r4099_c2048": (4099, 128, 128, 2048),
               "r2080_c1024_m384": (2080, 384, 128, 1024)}


@pytest.mark.parametrize("name", sorted(PASS_SHAPES))
def test_weight_pass_in_chunks_holds_the_float32_gate(name):
    rows, m, n, kchunk = PASS_SHAPES[name]
    a = _rand((rows, m), rows)
    dout = _rand((rows, n), rows + 1)
    got = bm.weight_pass_plain(
        a, bm.presplit_plain(dout, order=bm.WTILE_TDEPTH), kchunk)
    ref = a.double().t() @ dout.double()
    assert got.shape == (m, n)
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= bm.SIMPLE_F32_TOL
    # the chunks' sums add up to the one-chunk pass within the same gate
    whole = bm.weight_pass_plain(
        a, bm.presplit_plain(dout, order=bm.WTILE_TDEPTH), -(-rows // 32) * 32)
    assert float((got.double() - whole.double()).abs().max()
                 / ref.abs().max()) <= bm.SIMPLE_F32_TOL


def test_bf16_weight_pass_is_one_pass():
    a = _rand((300, 128), 9, dtype=torch.bfloat16)
    d = _rand((300, 128), 10, dtype=torch.bfloat16)
    got = bm.weight_pass_plain(a, bm.presplit_plain(
        d, order=bm.WTILE_TDEPTH), 128)
    ref = a.double().t() @ d.double()
    torch.testing.assert_close(got.double(), ref, atol=1e-5 * float(
        ref.abs().max()), rtol=0)


@pytest.mark.parametrize("n,h", [(103424, 512), (51712, 1024), (58368, 384),
                                 (103424, 128), (1024, 512)])
def test_ksplit_chunks(n, h):
    """The weight pass's chunks: whole 64-row blocks of at most 2,048 rows
    where 64 chunks suffice, at least two work items an SM on 132 SMs where
    the rows allow, and never an empty chunk."""
    k = sl._ksplit(n, h)
    kchunk = -(-(-(-n // k)) // 64) * 64
    nz = -(-n // kchunk)
    assert 1 <= nz <= k <= 64
    tiles = 2 * (h // 128) ** 2
    if n <= 64 * 2048:
        assert kchunk <= 2048
    if n // 64 >= -(-264 // tiles) and k < 64:
        assert k * tiles >= 264
    assert (nz - 1) * kchunk < n
