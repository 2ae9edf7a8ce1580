"""The port's unfused-layer ops (segment reductions, the CSR aggregation,
l2_normalize, the relu/skip/dropout epilogue) == the JAX package's.

On the CPU the wrappers of the CUDA kernels #7 (`csr_segment_sum`) and
#8/#9 (`epilogue_fwd`, `epilogue_bwd`) run their plain versions. Held to:

- JAX `gather_segment_reduce(interpret=True)` (kernel #7 in interpret
  mode) and `ops/sage.py::sage_aggregate` at the shape of
  tests/test_segment.py:117-142 (n 512, h 128, an 800-degree hub), 'add',
  'mean' and 'max', and at an N that is not a multiple of 256 (where JAX
  falls back to its segment ops);
- `jax.vjp` of the 'xla' route for the port's backward over the
  transposed CSR, on an asymmetric edge set;
- the JAX `l2_normalize` forward and VJP, a zero row included;
- the JAX `relu_skip_dropout` at rate 0, forward and VJP; at rate 0.1 the
  Function's backward against autograd of the plain forward, bit for bit;
- the CSR kernel's gate and the epilogue's bit-equality, which must fail
  the faults of `csr_segment.faults` and `epilogue.faults`.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.models.blocks import l2_normalize as j_l2n
from buckgnn_tpu.ops import segment as j_seg
from buckgnn_tpu.ops.pallas_epilogue import relu_skip_dropout as j_epilogue
from buckgnn_tpu.ops.pallas_segment import gather_segment_reduce as j_gsr
from buckgnn_tpu.ops.sage import sage_aggregate as j_sage_aggregate
from buckgnn_tpu_torch.models.blocks import l2_normalize
from buckgnn_tpu_torch.ops import csr_segment as cs
from buckgnn_tpu_torch.ops import epilogue as ep
from buckgnn_tpu_torch.ops import segment
from buckgnn_tpu_torch.ops.dropout import keep_mask
from buckgnn_tpu_torch.ops.sage import _gather_messages, sage_aggregate

SEED = (0x2545F491, 0x9E3779B9)
# fp32: the same sums in another order, 1e-5 relative to the largest entry
F32_TOL = 1e-5
# bf16 against JAX: the port sums in f32 and rounds once, as JAX's kernel
# #7 does: one ulp (2^-8 relative, 8e-3 of the largest entry). XLA's bf16
# scatter-add rounds to bf16 after every add, so its sums drift by a few
# ulps of the largest entry over the few edges of an ordinary row (3e-2),
# and on the 800-edge hub by far more (7.2 on entries of 124 here, where
# the port is within 0.2 of the exact sum): the hub's row is held to the
# exact float64 sum instead, within one ulp.
BF16_XLA_TOL = 3e-2
BF16_ULP_TOL = 8e-3
HUB = 3


def _graph(n, n_edges=2000, hub=800, seed=5, symmetric=False):
    """Receiver-sorted (senders, receivers) of random edges plus a hub of
    ``hub`` in-edges at node 3 (tests/test_segment.py:124-126); the last
    node (the dead row) receives no edge. Asymmetric unless asked."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n - 1, size=n_edges),
                        np.full(hub, 3)])
    s = rng.integers(0, n - 1, size=len(r))
    if symmetric:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    order = np.argsort(r, kind="stable")
    return s[order].astype(np.int32), r[order].astype(np.int32)


def _x(n, h, seed=0):
    return np.random.default_rng(seed).normal(size=(n, h)).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    """max |got - want| within ``tol`` of the largest |want|."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("n", [512, 500])
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_aggregation_matches_jax_fp32(n, aggr):
    """Both port impls against JAX's kernel #7 (interpret mode; at n 500 its
    XLA fallback) and JAX's 'xla' route, fp32."""
    s, r = _graph(n)
    x = _x(n, 128)
    want_pallas = np.asarray(j_gsr(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(r), n, aggr=aggr,
                                   interpret=True))
    want_xla = np.asarray(j_sage_aggregate(jnp.asarray(x), jnp.asarray(s),
                                           jnp.asarray(r), n, aggr=aggr))
    xt, st, rt = (torch.from_numpy(a) for a in (x, s, r))
    ctx = cs.make_csr_context(st, rt, n)
    for got in (sage_aggregate(xt, st, rt, n, aggr, impl="pallas", csr=ctx),
                sage_aggregate(xt, st, rt, n, aggr, impl="xla")):
        assert got.dtype == torch.float32
        _close(got, want_pallas, F32_TOL)
        _close(got, want_xla, F32_TOL)


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_aggregation_matches_jax_bf16(aggr):
    """bf16 rows: the sum returns bf16 and the mean float32 (the rounded
    sum over the count), on both JAX routes and both port impls."""
    n = 512
    s, r = _graph(n)
    x = _x(n, 128)
    jx = jnp.asarray(x, jnp.bfloat16)
    want_pallas = j_gsr(jx, jnp.asarray(s), jnp.asarray(r), n, aggr=aggr,
                        interpret=True)
    want_xla = j_sage_aggregate(jx, jnp.asarray(s), jnp.asarray(r), n,
                                aggr=aggr)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, rt = torch.from_numpy(s), torch.from_numpy(r)
    want_dtype = torch.bfloat16 if aggr == "add" else torch.float32
    assert str(want_pallas.dtype) == str(want_xla.dtype) == str(
        want_dtype).split(".")[1]
    exact = np.zeros((n, 128))
    np.add.at(exact, r, np.asarray(jx, np.float64)[s])
    if aggr == "mean":
        exact /= np.maximum(np.bincount(r, minlength=n), 1)[:, None]
    rest = np.arange(n) != HUB
    for impl in ("pallas", "xla"):
        got = sage_aggregate(xt, st, rt, n, aggr, impl=impl)
        assert got.dtype == want_dtype
        _close(got, np.asarray(want_pallas, np.float32), BF16_ULP_TOL)
        _close(got[rest], np.asarray(want_xla, np.float32)[rest],
               BF16_XLA_TOL)
        _close(got[HUB], exact[HUB], BF16_ULP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_csr_backward_matches_jax_vjp(dtype, aggr):
    """The backward over the transposed CSR against jax.vjp of the 'xla'
    route on an asymmetric edge set (senders and receivers drawn apart, a
    hub that sends nothing back): fp32 to round-off, bf16 within a few
    ulps of the largest entry (JAX's bf16 scatter-add rounds per add)."""
    n = 512
    s, r = _graph(n, n_edges=1500, hub=300, seed=9)
    pairs = set(zip(s.tolist(), r.tolist()))
    assert sum((b, a) not in pairs for a, b in pairs) > 1000, "asymmetric"
    x, g = _x(n, 128, 1), _x(n, 128, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out, vjp = jax.vjp(lambda v: j_sage_aggregate(
        v, jnp.asarray(s), jnp.asarray(r), n, aggr=aggr),
        jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, out.dtype))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = sage_aggregate(xt, torch.from_numpy(s), torch.from_numpy(r), n,
                         aggr, impl="pallas")
    got.backward(torch.from_numpy(g).to(got.dtype))
    assert xt.grad.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_XLA_TOL
    _close(xt.grad, np.asarray(want, np.float32), tol)
    # and against autograd of the plain version (the 'xla' route)
    xp = torch.from_numpy(x).to(tdt).requires_grad_(True)
    sage_aggregate(xp, torch.from_numpy(s), torch.from_numpy(r), n, aggr,
                   impl="xla").backward(torch.from_numpy(g).to(got.dtype))
    _close(xt.grad, xp.grad, tol)


def test_segment_ops_match_jax():
    """segment_sum, segment_count (masked), segment_mean (masked; empty
    segments 0) and segment_max (empty segments 0), fp32."""
    rng = np.random.default_rng(3)
    ids = np.sort(rng.integers(0, 40, size=300)).astype(np.int32)
    ids[ids == 7] = 8  # an empty segment
    data = rng.normal(size=(300, 16)).astype(np.float32)
    mask = rng.random(300) < 0.8
    jd, ji, jm = jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask)
    td, ti, tm = (torch.from_numpy(a) for a in (data, ids, mask))
    _close(segment.segment_sum(td, ti, 41), j_seg.segment_sum(jd, ji, 41),
           F32_TOL)
    _close(segment.segment_count(ti, 41, tm),
           j_seg.segment_count(ji, 41, mask=jm), 0.0)
    _close(segment.segment_mean(td, ti, 41, tm),
           j_seg.segment_mean(jd, ji, 41, mask=jm), F32_TOL)
    got = segment.segment_max(td, ti, 41)
    _close(got, j_seg.segment_max(jd, ji, 41), 0.0)
    assert bool((got[7] == 0).all()) and bool((got[40] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_route_with_pad_edges_matches_jax(dtype):
    """The 'xla' route where the dead row sends 2,000 pad edges to itself,
    as it does in a padded batch: the messages are x[senders] bit for bit
    (the backward sends the dead row's duplicates to spare rows), and the
    output and its backward match jax.vjp: fp32 to round-off; bf16 within
    a few ulps of the largest entry (XLA's bf16 scatter-add rounds per
    add). The dead row's gradient, the sum of its 2,000 cotangents, is
    held to the exact sum: to round-off in fp32, one ulp in bf16."""
    n = 300
    s, r = _graph(n, n_edges=700, hub=100, seed=4)
    s = np.concatenate([s, np.full(2000, n - 1, np.int32)])
    r = np.concatenate([r, np.full(2000, n - 1, np.int32)])
    x, g = _x(n, 64, 5), _x(n, 64, 6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    st, rt = torch.from_numpy(s), torch.from_numpy(r)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    assert torch.equal(_gather_messages(xt.detach(), st),
                       xt.detach()[st.long()])
    out, vjp = jax.vjp(lambda v: j_sage_aggregate(
        v, jnp.asarray(s), jnp.asarray(r), n), jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, out.dtype))
    got = sage_aggregate(xt, st, rt, n, impl="xla")
    got.backward(torch.from_numpy(g).to(got.dtype))
    assert xt.grad.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_XLA_TOL
    _close(got.detach()[:-1], np.asarray(out, np.float32)[:-1], tol)
    _close(xt.grad[:-1], np.asarray(want, np.float32)[:-1], tol)
    # the dead row against the exact sum: JAX's sequential scatter-add
    # drifts by 2e-5 over the 2,000 adds in fp32
    gd = torch.from_numpy(g[-1]).to(tdt).double().numpy() * 2000
    _close(xt.grad[-1], gd, F32_TOL if dtype == "float32" else BF16_ULP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_normalize_matches_jax(dtype):
    """Forward (the plain form without autograd, the residual form under
    it) and VJP against JAX's custom-VJP l2_normalize, a zero row
    included: fp32 to round-off, bf16 within an ulp or two of the entry
    (the row sums are taken in another order)."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(40, 128)).astype(np.float32)
    v[5] = 0.0
    g = rng.normal(size=(40, 128)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y, vjp = jax.vjp(j_l2n, jnp.asarray(v, jdt))
    (dv,) = vjp(jnp.asarray(g, jdt))
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    with torch.no_grad():
        plain = l2_normalize(torch.from_numpy(v).to(tdt))
    vt = torch.from_numpy(v).to(tdt).requires_grad_(True)
    yt = l2_normalize(vt)
    yt.backward(torch.from_numpy(g).to(tdt))
    assert plain.dtype == yt.dtype == vt.grad.dtype == tdt
    for got, want in ((plain, y), (yt, y), (vt.grad, dv)):
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 0.1)
    assert bool(torch.isfinite(vt.grad).all())
    assert bool((yt[5] == 0).all())


@pytest.mark.parametrize("skip", [True, False])
def test_epilogue_matches_jax_at_rate_0(skip):
    """relu(c) (+ p) and its VJP against JAX's relu_skip_dropout at rate 0
    (no key), bf16: the same bf16 operations, bit for bit."""
    rng = np.random.default_rng(6)
    c, p, g = (rng.normal(size=(64, 128)).astype(np.float32)
               for _ in range(3))
    jc, jp = jnp.asarray(c, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16)
    if skip:
        y, vjp = jax.vjp(lambda a, b: j_epilogue(a, b, None, 0.0), jc, jp)
    else:
        y, vjp = jax.vjp(lambda a: j_epilogue(a, None, None, 0.0), jc)
    grads = vjp(jnp.asarray(g, jnp.bfloat16))
    tc = torch.from_numpy(c).to(torch.bfloat16).requires_grad_(True)
    tp = torch.from_numpy(p).to(torch.bfloat16).requires_grad_(True)
    yt = ep.relu_skip_dropout(tc, tp if skip else None, None, 0.0)
    yt.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    np.testing.assert_array_equal(tc.grad.float().numpy(),
                                  np.asarray(grads[0], np.float32))
    if skip:
        np.testing.assert_array_equal(tp.grad.float().numpy(),
                                      np.asarray(grads[1], np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [True, False])
def test_epilogue_function_matches_autograd_at_rate_0_1(dtype, skip):
    """Rate 0.1: the Function (plain forward, plain backward from c alone)
    against autograd of the plain forward, bit for bit; the mask drops the
    hashed positions (about 10%) and scales the rest by 1/keep."""
    rng = np.random.default_rng(7)
    c, p, g = (torch.from_numpy(rng.normal(size=(300, 136)).astype(
        np.float32)).to(dtype) for _ in range(3))
    ca, pa = c.clone().requires_grad_(True), p.clone().requires_grad_(True)
    cb, pb = c.clone().requires_grad_(True), p.clone().requires_grad_(True)
    y = ep.relu_skip_dropout(ca, pa if skip else None, SEED, 0.1)
    y.backward(g)
    yp = ep.epilogue_fwd_plain(cb, pb if skip else None, SEED, 0.1)
    yp.backward(g)
    assert torch.equal(y, yp) and torch.equal(ca.grad, cb.grad)
    if skip:
        assert torch.equal(pa.grad, pb.grad)
    keep = keep_mask(SEED, 300, 136, 0.1, "cpu")
    assert bool((y[~keep] == 0).all())
    assert abs(float((~keep).float().mean()) - 0.1) < 0.01


def test_gates_catch_faults():
    """The CSR gate passes the plain sums held to themselves and fails the
    faults of `csr_segment.faults` (a lost last edge; on bf16 rows a mean
    taken before the rounding); the epilogue's bit-equality fails a mask
    from the wrong seed word and a backward without the relu mask."""
    n = 512
    s, r = _graph(n)
    ctx = cs.make_csr_context(torch.from_numpy(s), torch.from_numpy(r), n)
    x = torch.from_numpy(_x(n, 128)).to(torch.bfloat16)
    for idx, off in ((ctx.senders, ctx.row_off), (ctx.t_idx, ctx.t_off)):
        for mean in (False, True):
            ref = cs.csr_segment_sum_plain(x, idx, off, mean)
            assert cs.gate(ref, ref, x.dtype)[0]
            wrong = cs.faults(x, idx, off, mean)
            assert set(wrong) == ({"skip-last-edge", "mean-before-rounding"}
                                  if mean else {"skip-last-edge"})
            for name, bad in wrong.items():
                ok, _, share = cs.gate(bad, ref, x.dtype)
                assert not ok, (name, share)
    rng = np.random.default_rng(8)
    c, p, g = (torch.from_numpy(rng.normal(size=(64, 128)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    y = ep.epilogue_fwd_plain(c, p, SEED, 0.1)
    dc, dp = ep.epilogue_bwd_plain(g, c, SEED, 0.1, True)
    wrong = ep.faults(g, c, p, SEED, 0.1)
    assert not torch.equal(wrong["wrong-seed-word"][0], y)
    assert not torch.equal(wrong["wrong-seed-word"][1][0], dc)
    assert not torch.equal(wrong["no-relu-mask"][1][0], dc)
    assert torch.equal(wrong["no-relu-mask"][1][1], dp)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the kernel wrappers run the plain versions and count
    no launch."""
    n = 256
    s, r = _graph(n, n_edges=600, hub=50)
    ctx = cs.make_csr_context(torch.from_numpy(s), torch.from_numpy(r), n)
    x = torch.from_numpy(_x(n, 64)).to(torch.bfloat16)
    cs.reset_launch_counts()
    ep.reset_launch_counts()
    for mean in (False, True):
        assert torch.equal(cs.csr_segment_sum(x, ctx.senders, ctx.row_off,
                                               mean),
                           cs.csr_segment_sum_plain(x, ctx.senders,
                                                    ctx.row_off, mean))
    assert torch.equal(ep.epilogue_fwd(x, x, SEED, 0.1),
                       ep.epilogue_fwd_plain(x, x, SEED, 0.1))
    assert cs.LAUNCHES == {"csr_segment": 0}
    assert ep.LAUNCHES == {"epilogue_fwd": 0, "epilogue_bwd": 0}
    # the context: offsets by bincount/cumsum, in-degrees, transposed CSR
    np.testing.assert_array_equal(
        ctx.row_off.numpy(), np.searchsorted(r, np.arange(n + 1)))
    np.testing.assert_array_equal(ctx.cnt.numpy(),
                                  np.bincount(r, minlength=n))
    order = np.argsort(s, kind="stable")
    np.testing.assert_array_equal(ctx.t_idx.numpy(), r[order])
    np.testing.assert_array_equal(
        ctx.t_off.numpy(), np.searchsorted(s[order], np.arange(n + 1)))


def _padded_batch():
    """The CSR of 8 virtual-edge panels packed at suggest_capacities' caps:
    the dead row (the last) owns every pad edge, more than SPLIT of them."""
    from buckgnn_tpu_torch.graph import batch as tb
    from buckgnn_tpu_torch.graph.normalizer import normalize_dataset
    from buckgnn_tpu_torch.graph.synthetic import generate_dataset

    ds = normalize_dataset(generate_dataset(
        8, seed=7, min_side=6, max_side=9, use_super_node=False,
        use_virtual_edges=True))[0]
    ncap, ecap = tb.suggest_capacities(ds, 8)
    b = next(tb.batch_iterator(ds, 8, ncap, ecap, device="cpu"))
    assert int((b.receivers == ncap - 1).sum()) > cs.SPLIT
    return b.senders.numpy(), b.receivers.numpy(), ncap


def _csr_case(which):
    """(senders, receivers, n): the 800-degree hub graph or the padded
    batch."""
    if which == "hub":
        s, r = _graph(512)
        return s, r, 512
    return _padded_batch()


@pytest.mark.parametrize("which", ["hub", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mean", [False, True])
def test_split_order_matches_plain_and_jax(which, dtype, mean):
    """`csr_segment_sum_split_plain` (runs of more than SPLIT edges summed
    chunk by chunk, the chunk sums added in chunk order, one rounding),
    forward and over the transposed CSR: within the kernel's gate of
    `csr_segment_sum_plain`; in float32 against JAX `gather_segment_reduce`
    (interpret mode; its XLA fallback at the padded batch's N) within
    F32_TOL; in bf16 against the exact float64 sums within one ulp of the
    largest entry (the XLA fallback's bf16 scatter-add rounds after every
    add, which drifts far on the dead row's pads; see BF16_XLA_TOL)."""
    s, r, n = _csr_case(which)
    ctx = cs.make_csr_context(torch.from_numpy(s), torch.from_numpy(r), n)
    assert int(np.bincount(r, minlength=n).max()) > cs.SPLIT
    xn = _x(n, 128, seed=3)
    x = torch.from_numpy(xn).to(dtype)
    for idx, off in ((ctx.senders, ctx.row_off), (ctx.t_idx, ctx.t_off)):
        got = cs.csr_segment_sum_split_plain(x, idx, off, mean)
        ref = cs.csr_segment_sum_plain(x, idx, off, mean)
        assert got.dtype == ref.dtype
        ok, err, share = cs.gate(got, ref, dtype)
        assert ok, (err, share)
    got = cs.csr_segment_sum_split_plain(x, ctx.senders, ctx.row_off, mean)
    if dtype == torch.float32:
        want = np.asarray(j_gsr(jnp.asarray(xn), jnp.asarray(s),
                                jnp.asarray(r), n,
                                aggr="mean" if mean else "add",
                                interpret=True))
        _close(got, want, F32_TOL)
    else:
        exact = np.zeros((n, 128))
        np.add.at(exact, r, x.double().numpy()[s])
        if mean:
            exact /= np.maximum(np.bincount(r, minlength=n), 1)[:, None]
        _close(got, exact, BF16_ULP_TOL)
