"""The port's fused EA block (buckgnn_tpu_torch.ops.ea_block).

On the CPU `fused_ea_block` runs `ea_block_fwd_plain` and, in its
``torch.autograd.Function``, `ea_block_bwd_plain`: the plain versions of
the CUDA kernels. They are held to:

- the JAX package's `fused_ea_block` (the Pallas kernels in interpret mode
  at dropout rate 0) and its `jax.vjp`: forward zx and ze, and dx, de_win
  and every parameter's gradient, in plain mode (H = 128) with the skip on
  and off and in encoder mode (H = 256, where the in-kernel encoder needs
  h > 128);
- PyTorch autograd of the plain forward at rates 0 and 0.1 with the same
  seeds: the backward regenerates the forward's two masks;
- the kernels' gates (``KERNEL_FWD_TOL``, ``KERNEL_BWD_TOL``), which must
  fail a forward without its far senders, without the cnt * b_p1 term of
  the mean or without the skip, a backward without the slab-overlap
  (halo) part or the far part of dx (its norm gate), without one node's
  sender run, one far rank or the first tile's halo (its row gate), and a
  dW_sp without the far slots;
- PyTorch's FlopCounterMode over the plain versions: `pass_flops`, the
  kernels' per-pass operation counts behind chip_smoke.py's bounds.

Both sides get the same packed graphs (16 panels of 8-11 nodes a side,
tile 128, width 64, 12 node tiles, far senders present), activations and
weights, made with numpy from a seed. ze and de_win are compared on valid
slots: pads carry values on both sides that nothing reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.pallas_ea_block import fused_ea_block as j_block
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.blocks import MLP, GraphNetBlock
from buckgnn_tpu_torch.ops import ea_block as eb
from buckgnn_tpu_torch.ops import sage_layer as sl

TILE, WIDTH = 128, 64
SEED = (0x2545F491, 0x9E3779B9)
# fp32 against JAX: the same algorithm in float32 with sums in another
# order (and the sender projections summed per node rather than per tile
# slab), so values agree to f32 round-off of sums of O(1000) terms:
# 2e-4 relative to the largest entry, the JAX EA test's tolerance
# (tests/test_fused_ea_block.py:65-66, :88-90).
REL = 2e-4


def _batches():
    ds = generate_dataset(16, seed=2, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    n = sum(g.n_node for g in ds) + 1
    ncap = ((n + 2 * TILE - 1) // (2 * TILE)) * (2 * TILE)
    ecap = ((sum(g.n_edge for g in ds) + 127) // 128) * 128
    kw = dict(band_width=WIDTH, band_tile=TILE)
    ours = tb.pack_graphs(ds, ncap, ecap, 17, device="cpu", **kw)
    ref = jb.pack_graphs(ds, ncap, ecap, 17, **kw)
    assert ncap // TILE >= 4 and ours.win_sidx.shape[1] % 64 != 0
    assert int((ours.win_far_tsend != ncap - 1).sum()) > 0, "far senders"
    return ours, ref


def _lin(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}


def _params(rng, h):
    mlp = lambda i: {"lin_0": _lin(rng, i, h), "lin_1": _lin(rng, h, h)}
    return {"edge_mlp": mlp(3 * h), "node_mlp_phi": mlp(2 * h),
            "node_mlp_gamma": mlp(2 * h), "node_mlp_beta": mlp(h)}


def _enc_params(rng, h):
    return {"lin_0": _lin(rng, 5, 64), "lin_1": _lin(rng, 64, 128),
            "lin_2": _lin(rng, 128, h)}


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / denom < REL, what


def _torch_block(params, h, enc_params):
    blk = GraphNetBlock(h)
    blk.load_state_dict(params_from_flax(params))
    enc = None
    if enc_params is not None:
        enc = MLP(5, (64, 128, h))
        enc.load_state_dict(params_from_flax(enc_params))
    return blk, enc


@pytest.mark.parametrize("mode,skip", [("plain", False), ("plain", True),
                                       ("encoder", False)])
def test_block_and_vjp_match_jax_fp32(mode, skip):
    ours, ref = _batches()
    enc = mode == "encoder"
    h = 256 if enc else 128
    rng = np.random.default_rng(1)
    params = _params(rng, h)
    enc_params = _enc_params(rng, h) if enc else None
    x = rng.normal(size=(ours.n_node_cap, h)).astype(np.float32)
    x[-1] = 0.0
    t, w = ours.win_sidx.shape
    e = (ours.win_edges.numpy() if enc
         else rng.normal(size=(t, w, h)).astype(np.float32))
    dzx = rng.normal(size=x.shape).astype(np.float32)
    dze = rng.normal(size=(t, w, h)).astype(np.float32)

    def f(x_, e_, p_, q_):
        return j_block(x_, e_, p_, ref, skip=skip, rate=0.0, seed=None,
                       deterministic=True, encoder_params=q_)

    (jzx, jze), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(e), params,
                              enc_params)
    jdx, jde, jdp, jdq = vjp((jnp.asarray(dzx), jnp.asarray(dze)))

    blk, encoder = _torch_block(params, h, enc_params)
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(e, requires_grad=not enc)
    zx, ze = eb.fused_ea_block(xt, et, blk, eb.make_ea_context(ours),
                               skip=skip, encoder=encoder)
    ((zx * torch.tensor(dzx)).sum()
     + (ze * torch.tensor(dze)).sum()).backward()
    valid = (ours.win_ridx < TILE).numpy()
    _close(zx.detach(), jzx, "zx")
    _close(ze.detach().numpy()[valid], np.asarray(jze)[valid], "ze")
    _close(xt.grad, jdx, "dx")
    if not enc:
        _close(et.grad.numpy()[valid], np.asarray(jde)[valid], "de_win")
    jg = params_from_flax(jax.tree.map(np.asarray, jdp))
    for k, p in blk.named_parameters():
        _close(p.grad, jg[k], k)
    if enc:
        jq = params_from_flax(jax.tree.map(np.asarray, jdq))
        for k, p in encoder.named_parameters():
            _close(p.grad, jq[k], f"edge_encoder.{k}")


def _inputs(h, enc, seed=3):
    ours, _ = _batches()
    ctx = eb.make_ea_context(ours)
    g = torch.Generator().manual_seed(seed)
    blk = GraphNetBlock(h, generator=g)
    encoder = MLP(5, (64, 128, h), generator=g) if enc else None
    with torch.no_grad():
        for p in list(blk.parameters()) + (
                list(encoder.parameters()) if enc else []):
            if p.ndim == 1:
                p.normal_(0.0, 0.1, generator=g)
    x = torch.randn(ours.n_node_cap, h, generator=g)
    x[-1] = 0.0
    t, w = ours.win_sidx.shape
    e = ours.win_edges.clone() if enc else torch.randn(t, w, h, generator=g)
    return ours, ctx, blk, encoder, x, e, g


@pytest.mark.parametrize("enc,skip,rate", [
    (False, True, 0.0), (False, True, 0.1), (False, False, 0.1),
    (True, False, 0.1)])
def test_function_matches_autograd_of_plain(enc, skip, rate):
    """The Function's backward (ea_block_bwd_plain, with the sender-sorted
    fold of the halo and far rows) == torch autograd of ea_block_fwd_plain
    under the same dropout seeds, in float32."""
    h = 256 if enc else 128
    ours, ctx, blk, encoder, x, e, g = _inputs(h, enc)
    kw = dict(skip=skip, rate=rate, seed=SEED if rate else None,
              deterministic=False, encoder=encoder)
    dzx = torch.randn(x.shape, generator=g)
    dze = torch.randn((*e.shape[:2], h), generator=g)
    params = list(blk.parameters()) + (
        list(encoder.parameters()) if enc else [])

    def grads(run):
        xt = x.clone().requires_grad_(True)
        et = e.clone().requires_grad_(not enc)
        zx, ze = run(xt, et)
        ((zx * dzx).sum() + (ze * dze).sum()).backward()
        out = [xt.grad.clone()] + ([] if enc else [et.grad.clone()])
        out += [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        return (zx.detach(), ze.detach()), out

    def plain(xt, et):
        fe = et.shape[2]
        e_in = torch.nn.functional.pad(et, (0, eb.ENC_IN - fe)) if enc else et
        w, bias = eb.block_weights(blk, xt.dtype, encoder)
        return eb.ea_block_fwd_plain(xt, e_in, w, bias, ctx, skip=skip,
                                     rate=rate, seed=kw["seed"], enc=enc)

    (zx, ze), got = grads(lambda xt, et: eb.fused_ea_block(
        xt, et, blk, ctx, **kw))
    (zxp, zep), want = grads(plain)
    torch.testing.assert_close(zx, zxp, rtol=0, atol=0)
    torch.testing.assert_close(ze, zep, rtol=0, atol=0)
    if rate:
        dropped = float((zx == 0).float().mean())
        assert 0.08 < dropped < 0.12, dropped
    for a, b in zip(got, want):
        _close(a, b, "grad")


def _gate_ok(got, ref, tol):
    atol, rtol = sl.gate_tol(ref, tol)
    err = (got.float() - ref.float()).abs()
    return not bool((err > atol + rtol * ref.float().abs()).any())


def test_gates_catch_faults():
    """In bf16 (the kernels' type): each fault, computed by the plain
    version, fails the kernel gate held against the right plain output;
    one bf16 ulp of noise on the right forward output passes it."""
    h = 128
    ours, ctx, blk, _, x, e, g = _inputs(h, False, seed=5)
    x, e = x.bfloat16(), e.bfloat16()
    w, bias = eb.block_weights(blk, torch.bfloat16)
    w = {k: v.detach() for k, v in w.items()}
    bias = bias.detach()
    valid = (ours.win_ridx < TILE).reshape(-1)
    kw = dict(skip=True, rate=0.1, seed=SEED)
    zx, ze, e1s, m1s = eb.ea_block_fwd_plain(x, e, w, bias, ctx,
                                             save_res=True, **kw)
    ulp = (zx.float() * (1 + 2.0 ** -8)).bfloat16()
    assert _gate_ok(ulp, zx, eb.KERNEL_FWD_TOL)
    no_far = dataclasses.replace(ctx, send=torch.where(
        ours.win_sidx.reshape(-1) >= TILE + WIDTH, -1, ctx.send))
    no_cnt_b = bias.clone()
    no_cnt_b[3] = 0.0
    faults = {
        "no-far": eb.ea_block_fwd_plain(x, e, w, bias, no_far, **kw),
        "no-cnt-b": eb.ea_block_fwd_plain(x, e, w, no_cnt_b, ctx, **kw),
        "no-skip": eb.ea_block_fwd_plain(x, e, w, bias, ctx,
                                         **dict(kw, skip=False)),
    }
    for name, (fzx, fze) in faults.items():
        caught = not (_gate_ok(fzx, zx, eb.KERNEL_FWD_TOL) and _gate_ok(
            fze.reshape(-1, h)[valid], ze.reshape(-1, h)[valid],
            eb.KERNEL_FWD_TOL))
        assert caught, name
    dzx = torch.randn(x.shape, generator=g).bfloat16()
    dze = torch.randn(ze.shape, generator=g).bfloat16()
    args = (dzx, dze, e1s, m1s, x, e, w, bias)
    got = eb.ea_block_bwd_plain(*args, ctx, **kw)
    # one bf16 ulp of noise on every output passes the backward's gates
    ulp = lambda t: None if t is None else (
        t.float() * (1 + 2.0 ** -8)).to(t.dtype)
    noisy = (ulp(got[0]), ulp(got[1]), {k: ulp(v) for k, v in got[2].items()},
             ulp(got[3]))
    assert all(v <= eb.bwd_tol(k)
               for k, v in eb.bwd_errors(noisy, got, ctx).items())
    # the halo (senders in the slab but outside the receiver's own tile),
    # the far rows (senders outside the slab), one node's sender run, one
    # far rank, the first tile's halo; the last three move a few rows only
    for name, bad in eb.sender_faults(ours, ctx).items():
        errs = eb.bwd_errors(got, eb.ea_block_bwd_plain(*args, bad, **kw),
                             ctx)
        assert errs["dx_row"] > eb.bwd_tol("dx_row"), name
        if name in ("no-halo", "no-far-fold"):
            assert errs["dx"] > eb.bwd_tol("dx"), name
        if name == "no-far-fold":
            assert errs["dwsp"] > eb.bwd_tol("dwsp"), name


def test_wrappers_take_the_plain_version_on_cpu():
    h = 128
    ours, ctx, blk, _, x, e, _ = _inputs(h, False)
    w, bias = eb.block_weights(blk, torch.float32)
    eb.reset_launch_counts()
    got = eb.ea_block_fwd(x, e, w, bias, ctx, skip=True, save_res=True)
    want = eb.ea_block_fwd_plain(x, e, w, bias, ctx, skip=True,
                                 save_res=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert eb.LAUNCHES == {"ea_block_fwd": 0, "ea_block_bwd": 0}


def test_scope_guards():
    ours, _ = _batches()
    assert eb.supports_fused_ea(ours, 128)
    assert not eb.supports_fused_ea(ours, 96)
    assert eb.supports_fused_encoder(ours, 256, 5)
    assert not eb.supports_fused_encoder(ours, 128, 5)
    assert not eb.supports_fused_ea(ours.replace(win_edges=None), 128)
    h = 128
    _, ctx, blk, _, x, e, _ = _inputs(h, False)
    with pytest.raises(NotImplementedError, match="item 9"):
        eb.fused_ea_block(x, e, blk, ctx, skip=False, far_grad="hybrid")
    with pytest.raises(ValueError, match="seed"):
        eb.fused_ea_block(x, e, blk, ctx, skip=False, rate=0.1,
                          deterministic=False)


def _full_context(n, t, w_cap, seed):
    """An EAContext on n nodes with every one of its t * w_cap slots valid
    (random senders, receivers sorted as a batch's are)."""
    rng = np.random.default_rng(seed)
    e = t * w_cap
    recv = np.sort(rng.integers(0, n, size=e))
    send = rng.integers(0, n, size=e)
    nodes = np.arange(n)
    sorder = np.argsort(send, kind="stable")
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return eb.EAContext(
        n_nodes=n, n_tiles=t, w_cap=w_cap, send=i32(send), recv=i32(recv),
        rlo=i32(np.searchsorted(recv, nodes)),
        rhi=i32(np.searchsorted(recv, nodes, side="right")),
        sorder=i32(sorder),
        soff=i32(np.searchsorted(send[sorder], np.arange(n + 1))),
        cnt=torch.from_numpy(np.bincount(recv, minlength=n).astype(
            np.float32)))


@pytest.mark.parametrize("enc", [False, True])
def test_pass_flops_match_the_flop_counter(enc):
    """`pass_flops` (the kernels' per-pass operation counts behind
    chip_smoke.py's bounds and per-pass rates) against
    torch.utils.flop_counter.FlopCounterMode over the plain forward and
    backward, on a context whose slots are all valid: each count is two
    per multiply-add of the same products, the backward's recomputed
    forward products and, in encoder mode, the encoder's K = 8 first layer
    included (the kernels run it as f32 FMAs; both sides count it)."""
    from torch.utils.flop_counter import FlopCounterMode

    n, t, w_cap = 64, 4, 48
    h = 256 if enc else 128
    ctx = _full_context(n, t, w_cap, seed=3)
    rng = np.random.default_rng(4)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    dims = dict(wer=(h, h), wee=(h, h), wsp=(h, 2 * h), we1=(h, h),
                wpe=(h, h), wp1=(h, h), wg0=(2 * h, h), wg1=(h, h),
                wb0=(h, h), wb1=(h, h))
    if enc:
        dims.update(wen0=(eb.ENC_IN, eb.ENC_HID),
                    wen1=(eb.ENC_HID, eb.ENC_HID), wen2=(eb.ENC_HID, h))
    w = {k: f32(*d) / np.sqrt(d[0]) for k, d in dims.items()}
    bias = f32(11 if enc else 8, h)
    x = f32(n, h)
    e_win = f32(t, w_cap, eb.ENC_IN if enc else h)
    kw = dict(skip=not enc, enc=enc)
    with FlopCounterMode(display=False) as fc:
        _, ze, e1s, m1s = eb.ea_block_fwd_plain(x, e_win, w, bias, ctx,
                                                save_res=True, **kw)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        eb.ea_block_bwd_plain(f32(n, h), f32(*ze.shape), e1s, m1s, x, e_win,
                              w, bias, ctx, **kw)
    bwd = fc.get_total_flops()
    counts = eb.pass_flops(n, t * w_cap, h, enc=enc)
    want_fwd = sum(counts[k] for k in eb.FWD_PASSES)
    want_bwd = sum(counts[k] for k in eb.BWD_PASSES)
    assert (fwd, bwd) == (want_fwd, want_bwd), (
        f"pass_flops {counts} against the counter's forward {fwd} and "
        f"backward {bwd}")
