"""The port's tile-sharded EA stack (buckgnn_tpu_torch.parallel.ea_shard)
and the fused block's far-gradient modes == the JAX package's.

- `shard_ea_batch`, `shard_caps` and `pad_ea_shards` equal the JAX
  package's bit for bit at D = 1, 2 and 4;
- the plain `fused_ea_block` (the kernels' plain versions) in 'hybrid' and
  'autodiff' mode on each shard of D = 2, against the JAX package's
  `fused_ea_block` (Pallas in interpret mode, rate 0) with the same
  ``far_grad``, ``far_local`` and ``x_full``: zx, ze, and the gradients in
  the shard's x, in x_full (the remote rows' scatter), in e and in every
  weight, at tests/test_ea_shard.py's tolerance (2e-4 of the largest
  entry);
- the shards of D = 2 and 4 add up to the unsharded 'fold' block: zx and ze
  concatenated, the weight gradients summed, and each shard's dx plus its
  remote rows summed into x's gradient;
- `ea_tp_stack` in a gloo world of 2 processes against the JAX package's
  `ea_tp_stack` on two virtual devices and against the unsharded stack:
  the output and the gradients of every block and encoder parameter.

Every case runs H 128, 3 layers for the stack, float32, dropout 0, on 16
virtual-edge panels of 8-11 nodes a side (tile 128, width 64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_port_worlds as worlds
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.ops.pallas_ea_block import fused_ea_block as j_block
from buckgnn_tpu.parallel import ea_shard as jes
from buckgnn_tpu_torch.convert import params_from_flax
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.models.blocks import GraphNetBlock
from buckgnn_tpu_torch.ops import ea_block as eb
from buckgnn_tpu_torch.parallel import ea_shard as tes
from buckgnn_tpu_torch.parallel.scaling import run_world
from torch_port_compare import same

H = worlds.EA_H
# tests/test_ea_shard.py's _assert_tree_close: f32 sums in another order
REL = 2e-4


def _batches():
    ds = generate_dataset(16, seed=2, min_side=8, max_side=11,
                          use_super_node=False, use_virtual_edges=True)
    _, ours = worlds.packed(16, 2, False, min_side=8, max_side=11)
    ref = jb.pack_graphs(ds, ours.n_node_cap, ours.n_edge_cap, 17,
                         band_width=worlds.WIDTH, band_tile=worlds.TILE)
    return ours, ref


def _host(s) -> dict:
    return {f.name: (v.numpy() if isinstance(v, torch.Tensor) else
                     np.asarray(v) if hasattr(v, "dtype") else v)
            for f in dataclasses.fields(s) for v in [getattr(s, f.name)]}


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / denom < REL, what


def _lin(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}


def _params(rng):
    mlp = lambda i: {"lin_0": _lin(rng, i, H), "lin_1": _lin(rng, H, H)}
    return {"edge_mlp": mlp(3 * H), "node_mlp_phi": mlp(2 * H),
            "node_mlp_gamma": mlp(2 * H), "node_mlp_beta": mlp(H)}


def _block(params):
    blk = GraphNetBlock(H)
    blk.load_state_dict(params_from_flax(params))
    return blk


@pytest.mark.parametrize("d", [1, 2, 4])
def test_shard_ea_batch_matches_jax_bit_for_bit(d):
    ours, ref = _batches()
    got, want = tes.shard_ea_batch(ours, d), jes.shard_ea_batch(ref, d)
    same(_host(want), _host(got), "shard_ea_batch")
    caps = tes.shard_caps(got)
    assert caps == jes.shard_caps(want)
    wide = tuple(c + 8 for c in caps)
    same(_host(jes.pad_ea_shards(want, *wide)),
         _host(tes.pad_ea_shards(got, *wide)), "pad_ea_shards")
    same(_host(jes.shard_ea_batch(ref, d, *wide)),
         _host(tes.pad_ea_shards(got, *wide)), "pad == capped build")


def _shard_inputs(ours, d_sh, rng):
    n, t = ours.n_node_cap, ours.win_sidx.shape[0]
    w = ours.win_sidx.shape[1]
    x = rng.normal(size=(n, H)).astype(np.float32)
    x[-1] = 0.0
    e = rng.normal(size=(t, w, H)).astype(np.float32)
    pzx = rng.normal(size=(n, H)).astype(np.float32)
    pze = rng.normal(size=(t, w, H)).astype(np.float32)
    return x, e, pzx, pze, n // d_sh, t // d_sh


@pytest.mark.parametrize("mode", ["hybrid", "autodiff"])
@pytest.mark.parametrize("shard", [0, 1])
def test_far_grad_modes_match_jax_per_shard(mode, shard):
    ours, ref = _batches()
    rng = np.random.default_rng(5)
    params = _params(rng)
    x, e, pzx, pze, nl, tl = _shard_inputs(ours, 2, rng)
    js, ts = jes.shard_ea_batch(ref, 2), tes.shard_ea_batch(ours, 2)
    fl = ts.cf_local if mode == "hybrid" else 0
    d = shard
    rows, tiles = slice(d * nl, (d + 1) * nl), slice(d * tl, (d + 1) * tl)
    jv = jes._ShardView(js, js.sidx[d], js.ridx[d], js.far[d],
                        js.row_off[d], js.fs_src[d], js.fs_lidx[d])

    def jf(xl, xf, el, p):
        zx, ze = j_block(xl, el, p, jv, skip=True, rate=0.0, seed=None,
                         deterministic=True, far_grad=mode, far_local=fl,
                         x_full=xf)
        return (jnp.sum(zx * pzx[rows]) + jnp.sum(ze * pze[tiles]),
                (zx, ze))

    (_, (jzx, jze)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x[rows]), jnp.asarray(x), jnp.asarray(e[tiles]), params)

    blk = _block(params)
    ctx = eb.make_ea_context(tes._ShardView(ts, d), mode, fl)
    assert ctx.ext_ids is not None and ctx.n_nodes > nl
    xl = torch.from_numpy(x[rows]).requires_grad_()
    xf = torch.from_numpy(x).requires_grad_()
    el = torch.from_numpy(e[tiles]).requires_grad_()
    zx, ze = eb.fused_ea_block(xl, el, blk, ctx, skip=True, far_grad=mode,
                               far_local=fl, x_full=xf)
    ((zx * torch.from_numpy(pzx[rows])).sum()
     + (ze * torch.from_numpy(pze[tiles])).sum()).backward()
    v = (ctx.recv >= 0).reshape(ze.shape[:2]).numpy()
    _close(zx.detach(), jzx, "zx")
    _close(ze.detach().numpy()[v], np.asarray(jze)[v], "ze")
    _close(xl.grad, jg[0], "dx")
    assert float(np.abs(np.asarray(jg[1])).max()) > 0, "remote rows"
    _close(xf.grad, jg[1], "x_full")
    _close(el.grad.numpy()[v], np.asarray(jg[2])[v], "de")
    want = params_from_flax(jax.tree.map(np.asarray, jg[3]))
    for k, p in blk.named_parameters():
        _close(p.grad, want[k], k)


@pytest.mark.parametrize("d_sh", [2, 4])
def test_shards_add_up_to_the_unsharded_block(d_sh):
    """No collective: each shard's block in 'hybrid' mode from the whole x,
    against the unsharded block ('fold')."""
    ours, _ = _batches()
    rng = np.random.default_rng(6)
    blk = _block(_params(rng))
    x, e, pzx, pze, nl, tl = _shard_inputs(ours, d_sh, rng)
    ts = tes.shard_ea_batch(ours, d_sh)

    def run(xl, xf, el, ctx, **kw):
        blk.zero_grad(set_to_none=True)
        return eb.fused_ea_block(xl, el, blk, ctx, skip=True, x_full=xf,
                                 **kw)

    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(e).requires_grad_()
    zx1, ze1 = run(xt, None, et, eb.make_ea_context(ours))
    ((zx1 * torch.from_numpy(pzx)).sum()
     + (ze1 * torch.from_numpy(pze)).sum()).backward()
    want_w = {k: p.grad.clone() for k, p in blk.named_parameters()}
    dw = {k: torch.zeros_like(v) for k, v in want_w.items()}
    dx = torch.zeros_like(xt)
    zxs, zes = [], []
    for d in range(d_sh):
        rows, tiles = slice(d * nl, (d + 1) * nl), slice(d * tl, (d + 1) * tl)
        xf = torch.from_numpy(x).requires_grad_()
        xl = torch.from_numpy(x[rows]).requires_grad_()
        ctx = eb.make_ea_context(tes._ShardView(ts, d), "hybrid",
                                 ts.cf_local)
        zx, ze = run(xl, xf, torch.from_numpy(e[tiles]), ctx,
                     far_grad="hybrid", far_local=ts.cf_local)
        ((zx * torch.from_numpy(pzx[rows])).sum()
         + (ze * torch.from_numpy(pze[tiles])).sum()).backward()
        zxs.append(zx.detach())
        zes.append(ze.detach())
        dx = dx + xf.grad
        dx[rows] += xl.grad
        for k, p in blk.named_parameters():
            dw[k] += p.grad
    v = (eb.make_ea_context(ours).recv >= 0).reshape(ze1.shape[:2]).numpy()
    _close(torch.cat(zxs), zx1.detach(), "zx")
    _close(torch.cat(zes).numpy()[v], ze1.detach().numpy()[v], "ze")
    _close(dx, xt.grad, "dx")
    for k in want_w:
        _close(dw[k], want_w[k], k)


def test_far_grad_modes_are_checked():
    """An unknown mode raises, and so does a mode other than the one the
    context was built for, or x_full in 'fold' mode."""
    ours, _ = _batches()
    blk = _block(_params(np.random.default_rng(7)))
    x = torch.zeros((ours.n_node_cap, H))
    e = torch.zeros((*ours.win_sidx.shape, H))
    with pytest.raises(ValueError, match="far_grad"):
        eb.make_ea_context(ours, "scatter")
    ctx = eb.make_ea_context(ours)
    for kw in (dict(far_grad="scatter"), dict(far_grad="autodiff"),
               dict(x_full=x)):
        with pytest.raises(ValueError, match="far_grad|x_full"):
            eb.fused_ea_block(x, e, blk, ctx, skip=False, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's ea_tp_stack on 2 virtual devices, then one gloo world of 2."""
    ours, ref = _batches()
    rng = np.random.default_rng(0)
    params = _params(rng)
    enc_params = {"lin_0": _lin(rng, 5, 64), "lin_1": _lin(rng, 64, H)}
    x0 = rng.normal(size=(ours.n_node_cap, H)).astype(np.float32)
    shards = jes.shard_ea_batch(ref, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    layers = worlds.EA_LAYERS

    def loss(p, ep):
        out = jes.ea_tp_stack(jnp.asarray(x0), shards, [p] * layers, ep,
                              rate=0.0, seed=None, deterministic=True)
        return jnp.sum(out ** 2), out

    with jax.set_mesh(mesh):
        (_, out), (g, ge) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, enc_params)
    want = {"tp": np.asarray(out)}
    want.update({f"tp.block.{k}": v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, g)).items()})
    want.update({f"tp.enc.{k}": v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, ge)).items()})
    ref_in = {"x": x0}
    ref_in.update({f"block.{k}": v.numpy()
                   for k, v in params_from_flax(params).items()})
    ref_in.update({f"enc.{k}": v.numpy()
                   for k, v in params_from_flax(enc_params).items()})
    path = tmp_path_factory.mktemp("ea_shard") / "ref.npz"
    np.savez(path, **ref_in)
    got = run_world(worlds.ea_shard_world, 2, args=(str(path),),
                    device="cpu", timeout=worlds.WORLD_TIMEOUT_S)[0]
    return got, want


@pytest.mark.parametrize("part", ["output", "block", "enc"])
def test_tp_stack_on_gloo_matches_jax(world, part):
    got, want = world
    keys = (["tp"] if part == "output"
            else sorted(k for k in want if k.startswith(f"tp.{part}.")))
    assert keys
    for k in keys:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("part", ["output", "block", "enc"])
def test_tp_stack_on_gloo_matches_the_unsharded_stack(world, part):
    got, _ = world
    keys = (["tp"] if part == "output"
            else sorted(k for k in got if k.startswith(f"tp.{part}.")))
    for k in keys:
        _close(got[k], got["one" + k[2:]], k)
