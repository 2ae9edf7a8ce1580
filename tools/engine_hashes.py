"""Hashes of kernels' outputs, for the tree ROOT.

    python3 tools/engine_hashes.py [ROOT]

Runs, from the ``buckgnn_tpu_torch`` and ``chip_smoke.py`` of ROOT (the
repository by default), the bf16 product-engine kernels: #1 and #2 on the
flagship batch (local star windows, the next layer's star, skip, dropout
0.1) and #5 and #6 on the ea-virtual batch and on a small ragged EA batch
(plain mode with the skip, encoder mode; dropout 0.1), in bf16 at H 512;
and the float32 variants at H 512 on inputs that no other kernel made:
#1s on the flagship batch (local windows, emit, skip, training residuals
at dropout 0.1), #2s there (the next layer's star, skip, dropout 0.1),
#3s on the virtual batch (skip, dropout 0.1), #4s as the split backward
calls it there (spill, acc), and #5s and #6s on the ea-virtual batch
(plain mode with the skip, encoder mode; dropout 0.1), from seeded
residuals. Prints one JSON line of sha256 prefixes of their outputs,
with each output's largest error over max|plain| of #2s and #3s against
their plain versions (``*_err``). Two trees that print the same hash
computed the same bits. Needs a card.
"""

import hashlib
import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import buckgnn_tpu_torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from buckgnn_tpu_torch.bench import build_serve_setup  # noqa: E402
from buckgnn_tpu_torch.graph.batch import star_table_geometry  # noqa: E402
from buckgnn_tpu_torch.ops import banded_matmul as bm  # noqa: E402
from buckgnn_tpu_torch.ops import ea_block as eb  # noqa: E402
from buckgnn_tpu_torch.ops import sage_layer as sl  # noqa: E402
from buckgnn_tpu_torch.ops.banded import make_agg_context  # noqa: E402
from buckgnn_tpu_torch.utils import cuda_build  # noqa: E402

assert buckgnn_tpu_torch.__file__.startswith(ROOT), buckgnn_tpu_torch.__file__


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def residuals(batch, h, seed):
    """Seeded float32 stand-ins for a forward's residuals and the
    backward's cotangent: dz, y (relu'd unit rows), inv, agg, x and the
    weights, none made by a kernel."""
    dev = batch.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n = batch.n_node_cap

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    y = torch.relu(rand(n, h))
    y = y / y.norm(dim=1, keepdim=True).clamp_min(1e-6)
    inv = torch.rand((n,), generator=g, device=dev) + 0.5
    x = cs.seeded_x(batch, h, seed + 1, torch.float32)
    w_l, _, w_r = cs.check_weights(h, x, batch.node_mask, seed + 2,
                                   torch.float32)
    return rand(n, h), y, inv, rand(n, h), x, w_l, w_r


def max_err(got, ref, names):
    """Each output's largest |got - ref| over max|ref|."""
    return {k: float((g.float() - r.float()).abs().max()
                     / r.float().abs().max())
            for k, g, r in zip(names, got, ref) if r is not None}


def simple_hashes(dev, out, h=512):
    """#1s-#6s in float32 on seeded inputs."""
    fb = build_serve_setup(device=dev)["batch"]
    x = cs.seeded_x(fb, h, 11, torch.float32)
    w = cs.check_weights(h, x, fb.node_mask, 12, torch.float32)
    args, kw, _ = cs.layer_inputs(fb, x, w, True, True, True)
    out["sage_fwd_simple"] = digest(sl.sage_layer_fwd(*args, **dict(
        kw, save_res=True, rate=cs.RATE, seed=cs.SEED)))
    dz, y, inv, agg, x, w_l, w_r = residuals(fb, h, 21)
    code, gwin, gw, acc = sl.star_codes(fb)
    t0, tg = star_table_geometry(fb.n_graph_cap)
    g = torch.Generator(device=dev).manual_seed(22)
    bkw = dict(tile=fb.band_tile, width=fb.band_width, code=code, gwin=gwin,
               gw=gw, t0=t0, acc_code=acc, has_super=True, skip=True,
               rate=cs.RATE, seed=cs.SEED,
               table_prev=torch.randn((tg, h), generator=g, device=dev) * 8)
    band = make_agg_context(fb).band
    bargs = (dz, y, inv, agg, x, w_l, w_r, band)
    got = sl.sage_layer_bwd(*bargs, **bkw)
    out["sage_bwd_simple"] = digest(got)
    out["sage_bwd_simple_err"] = max_err(got, sl.sage_layer_bwd_plain(
        *bargs, **bkw), ("dx", "dw_l", "dw_r", "db_l", "town"))
    vb = build_serve_setup(device=dev, config="virtual")["batch"]
    dz, y, inv, agg, x, w_l, w_r = residuals(vb, h, 31)
    _, tg = star_table_geometry(vb.n_graph_cap)
    tkw = dict(tile=vb.band_tile, skip=True, rate=cs.RATE, seed=cs.SEED,
               tg=tg, acc_code=vb.gacc if vb.has_supernode_edges else None)
    targs = (dz, y, inv, agg, x, w_l, w_r)
    tile = sl.sage_layer_bwd_tile(*targs, **tkw)
    out["sage_bwd_tile_simple"] = digest(tile)
    out["sage_bwd_tile_simple_err"] = max_err(
        tile, sl.sage_layer_bwd_tile_plain(*targs, **tkw),
        ("dagg", "dxp", "dw_l", "dw_r", "db_l", "tbwd"))
    args, kw = cs.banded_inputs(vb, agg, 32, True, False, True)
    kw["out_dtype"] = torch.float32
    out["band_simple"] = digest([bm.banded_matmul(*args, **kw)])
    eb_batch = build_serve_setup(device=dev, config="ea-virtual")["batch"]
    ctx = eb.make_ea_context(eb_batch)
    for enc, skip in ((False, True), (True, False)):
        x, e, wd, bias = cs.ea_case(eb_batch, h, enc, 7, torch.float32)
        ekw = dict(skip=skip, rate=cs.RATE, seed=cs.SEED, enc=enc)
        f = eb.ea_block_fwd(x, e, wd, bias, ctx, save_res=True, **ekw)
        g = torch.Generator(device=dev).manual_seed(8)
        dzx = torch.randn(x.shape, generator=g, device=dev)
        dze = torch.randn(f[1].shape, generator=g, device=dev)
        dx, de, dw, dbias = eb.ea_block_bwd(dzx, dze, f[2], f[3], x, e, wd,
                                            bias, ctx, **ekw)
        out[f"ea_simple/enc{int(enc)}"] = {
            "fwd": digest(f),
            "bwd": digest([dx, de, dbias] + [dw[k] for k in sorted(dw)])}
    torch.cuda.synchronize()
    out["simple_launches"] = {k: v for k, v in sl.LAUNCHES.items()
                              if v and k.endswith("_simple")}
    out["ea_simple_launches"] = {k: v for k, v in eb.LAUNCHES.items()
                                 if v and k.endswith("_simple")}


def main():
    cuda_build.build_all(["sage_layer_fwd", "sage_layer_bwd", "ea_block_fwd",
                          "ea_block_bwd", "sage_simple", "ea_simple"])
    dev = torch.device("cuda", 0)
    out = {}
    setup = build_serve_setup(device=dev)
    batch, model = setup["batch"], setup["model"]
    with torch.no_grad():
        x = model.node_encoder(batch.nodes)
    w = cs.check_weights(x.shape[1], x, batch.node_mask, seed=1)
    args, kw, _ = cs.layer_inputs(batch, x, w, True, True, True)
    fwd = sl.sage_layer_fwd(*args, **dict(kw, save_res=True, rate=cs.RATE,
                                          seed=cs.SEED))
    bargs, bkw, _ = cs.bwd_inputs(batch, x, w, True, True, True, cs.RATE,
                                  seed=5)
    bwd = sl.sage_layer_bwd(*bargs, **bkw)
    torch.cuda.synchronize()
    out["flagship"] = {"fwd": digest(fwd), "bwd": digest(bwd),
                       "launches": {k: v for k, v in sl.LAUNCHES.items()
                                    if v}}
    for label, b in (("ea-virtual", build_serve_setup(
            device=dev, config="ea-virtual")["batch"]),
                     ("ragged", cs.ea_ragged_batch(dev))):
        ctx = eb.make_ea_context(b)
        for enc, skip in ((False, True), (True, False)):
            x, e, wd, bias = cs.ea_case(b, 512, enc, 7)
            ekw = dict(skip=skip, rate=cs.RATE, seed=cs.SEED, enc=enc)
            f = eb.ea_block_fwd(x, e, wd, bias, ctx, save_res=True, **ekw)
            g = torch.Generator(device=dev).manual_seed(8)
            dzx = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
            dze = torch.randn(f[1].shape, generator=g,
                              device=dev).to(x.dtype)
            dx, de, dw, dbias = eb.ea_block_bwd(dzx, dze, f[2], f[3], x, e,
                                                wd, bias, ctx, **ekw)
            torch.cuda.synchronize()
            out[f"{label}/enc{int(enc)}"] = {
                "fwd": digest(f),
                "bwd": digest([dx, de, dbias] + [dw[k] for k in sorted(dw)])}
    out["ea_launches"] = {k: v for k, v in eb.LAUNCHES.items() if v}
    simple_hashes(dev, out)
    print(json.dumps({"root": ROOT, "hashes": out}))


if __name__ == "__main__":
    main()
