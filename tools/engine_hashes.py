"""Hashes of the bf16 product-engine kernels' outputs, for the tree ROOT.

    python3 tools/engine_hashes.py [ROOT]

Runs, from the ``buckgnn_tpu_torch`` and ``chip_smoke.py`` of ROOT (the
repository by default), #1 and #2 on the flagship batch (local star
windows, the next layer's star, skip, dropout 0.1) and #5 and #6 on the
ea-virtual batch and on a small ragged EA batch (plain mode with the skip,
encoder mode; dropout 0.1), all in bf16 at H 512 with seeded weights, and
prints one JSON line of sha256 prefixes of their outputs. Two trees that
print the same line computed the same bits. Needs a card.
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
from buckgnn_tpu_torch.ops import ea_block as eb  # noqa: E402
from buckgnn_tpu_torch.ops import sage_layer as sl  # noqa: E402
from buckgnn_tpu_torch.utils import cuda_build  # noqa: E402

assert buckgnn_tpu_torch.__file__.startswith(ROOT), buckgnn_tpu_torch.__file__


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def main():
    cuda_build.build_all(["sage_layer_fwd", "sage_layer_bwd", "ea_block_fwd",
                          "ea_block_bwd"])
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
    print(json.dumps({"root": ROOT, "hashes": out}))


if __name__ == "__main__":
    main()
