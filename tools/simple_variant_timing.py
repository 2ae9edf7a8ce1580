"""Time the float32 variants #1s-#6s and their float32 cells under one copy
of the port, on one CUDA card.

    python3 tools/simple_variant_timing.py ROOT

ROOT holds the ``buckgnn_tpu_torch`` package and the ``chip_smoke.py`` to
time (an unpacked ``git archive`` of a commit, or this checkout). Run it
once per copy, in turns on one card (parent, change, change, parent),
to compare two versions. It builds the kernels, then on the
cells' own weights prints one JSON line a measurement:
- ``kernel``: ms a call (CUDA events, 20 calls after 3; for #2s-#4s
  also the host's ms to enqueue a call, ``host_ms``) of #1s at
  flagship-f32 (emit and skip, as ``chip_smoke.py::variant_timings``
  calls it), of #2s there (the next layer's star, skip, dropout 0.1), of
  #3s (skip, dropout 0.1) and #4s (spill, acc: the split backward's call)
  at virtual-f32, and of #5s and #6s at ea-virtual-f32 (layer 1, skip; the
  backward at dropout 0.1), then the call's device ms by piece from
  ``torch.profiler`` over 5 calls, and every kernel's (``by_kernel``): for
  #1s the band (phase 1), the product tile, the weights' pre-split, the
  row pass, the code sums and the table reduction; for #2s and #3s the
  row pass, the weights' and dout's pre-splits, dagg | dxp, the weight
  pass (its products and partials' sums; a tree whose weight pass runs on
  gemm_kernel sums its partials in ``sum_parts_kernel<void>``, counted
  under colsum there), colsum, the own table and (#2s) the band pass,
  with the TFLOP/s of float32 products of dagg | dxp and of the weight
  pass; for #5s and #6s each pass (kernel names carry
  ``ea_simple::<pass>``) with its product tiles' ms and their TFLOP/s of
  float32 products (`pass_flops`; the tiles: ``gemm_kernel`` of
  simple.cuh, ``wtile_kernel`` of wtile.cuh);
- ``cell``: the serve and train step ms (``run_serve_bench``,
  ``run_train_bench``) of flagship-f32, virtual-f32 and ea-virtual-f32.
"""

import json
import os
import sys
import time

SAGE_PIECES = {"band": ("band_kernel",), "tile": ("gemm_kernel",
                                                  "wtile_kernel"),
               "wsplit": ("wsplit_kernel",), "rows": ("fwd_rows_kernel",),
               "code_sums": ("code_sums",),
               "table_reduce": ("table_reduce_kernel",)}
BWD_PIECES = {
    "rows": ("bwd_rows_kernel",),
    "wsplit": ("wsplit_kernel<float, void>",),
    "dout_split": ("asplit_kernel",),
    "dagg_dxp": ("DaggDxp", "gemm_kernel<float, false, true"),
    "weights": ("DwParts", "gemm_kernel<float, true, false"),
    "colsum": ("colsum_part_kernel", "sum_parts_kernel<void>"),
    "own_table": ("code_sums", "table_reduce_kernel"),
    "band": ("band_kernel",)}
TILES = ("gemm_kernel", "wtile_kernel")


def pieces(rows, pats):
    return sum(r[1] for r in rows if any(p in r[0] for p in pats))


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from buckgnn_tpu_torch.bench import (
        build_train_setup, run_serve_bench, run_train_bench,
    )
    from buckgnn_tpu_torch.ops import banded_matmul as bm
    from buckgnn_tpu_torch.ops import ea_block as eb
    from buckgnn_tpu_torch.ops import sage_layer as sl
    from buckgnn_tpu_torch.utils import cuda_build

    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    tag = {"root": sys.argv[1], "card": card}

    def profiled(fn, calls=5):
        """(kernel name, device ms a call, launches a call) rows"""
        rows = []
        cs.step_profile("", fn, 1.0, card, steps=calls, rows_out=rows)
        return rows

    def by_kernel(rows):
        """device ms a call by kernel name"""
        return {r[0][:90]: r[1] for r in rows if r[1] > 0.001}

    def host_ms(fn, calls=50):
        """host ms a call to enqueue ``fn`` (no synchronize inside)"""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / calls

    # #1s at flagship-f32
    train = build_train_setup(device=dev, config="flagship-f32")
    batch, model = train["batch"], train["state"].model
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        weights = model.shared_graphsage_block.fused_weights(x0.dtype)
    n, h = x0.shape
    args, kw, _ = cs.layer_inputs(batch, x0, weights, True, True, True)
    ms = cs.event_ms(lambda: sl.sage_layer_fwd(*args, **kw))
    rows = profiled(lambda: sl.sage_layer_fwd(*args, **kw))
    by = {k: pieces(rows, v) for k, v in SAGE_PIECES.items()}
    print(json.dumps({"kernel": "sage_layer_fwd_simple", **tag, "ms": ms,
                      "device_ms_by_piece": by,
                      "tile_tflop_per_s": 4 * n * h * h / by["tile"] / 1e9}))

    # #2s at flagship-f32, #3s and #4s at virtual-f32
    bargs, bkw, _ = cs.bwd_inputs(batch, x0, weights, True, True, True,
                                  cs.RATE, seed=5)
    bwd_cases = [("sage_layer_bwd_simple", n,
                  lambda: sl.sage_layer_bwd(*bargs, **bkw))]
    vtrain = build_train_setup(device=dev, config="virtual-f32")
    vbatch, vmodel = vtrain["batch"], vtrain["state"].model
    with torch.no_grad():
        xv = vmodel.node_encoder(vbatch.nodes)
        vweights = vmodel.shared_graphsage_block.fused_weights(xv.dtype)
    nv = xv.shape[0]
    targs, tkw = cs.tile_inputs(vbatch, xv, vweights, True, cs.RATE,
                                seed=41)
    bwd_cases.append(("sage_layer_bwd_tile_simple", nv,
                      lambda: sl.sage_layer_bwd_tile(*targs, **tkw)))
    for name, rows_n, fn in bwd_cases:
        ms = cs.event_ms(fn)
        rows = profiled(fn)
        by = {k: pieces(rows, v) for k, v in BWD_PIECES.items()}
        f = 4 * rows_n * h * h
        print(json.dumps({
            "kernel": name, **tag, "ms": ms, "host_ms": host_ms(fn),
            "device_ms_by_piece": by,
            "dagg_dxp_tflop_per_s": f / by["dagg_dxp"] / 1e9
            if by["dagg_dxp"] else None,
            "weights_tflop_per_s": f / by["weights"] / 1e9
            if by["weights"] else None, "by_kernel": by_kernel(rows)}))
    dagg, dxp = sl.sage_layer_bwd_tile(*targs, **tkw)[:2]
    b_kw = dict(tile=vbatch.band_tile, width=vbatch.band_width,
                out_dtype=xv.dtype, acc=dxp,
                spill_offsets=vbatch.spill_offsets,
                spill_lo=vbatch.spill_lo, spill_hi=vbatch.spill_hi,
                spill_messages=dagg[vbatch.spill_senders.long()])
    vband = cs.make_agg_context(vbatch).band
    ms = cs.event_ms(lambda: bm.banded_matmul(vband, dagg, **b_kw))
    rows = profiled(lambda: bm.banded_matmul(vband, dagg, **b_kw))
    print(json.dumps({"kernel": "banded_matmul_simple", **tag, "ms": ms,
                      "host_ms": host_ms(
                          lambda: bm.banded_matmul(vband, dagg, **b_kw)),
                      "by_kernel": by_kernel(rows)}))
    del bargs, bkw, targs, tkw, dagg, dxp, b_kw, vband, xv, vweights
    del vmodel
    del vbatch, args, kw, x0, weights, model, batch
    cells = {"flagship-f32": train, "virtual-f32": vtrain}

    # #5s and #6s at ea-virtual-f32
    etrain = build_train_setup(device=dev, config="ea-virtual-f32")
    batch, model = etrain["batch"], etrain["state"].model
    ctx = eb.make_ea_context(batch)
    with torch.no_grad():
        x0 = model.node_encoder(batch.nodes)
        w, bias = eb.block_weights(model.shared_gn_block, x0.dtype)
    g = torch.Generator(device=dev).manual_seed(97)
    e = torch.randn((*batch.win_sidx.shape, h), generator=g, device=dev)
    fargs = (x0, e, w, bias, ctx)
    ev = int((ctx.recv >= 0).sum())
    flops = eb.pass_flops(n=x0.shape[0], ev=ev, h=h)
    tkw = dict(skip=True, save_res=True, rate=cs.RATE, seed=cs.SEED)
    _, _, e1s, m1s = eb.ea_block_fwd(*fargs, **tkw)
    dzx = torch.randn(x0.shape, generator=g, device=dev)
    dze = torch.randn(e.shape, generator=g, device=dev)
    bargs = (dzx, dze, e1s, m1s) + fargs
    bkw = dict(skip=True, rate=cs.RATE, seed=cs.SEED)
    for name, fn, passes in (
            ("ea_block_fwd_simple", lambda: eb.ea_block_fwd(*fargs,
                                                            skip=True),
             eb.FWD_PASSES),
            ("ea_block_bwd_simple", lambda: eb.ea_block_bwd(*bargs, **bkw),
             eb.BWD_PASSES)):
        ms = cs.event_ms(fn)
        rows = profiled(fn)
        by = {}
        for p in passes:
            hits = [r for r in rows if f"ea_simple::{p}" in r[0]]
            line = {"ms": sum(r[1] for r in hits)}
            for t in TILES:
                tms = sum(r[1] for r in hits if t in r[0])
                if tms:
                    line[f"{t}_ms"] = tms
            tms = sum(line.get(f"{t}_ms", 0.0) for t in TILES)
            line["tile_tflop_per_s"] = flops[p] / tms / 1e9 if tms else None
            by[p] = line
        print(json.dumps({"kernel": name, **tag, "ms": ms,
                          "device_ms_by_pass": by,
                          "tflop_per_s": sum(flops[p] for p in passes)
                          / ms / 1e9}))
    del fargs, bargs, e, e1s, m1s, dzx, dze, x0, w, bias, model, batch, ctx
    cells["ea-virtual-f32"] = etrain

    for cell in ("flagship-f32", "virtual-f32", "ea-virtual-f32"):
        setup = cells.pop(cell, None) or build_train_setup(device=dev,
                                                           config=cell)
        serve = dict(setup, model=setup["state"].model)
        print(json.dumps({"cell": cell, **tag,
                          "infer_step_ms": [run_serve_bench(serve)[
                              "infer_step_ms"] for _ in range(3)],
                          "train_step_ms": [run_train_bench(setup)[
                              "train_step_ms"] for _ in range(3)]}))
        del setup, serve
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
