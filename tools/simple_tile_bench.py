"""Time the float32 / any-width variants' two product tiles alone on the card.

    python3 tools/simple_tile_bench.py

Builds ``tools/simple_tile_bench.cu`` (the tile of
``buckgnn_tpu_torch/csrc/simple.cuh`` with its plain store epilogue) with
nvcc into a scratch directory, loads the weight tile of ``wtile.cuh``
through ``sage_simple.cu``'s entries (``wtile_split``, ``wtile_split_t``,
``wtile_split_act``, ``wtile_gemm``, ``wtile_gemm_at``), and runs C =
op(A) @ op(B) at the products' shapes on the float32 main paths: a node
product at the ea-virtual batch's 51,712 rows, an edge product at its
239,168 slots (depth 512, both layouts of B), the flagship's forward pair
as one depth-1,024 product (512 + 512) at 103,424 rows, its backward's
dagg | dxp = dout @ [W_l^T | W_r^T] (N 1,024, depth 512) at 103,424 rows,
and the weight pass's A^T @ B: x^T @ dz over 16 chunks of 2,048 rows and
#2s's [agg | x]^T @ dout (1,024 x 512 over 103,424 rows, 51 chunks). One
JSON line a case, dtype and tile ("gemm": simple.cuh's gemm_kernel;
"wtile": the weight tile, for B a weight as stored or transposed and for
the weight pass, with its pre-split's own ms beside it): ms (CUDA events,
10 calls after a warm-up), the float32-product TFLOP/s, the largest error
as a share of max|C| against a float64 product of the same operands, and
the float32 cuBLAS product's ms (TF32 off) as a yardstick. Needs a card
and nvcc.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = [  # (name, M, N, K, A^T, B [N, K])
    ("node x@W", 51712, 512, 512, False, False),
    ("node x@W^T", 51712, 512, 512, False, True),
    ("edge e@W", 239168, 512, 512, False, False),
    ("edge e@W^T", 239168, 512, 512, False, True),
    ("flagship [agg|x]@[W_l;W_r]", 103424, 512, 1024, False, False),
    ("flagship dout@[W_l^T|W_r^T]", 103424, 1024, 512, False, True),
    ("weights x^T@dz", 512, 512, 2048 * 16, True, False),
    ("flagship [agg|x]^T@dout", 1024, 512, 103424, True, False),
]
KCHUNK = 2048  # rows of a weight pass's chunk


def build(out_dir):
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    lib = os.path.join(out_dir, "libsimple_tile_bench.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, os.path.join(HERE, "simple_tile_bench.cu")],
                   check=True)
    fn = ctypes.CDLL(lib).tile_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return fn


def weight_tile():
    """sage_simple.cu's weight-tile entries, from the package."""
    sys.path.insert(0, os.path.dirname(HERE))
    from buckgnn_tpu_torch.utils import cuda_build

    lib = cuda_build.load("sage_simple")
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"wtile_split": [p] * 2 + [i] * 4 + [p, i, p],
            "wtile_split_t": [p] * 2 + [i] * 3 + [p, i, p],
            "wtile_split_act": [p] + [i] * 2 + [p, i, p],
            "wtile_gemm": [p] * 2 + [i] * 5 + [p] * 2 + [i, p],
            "wtile_gemm_at": [p] * 2 + [i] * 4 + [p] * 4 + [i, p]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def checked(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    wt = weight_tile()
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(tmp)
        for dtype in (torch.float32, torch.bfloat16):
            for name, m, n, k, ta, tb in CASES:
                g = torch.Generator(device=dev).manual_seed(0)
                a = torch.randn((k, m) if ta else (m, k), generator=g,
                                device=dev).to(dtype)
                b = torch.randn((n, k) if tb else (k, n), generator=g,
                                device=dev).to(dtype)
                nz = -(-k // KCHUNK) if ta else 1
                c = torch.empty((nz, m, n), device=dev)
                stream = torch.cuda.current_stream().cuda_stream
                bf16 = int(dtype == torch.bfloat16)
                a64 = a.double().t() if ta else a.double()
                b64 = b.double().t() if tb else b.double()
                ref = a64 @ b64
                af, bf = a.float(), b.float()
                lib = event_ms(lambda: (af.t() if ta else af)
                               @ (bf.t() if tb else bf))
                tiles = {"gemm": lambda: checked(fn(
                    a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                    a.shape[1], b.shape[1], int(ta), int(tb), bf16, stream),
                    "gemm_kernel")}
                ws = torch.empty(((2 - bf16) * -(-k // 32) * 32 * n,),
                                 device=dev)
                if ta:
                    # the weight pass: A's halves as [agg | x], B = b
                    m0 = m // 2 if m > 512 else m
                    halves = [a[:, :m0].contiguous()] + (
                        [a[:, m0:].contiguous()] if m > m0 else [])
                    part = torch.empty((2, nz, m0, n), device=dev)
                    outs = [c[0, :m0], c[0, m0:]]

                    def split():
                        checked(wt.wtile_split_act(
                            b.data_ptr(), k, n, ws.data_ptr(), bf16, stream),
                            "wsplit_kernel")

                    def wcall():
                        checked(wt.wtile_gemm_at(
                            halves[0].data_ptr(),
                            halves[1].data_ptr() if len(halves) > 1 else 0,
                            m0, n, k, KCHUNK, ws.data_ptr(),
                            part.data_ptr(), outs[0].data_ptr(),
                            outs[1].data_ptr(), bf16, stream),
                            "wtile_kernel")
                elif tb:
                    def split():
                        checked(wt.wtile_split_t(
                            b.data_ptr(), 0, n, 0, k, ws.data_ptr(), bf16,
                            stream), "wsplit_kernel")
                else:
                    def split():
                        checked(wt.wtile_split(
                            b.data_ptr(), 0, n, k, 0, n, ws.data_ptr(), bf16,
                            stream), "wsplit_kernel")
                if not ta:
                    def wcall():
                        checked(wt.wtile_gemm(
                            a.data_ptr(), 0, k, k, 0, m, n, ws.data_ptr(),
                            c.data_ptr(), bf16, stream), "wtile_kernel")
                split()
                extra = {"wsplit_ms": event_ms(split)}
                tiles["wtile"] = wcall
                for tile, call in tiles.items():
                    ms = event_ms(call)
                    # the weight tile sums its chunks itself
                    got = c[0].double() if (ta and tile == "wtile") \
                        else c.double().sum(0)
                    print(json.dumps({
                        "case": name, "dtype": str(dtype).split(".")[1],
                        "tile": tile, "m": m, "n": n, "k": k, "card": card,
                        "ms": ms, "tflop_per_s": 2 * m * n * k / ms / 1e9,
                        "err_over_max": float((got - ref).abs().max()
                                              / ref.abs().max()),
                        "cublas_f32_ms": lib,
                        **(extra if tile == "wtile" else {})}))
                    del got
                del a, b, c, ref, a64, b64, af, bf, ws


if __name__ == "__main__":
    main()
