"""sage_roofline.serve: the fused SAGE layer's share of its roofline in the
serve cell (ops/sage_layer.py -> csrc/sage_simple.cu on csrc/wtile.cuh:
the forward #1s, its band kernel #4s included): the least time of its
forward calls over the device time of its kernels
(portbench/metrics/roofline.py)."""

from portbench.metrics import roofline

MOVES = "serve_panels_per_s"
# the CUDA symbols of the float32 SAGE kernels: csrc/sage_simple.cu's own,
# its weight tile's (csrc/wtile.cuh) and the star tables' reduction
# (csrc/sage_common.cuh), and csrc/simple.cuh's tile and partial sums
SYMBOLS = ("band_kernel", "fwd_rows_kernel", "bwd_rows_kernel",
           "code_sums_kernel", "code_sums_once_kernel", "colsum_part_kernel",
           "wsplit_kernel", "asplit_kernel", "wtile_kernel",
           "table_reduce_kernel", "gemm_kernel", "sum_parts_kernel")


def read(ctx):
    return roofline.share(ctx, SYMBOLS, "sage", "serve")
