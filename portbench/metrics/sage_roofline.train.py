"""sage_roofline.train: the fused SAGE layer's share of its roofline in a
train cell (ops/sage_layer.py -> csrc/sage_simple.cu on csrc/wtile.cuh:
the forward #1s and the backward #2s, or #3s with #4s's band pass): the
least time of its forward and backward calls over the device time of its
kernels (portbench/metrics/roofline.py)."""

from portbench.metrics import roofline

MOVES = "train_panels_per_s"
# the CUDA symbols of the float32 SAGE kernels: csrc/sage_simple.cu's own,
# its weight tile's (csrc/wtile.cuh) and the star tables' reduction
# (csrc/sage_common.cuh), and csrc/simple.cuh's tile and partial sums
SYMBOLS = ("band_kernel", "fwd_rows_kernel", "bwd_rows_kernel",
           "code_sums_kernel", "code_sums_once_kernel", "colsum_part_kernel",
           "wsplit_kernel", "asplit_kernel", "wtile_kernel",
           "table_reduce_kernel", "gemm_kernel", "sum_parts_kernel")


def read(ctx):
    return roofline.share(ctx, SYMBOLS, "sage", "train")
