"""ea_roofline.train: the fused EA block's share of its roofline in a
train cell (ops/ea_block.py -> csrc/ea_simple.cu: the forward #5s, with
the edge encoder in its first call, and the backward #6s): the least time
of its forward and backward calls over the device time of its kernels
(portbench/metrics/roofline.py)."""

from portbench.metrics import roofline

MOVES = "train_panels_per_s"
# the CUDA symbols of the float32 EA kernels: csrc/ea_simple.cu's own and
# the product tiles it runs on (csrc/wtile.cuh, csrc/simple.cuh)
SYMBOLS = ("run_sums_kernel", "ew_kernel", "enc_first_kernel",
           "wen0_part_kernel", "bias_reduce_kernel", "wsplit_kernel",
           "asplit_kernel", "wtile_kernel", "gemm_kernel",
           "sum_parts_kernel")


def read(ctx):
    return roofline.share(ctx, SYMBOLS, "ea", "train")
