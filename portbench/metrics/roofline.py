"""A layer's share of its roofline from the trace: the least time of the
layer calls of one kind that the traced window ran (the configuration's
reference module lists each call's counts, portbench/metrics/counts.py;
peaks from portbench/metrics/peaks.py) over the device time of the
kernels whose names hold one of the layer's CUDA symbols. Nothing to read
(None) when the window ran no such kernel, or no call of that kind."""

from portbench.metrics import counts, peaks


def share(ctx, symbols, kind: str, passes: str):
    if ctx.passes != passes:
        return None
    device_s = sum(b - a for name, a, b in ctx.trace.kernels
                   if any(s in name for s in symbols)) * 1e-6
    if device_s <= 0.0:
        return None
    least = counts.least_seconds(ctx.ref, ctx.cfg, ctx.shapes, ctx.calls,
                                 passes, kind, peaks.peak_flops(ctx.cfg),
                                 peaks.HBM_BYTES_PER_S)
    if least <= 0.0:
        return None
    return 100.0 * least / device_s
