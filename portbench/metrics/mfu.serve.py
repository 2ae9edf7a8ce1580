"""mfu.serve: the model operations of the requests answered in the traced
window (one forward each, portbench/metrics/counts.py) over the window's
seconds, as a share of the card's dense peak for the configuration's
precision (portbench/metrics/peaks.py)."""

from portbench.metrics import counts, peaks

MOVES = "serve_panels_per_s"


def read(ctx):
    if ctx.passes != "serve":
        return None
    flops = counts.model_flops(ctx.ref, ctx.cfg, ctx.shapes, ctx.calls,
                               "serve")
    return 100.0 * flops / ctx.window_s / peaks.peak_flops(ctx.cfg)
