"""mfu.train: the model operations of the train steps run in the traced
window (portbench/metrics/counts.py: a forward and its backward, twice
the forward) over the window's seconds, as a share of the card's dense
peak for the configuration's precision (portbench/metrics/peaks.py)."""

from portbench.metrics import counts, peaks

MOVES = "train_panels_per_s"


def read(ctx):
    if ctx.passes != "train":
        return None
    flops = counts.model_flops(ctx.ref, ctx.cfg, ctx.shapes, ctx.calls,
                               "train")
    return 100.0 * flops / ctx.window_s / peaks.peak_flops(ctx.cfg)
