"""idle_share.train: the share of the traced window of a train cell in
which no operation ran on the card: 1 - (the union of the device's kernel,
copy and set intervals) / the window."""

MOVES = "train_panels_per_s"


def read(ctx):
    if ctx.passes != "train" or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us * 1e-6 / ctx.window_s)
