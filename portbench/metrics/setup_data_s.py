"""setup_data_s: seconds of the port's host data path in set-up, the
benchmark's own host-clock span around graph/build.py::build_graph of
every panel, graph/normalizer.py::normalize_dataset and the packing
(graph/batch.py::select_band_geometry and batch_iterator, with RCM from
utils/native.py) until the batch is on the card. The generator's own time
is outside it."""

MOVES = "setup_s"


def read(ctx):
    return ctx.setup_data_s
