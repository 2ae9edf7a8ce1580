"""Host graph pipeline of the port (NumPy copies; no JAX)."""

from buckgnn_tpu_torch.graph.batch import (  # noqa: F401
    GraphBatch,
    GraphData,
    pack_graphs,
    capacity_for,
    batch_iterator,
)
