"""Host graph pipeline of the port (NumPy copies; no JAX)."""
