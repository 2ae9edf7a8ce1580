"""buckgnn_tpu_torch — the PyTorch/CUDA port of buckgnn_tpu for NVIDIA Hopper.

The JAX package ``buckgnn_tpu`` is the reference; this package imports
``torch`` and ``numpy`` only. Its hot path, the fused SAGE layer forward,
is a hand-written CUDA kernel (``csrc/sage_layer_fwd.cu``) built with nvcc
at first use; on CPU tensors the same layer runs as plain PyTorch.
"""
