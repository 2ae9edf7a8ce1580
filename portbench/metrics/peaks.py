"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit; the run records the
card's own limit beside its numbers).

A float32 configuration's products are held to the dense TF32 rate: no
float32-accurate way of computing them on this card (3xTF32, bf16x3 or
another scheme) can pass it.
"""

FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(cfg: dict) -> float:
    return FLOPS[cfg["compute_dtype"]]
