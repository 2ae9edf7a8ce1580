"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``. Without a card and without that request they raise; they
never carry on on the CPU unasked.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
