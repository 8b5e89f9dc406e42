"""Where the port's entry points run: the card unless the caller asks for
the CPU, and never a silent fall-back."""
from __future__ import annotations

import torch


def as_device(device="cuda", what: str = "device") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    CUDA is not available."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} device {d} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return d
