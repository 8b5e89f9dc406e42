"""Small shared helpers for the geometry round programs."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..._device import as_device


def combinations_array(n: int, k: int, device="cuda") -> torch.Tensor:
    """All C(n, k) sorted k-subsets of range(n) as a (C, k) int32 tensor on
    ``device`` (the card unless the caller asks for the CPU) — the PRAM
    processor index tables of the hull/LP reductions."""
    table = np.fromiter(
        itertools.chain.from_iterable(itertools.combinations(range(n), k)),
        np.int32).reshape(-1, k)
    return torch.from_numpy(table).to(as_device(device, "combinations"))


def require_true_float32(t: torch.Tensor, what: str) -> None:
    """Raise if float32 matmuls on ``t``'s device may run below float32
    (TF32 on the card keeps about three digits)."""
    if t.device.type == "cuda" \
            and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            f"{what} needs true float32 products, but float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r}: call "
            f"torch.set_float32_matmul_precision('highest')")
