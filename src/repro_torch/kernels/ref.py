"""Plain oracles of the ported kernels (the correctness ground truth).

Each mirrors its kernel's public contract exactly and is written as simply as
the function allows, independently of the kernel module's own plain version.
"""
from __future__ import annotations

import math

import torch


def bincount_tiles_ref(tiles: torch.Tensor, n_buckets: int):
    """Per-tile histogram + the two exclusive scans, one tile at a time."""
    T = tiles.shape[0]
    rows = [torch.bincount(row[(row >= 0) & (row < n_buckets)].long(),
                           minlength=n_buckets)[:n_buckets] for row in tiles]
    C = (torch.stack(rows) if T else
         torch.zeros((0, n_buckets), dtype=torch.int64)).to(torch.int32)
    P = torch.cumsum(C, 0, dtype=torch.int32) - C     # cross-tile exclusive
    F = torch.cumsum(C, 1, dtype=torch.int32) - C     # in-tile bucket offsets
    return C, P, F


def bitonic_sort_ref(keys: torch.Tensor, values: torch.Tensor):
    """Rows sorted ascending by key (stable), values moved along."""
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    return sorted_keys, values.gather(-1, order)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """(bh, s, d) softmax attention in float32, heads already matched."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = s.masked_fill(~mask.to(s.device), -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
