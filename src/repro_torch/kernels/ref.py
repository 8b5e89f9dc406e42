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


def ssm_scan_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t, one step at a time in float32."""
    b, t, d = a.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    out = []
    for i in range(t):
        h = a[:, i].float() * h + x[:, i].float()
        out.append(h)
    hs = torch.stack(out, 1) if t else torch.zeros((b, 0, d))
    return hs.to(x.dtype)


def prefix_scan_ref(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Running sums of each row, element by element, in x's dtype (int32
    through int64 and back, which wraps as int32 arithmetic does)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float64 if x.is_floating_point()
                      else torch.int64)
    out = torch.empty(x.shape, dtype=acc.dtype)
    for i in range(x.shape[1]):
        if exclusive:
            out[:, i] = acc
        acc = acc + x[:, i].to(acc.dtype)
        if not exclusive:
            out[:, i] = acc
    if x.is_floating_point():
        return out.to(x.dtype)
    return (((out + 2 ** 31) % 2 ** 32) - 2 ** 31).to(x.dtype)


def bincount_ref(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Count of each id in [0, n_buckets), one bucket at a time."""
    return torch.tensor([int((ids == v).sum()) for v in range(n_buckets)],
                        dtype=torch.int32)
