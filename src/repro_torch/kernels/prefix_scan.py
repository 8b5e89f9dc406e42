"""Cumulative sum along the last axis of a (rows, n) matrix, inclusive or
exclusive — the port of the JAX package's blocked ``prefix_scan`` kernel,
reached through :func:`repro_torch.kernels.ops.prefix_scan`.

``prefix_scan(x, exclusive)`` returns a matrix of x's shape and dtype (int32
or float32): ``out[:, i]`` is the sum of ``x[:, :i+1]``, or of ``x[:, :i]``
when ``exclusive``.  int32 sums wrap modulo 2^32, as JAX's do; an empty
last axis returns x itself.

:func:`prefix_scan_cuda` launches the hand-written kernel of
``csrc/prefix_scan.cu``: one pass over tiles of 4096 elements that carries
the row sum across blocks by decoupled look-back.  Its int32 results are
exact; its float32 results (float64 carry) are summed in an order that
depends on timing, so they are not bitwise identical from run to run.
:func:`prefix_scan_plain` is plain PyTorch, for the CPU and as the kernel's
yardstick on the card.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (ops.reset_launches)
launches = 0

_DTYPES = {torch.int32: 0, torch.float32: 1}
#: elements of a row one block scans (kTile of csrc/prefix_scan.cu)
TILE = 4096


def _check(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError("prefix_scan expects (rows, n)")


def prefix_scan_plain(x: torch.Tensor, exclusive: bool = False
                      ) -> torch.Tensor:
    """Plain PyTorch: one ``torch.cumsum`` in x's dtype (int32 stays int32
    and wraps), less x when exclusive."""
    _check(x)
    if x.shape[1] == 0:
        return x
    c = torch.cumsum(x, -1, dtype=x.dtype)
    return c - x if exclusive else c


def prefix_scan_cuda(x: torch.Tensor, exclusive: bool = False
                     ) -> torch.Tensor:
    """Launch ``csrc/prefix_scan.cu`` on a CUDA tensor; raises on an
    unsupported dtype and on any failure to build or launch."""
    global launches
    _check(x)
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError("prefix_scan_cuda takes a CUDA int32 or float32 "
                         f"tensor, got {x.dtype} on {x.device}")
    rows, n = x.shape
    if n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if rows * -(-n // TILE) >= 1 << 31:
        raise ValueError(f"prefix_scan_cuda: {rows} rows of {n} make "
                         f"2^31 or more tiles of {TILE}")
    lib = _build.library()
    code = _DTYPES[x.dtype]
    scratch = torch.empty(lib.repro_prefix_scan_scratch_bytes(rows, n, code),
                          dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_prefix_scan(x.data_ptr(), out.data_ptr(), rows, n,
                                int(bool(exclusive)), code,
                                scratch.data_ptr(), stream)
    _build.check(err, "prefix_scan")
    launches += 1
    return out
