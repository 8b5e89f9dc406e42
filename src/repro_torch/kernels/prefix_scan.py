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
yardstick on the card; :func:`prefix_scan_meta` allocates the output on
the meta device, for a dry run; :func:`prefix_scan_work` gives a call's
flops and bytes.
"""
from __future__ import annotations

from typing import Tuple

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


def prefix_scan_work(rows: int, n: int, dtype) -> Tuple[int, int]:
    """(flops, bytes) of one call: x read once, the sums written once; an
    add an element."""
    return rows * n, 2 * rows * n * dtype.itemsize


def prefix_scan_cuda(x: torch.Tensor, exclusive: bool = False
                     ) -> torch.Tensor:
    """Launch ``csrc/prefix_scan.cu`` on a CUDA tensor; raises on an
    unsupported dtype and on any failure to build or launch."""
    return _scan(x, exclusive, "cuda")


def prefix_scan_meta(x: torch.Tensor, exclusive: bool = False
                     ) -> torch.Tensor:
    """The meta route: checks x and allocates the output as
    :func:`prefix_scan_cuda` does on a meta tensor; the look-back's
    scratch, which the built library sizes, is left out."""
    return _scan(x, exclusive, "meta")


def _scan(x, exclusive: bool, device_type: str) -> torch.Tensor:
    global launches
    _check(x)
    if x.device.type != device_type or x.dtype not in _DTYPES:
        raise ValueError(f"prefix_scan_{device_type} takes a "
                         f"{device_type.upper()} int32 or float32 tensor, "
                         f"got {x.dtype} on {x.device}")
    rows, n = x.shape
    if n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if rows * -(-n // TILE) >= 1 << 31:
        raise ValueError(f"prefix_scan_{device_type}: {rows} rows of {n} "
                         f"make 2^31 or more tiles of {TILE}")
    if device_type == "meta":
        return out
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


def prefix_scan(x: torch.Tensor, *, exclusive: bool = False) -> torch.Tensor:
    """The JAX module's public name: the device dispatch of
    :func:`repro_torch.kernels.ops.prefix_scan` (imported at the call:
    ``ops`` imports this module), so a launch is counted once.  The JAX
    function's ``block_n`` tiling keyword changes no result and is left
    out."""
    from . import ops
    return ops.prefix_scan(x, exclusive=exclusive)
