"""Diagonal linear-recurrence scan — the inter-chunk state update of the
Mamba2 block (:func:`repro_torch.models.ssm.apply_mamba`) and of RWKV6 time
mixing (:func:`repro_torch.models.rwkv.apply_rwkv_time`).

``ssm_scan(a, x)`` takes a and x of one shape (batch, seq, d) and returns
h of that shape in x's dtype with ``h[:, t] = a[:, t] * h[:, t-1] + x[:, t]``
and ``h[:, -1] = 0``, the carry in float32.

:func:`ssm_scan_cuda` launches the hand-written kernel of
``csrc/ssm_scan.cu`` (a and x float32 or bfloat16); :func:`ssm_scan_plain`
is plain PyTorch, for the CPU and as the kernel's yardstick on the card,
and differentiable by autograd; :func:`ssm_scan_meta` allocates what the
kernel's wrapper allocates on the meta device, for a dry run.  Each has a
backward beside it (``ssm_scan_bwd_*``), the counterpart of the JAX
package's custom VJP (``src/repro/kernels/ops.py:85-116``), and
:class:`SsmScan` joins the two of a device as one differentiable call,
which :func:`repro_torch.kernels.ops.ssm_scan` makes.  ``ssm_scan_work``
and ``ssm_scan_bwd_work`` give a call's flops and bytes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (ops.reset_launches)
launches = 0
#: launches of the backward kernel since the last reset
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != x.shape:
        raise ValueError("ssm_scan expects a and x of one (batch, seq, d) "
                         f"shape, got {tuple(a.shape)} and {tuple(x.shape)}")


def ssm_scan_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the associative composition of (a, x) pairs,
    (a1, x1) then (a2, x2) = (a1 a2, a2 x1 + x2), by doubling over t
    (log2(seq) steps), in float32."""
    _check(a, x)
    A, H = a.float(), x.float()
    off = 1
    while off < a.shape[1]:
        H = torch.cat([H[:, :off], H[:, off:] + A[:, off:] * H[:, :-off]], 1)
        A = torch.cat([A[:, :off], A[:, off:] * A[:, :-off]], 1)
        off *= 2
    return H.to(x.dtype)


def ssm_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """Plain PyTorch of :func:`ssm_scan_bwd_cuda`'s contract, the JAX
    package's custom VJP: g is :func:`ssm_scan_plain` run backwards over
    (a shifted one step, dh) in float32, then dx = g and da = g h_{t-1},
    cast to x's and a's dtypes."""
    _check(a, h)
    a_next = torch.cat([a[:, 1:].float(), torch.ones_like(a[:, :1],
                                                         dtype=torch.float32)],
                       1)
    g = ssm_scan_plain(a_next.flip(1), dh.float().flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1], dtype=torch.float32),
                        h[:, :-1].float()], 1)
    return (g * h_prev).to(a.dtype), g.to(h.dtype)


def ssm_scan_work(b: int, t: int, d: int, a_dtype, x_dtype
                  ) -> Tuple[int, int]:
    """(flops, bytes) of one forward call: a and x read once, h (x's dtype)
    written once; an FMA a step."""
    n = b * t * d
    return 2 * n, n * (a_dtype.itemsize + 2 * x_dtype.itemsize)


def ssm_scan_bwd_work(b: int, t: int, d: int, a_dtype, x_dtype
                      ) -> Tuple[int, int]:
    """(flops, bytes) of one backward call: dh, a and h read once, da and
    dx written once; an FMA and a product a step."""
    n = b * t * d
    return 3 * n, n * (2 * a_dtype.itemsize + 3 * x_dtype.itemsize)


def ssm_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ssm_scan.cu`` on CUDA tensors; raises on an
    unsupported dtype and on any failure to build or launch."""
    return _scan(a, x, "cuda")


def ssm_scan_meta(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The meta route: checks and allocates what :func:`ssm_scan_cuda`
    does on meta tensors (contiguous copies, h) and computes nothing."""
    return _scan(a, x, "meta")


def _scan(a, x, device_type: str) -> torch.Tensor:
    global launches
    _check(a, x)
    if not (a.device.type == x.device.type == device_type):
        raise ValueError(f"ssm_scan_{device_type} takes {device_type.upper()} "
                         f"tensors, got {a.device}, {x.device}")
    if a.dtype not in _DTYPES or x.dtype not in _DTYPES:
        raise ValueError(f"ssm_scan_{device_type} takes float32 or bfloat16 "
                         f"a and x, got {a.dtype}, {x.dtype}")
    a, x = a.contiguous(), x.contiguous()
    b, t, d = x.shape
    h = torch.empty_like(x)
    if h.numel() == 0 or device_type == "meta":
        return h
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_ssm_scan(a.data_ptr(), x.data_ptr(), h.data_ptr(), b, t,
                             d, _DTYPES[a.dtype], _DTYPES[x.dtype], stream)
    _build.check(err, "ssm_scan")
    launches += 1
    return h


def ssm_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """Launch the backward kernel of ``csrc/ssm_scan.cu``: for h =
    ssm_scan(a, x) and a cotangent dh (x's dtype), returns (da in a's
    dtype, dx in x's dtype) with g_t = dh_t + a_{t+1} g_{t+1} (a_T = 1),
    dx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = 0), g in float32.  Raises on
    an unsupported dtype and on any failure to build or launch."""
    return _scan_bwd(a, h, dh, "cuda")


def ssm_scan_bwd_meta(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The meta route of the backward: checks and allocates what
    :func:`ssm_scan_bwd_cuda` does (contiguous copies, da, dx)."""
    return _scan_bwd(a, h, dh, "meta")


def _scan_bwd(a, h, dh, device_type: str):
    global bwd_launches
    _check(a, h)
    if h.shape != dh.shape or h.dtype != dh.dtype:
        raise ValueError(f"ssm_scan backward: dh {tuple(dh.shape)} "
                         f"{dh.dtype} does not match h {tuple(h.shape)} "
                         f"{h.dtype}")
    if not (a.device.type == h.device.type == dh.device.type
            == device_type):
        raise ValueError(f"ssm_scan_bwd_{device_type} takes "
                         f"{device_type.upper()} tensors, got {a.device}, "
                         f"{h.device}, {dh.device}")
    if a.dtype not in _DTYPES or h.dtype not in _DTYPES:
        raise ValueError(f"ssm_scan_bwd_{device_type} takes float32 or "
                         f"bfloat16 a and h, got {a.dtype}, {h.dtype}")
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    b, t, d = h.shape
    da, dx = torch.empty_like(a), torch.empty_like(h)
    if h.numel() == 0 or device_type == "meta":
        return da, dx
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = lib.repro_ssm_scan_bwd(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                 da.data_ptr(), dx.data_ptr(), b, t, d,
                                 _DTYPES[a.dtype], _DTYPES[h.dtype], stream)
    _build.check(err, "ssm_scan backward")
    bwd_launches += 1
    return da, dx


def _route(device_type: str):
    """(forward, backward) of a device's route, looked up at the call."""
    if device_type == "cuda":
        return ssm_scan_cuda, ssm_scan_bwd_cuda
    if device_type == "cpu":
        return ssm_scan_plain, ssm_scan_bwd_plain
    return ssm_scan_meta, ssm_scan_bwd_meta


class SsmScan(torch.autograd.Function):
    """ssm_scan with its backward as one call, on the route of a's device
    (``"cuda"``, ``"cpu"`` or ``"meta"``, :func:`_route`): the
    forward saves a and h, the backward runs the reversed scan.  On the
    card the two are the kernels :func:`ssm_scan_cuda` and
    :func:`ssm_scan_bwd_cuda`.  Each reports its call to an active counter
    (:func:`repro_torch.kernels.ops.counted`) as ``"ssm_scan"`` or
    ``"ssm_scan.bwd"``."""

    @staticmethod
    def forward(ctx, a, x):
        from .ops import counted
        fwd, _ = _route(a.device.type)
        with counted("ssm_scan", lambda: ssm_scan_work(
                *x.shape, a.dtype, x.dtype)):
            h = fwd(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        from .ops import counted
        a, h = ctx.saved_tensors
        _, bwd = _route(a.device.type)
        with counted("ssm_scan.bwd", lambda: ssm_scan_bwd_work(
                *h.shape, a.dtype, h.dtype)):
            return bwd(a, h, dh)


def ssm_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The JAX module's public name: h_t = a_t h_{t-1} + x_t, differentiable
    through :class:`SsmScan`, by way of
    :func:`repro_torch.kernels.ops.ssm_scan` (imported at the call: ``ops``
    imports this module), so a launch is counted once.  The JAX function's
    ``block_t`` tiling keyword changes no result and is left out."""
    from . import ops
    return ops.ssm_scan(a, x)
