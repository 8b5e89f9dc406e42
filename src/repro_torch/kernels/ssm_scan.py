"""Diagonal linear-recurrence scan — the inter-chunk state update of the
Mamba2 block (:func:`repro_torch.models.ssm.apply_mamba`) and of RWKV6 time
mixing (:func:`repro_torch.models.rwkv.apply_rwkv_time`).

``ssm_scan(a, x)`` takes a and x of one shape (batch, seq, d) and returns
h of that shape in x's dtype with ``h[:, t] = a[:, t] * h[:, t-1] + x[:, t]``
and ``h[:, -1] = 0``, the carry in float32.

:func:`ssm_scan_cuda` launches the hand-written kernel of
``csrc/ssm_scan.cu`` (a and x float32 or bfloat16); :func:`ssm_scan_plain`
is plain PyTorch, for the CPU and as the kernel's yardstick on the card,
and differentiable by autograd.  :class:`SsmScan` is the differentiable
kernel: its forward launches ``ssm_scan_cuda`` and saves a and h, its
backward launches the adjoint kernel (:func:`ssm_scan_bwd_cuda`), the
counterpart of the JAX package's custom VJP
(``src/repro/kernels/ops.py:85-116``).
:func:`repro_torch.kernels.ops.ssm_scan` picks one by device.
"""
from __future__ import annotations

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


def ssm_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ssm_scan.cu`` on CUDA tensors; raises on an
    unsupported dtype and on any failure to build or launch."""
    global launches
    _check(a, x)
    if not (a.device.type == x.device.type == "cuda"):
        raise ValueError("ssm_scan_cuda takes CUDA tensors, got "
                         f"{a.device}, {x.device}")
    if a.dtype not in _DTYPES or x.dtype not in _DTYPES:
        raise ValueError("ssm_scan_cuda takes float32 or bfloat16 a and x, "
                         f"got {a.dtype}, {x.dtype}")
    a, x = a.contiguous(), x.contiguous()
    b, t, d = x.shape
    h = torch.empty_like(x)
    if h.numel() == 0:
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
    global bwd_launches
    _check(a, h)
    if h.shape != dh.shape or h.dtype != dh.dtype:
        raise ValueError(f"ssm_scan backward: dh {tuple(dh.shape)} "
                         f"{dh.dtype} does not match h {tuple(h.shape)} "
                         f"{h.dtype}")
    if not (a.device.type == h.device.type == dh.device.type == "cuda"):
        raise ValueError("ssm_scan_bwd_cuda takes CUDA tensors, got "
                         f"{a.device}, {h.device}, {dh.device}")
    if a.dtype not in _DTYPES or h.dtype not in _DTYPES:
        raise ValueError("ssm_scan_bwd_cuda takes float32 or bfloat16 a and "
                         f"h, got {a.dtype}, {h.dtype}")
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    b, t, d = h.shape
    da, dx = torch.empty_like(a), torch.empty_like(h)
    if h.numel() == 0:
        return da, dx
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = lib.repro_ssm_scan_bwd(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                 da.data_ptr(), dx.data_ptr(), b, t, d,
                                 _DTYPES[a.dtype], _DTYPES[h.dtype], stream)
    _build.check(err, "ssm_scan backward")
    bwd_launches += 1
    return da, dx


class SsmScan(torch.autograd.Function):
    """ssm_scan on the card with its backward kernel: the forward launches
    :func:`ssm_scan_cuda` and saves a and h; the backward launches
    :func:`ssm_scan_bwd_cuda`."""

    @staticmethod
    def forward(ctx, a, x):
        h = ssm_scan_cuda(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return ssm_scan_bwd_cuda(a, h, dh)
