"""Blocked (flash) attention forward — the prefill attention of every
attention model (:func:`repro_torch.models.layers.sdpa` with
``attn_impl="flash"``).

``flash_attention(q, k, v, causal)`` takes q (b, hq, s_q, d) and k, v
(b, hkv, s_k, d) with hq % hkv == 0 (GQA: query head h reads KV head
h // (hq / hkv)) and returns (b, hq, s_q, d) in q's dtype: softmax attention
with scale 1/sqrt(d), scores and softmax in float32, and, when ``causal``,
key j masked for query i where j > i (absolute indices from 0 on both axes).
Masked scores are the finite ``NEG_INF`` of the JAX kernel, not -inf.

:func:`flash_attention_cuda` launches the hand-written kernels of
``csrc/flash_attention.cu`` (float32 or bfloat16, compiled for head dims
32, 48, 64 and 128; any other d up to 128 is zero-padded to the next of
them, as the JAX wrapper pads d): bfloat16 at head dims 64 and 128 runs on
the tensor cores (wgmma), everything else on the CUDA cores, as
``repro_flash_attention_route`` says;
:func:`flash_attention_plain` is plain PyTorch, for the CPU and as the
kernel's yardstick on the card; :func:`flash_attention_meta` allocates
what the kernel's wrapper allocates on the meta device, for a dry run, and
:func:`flash_attention_work` gives a call's flops and bytes.
:func:`repro_torch.kernels.ops.flash_attention` picks one by device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

#: launches of the CUDA kernels since the last reset (ops.reset_launches)
launches = 0
#: the same launches by route: "wgmma" (tensor cores) or "cuda_core"
route_launches = {"wgmma": 0, "cuda_core": 0}

NEG_INF = -1e30
#: head dims the kernel is compiled for
HEAD_DIMS = (32, 48, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention expects q (b, hq, s, d) and k, v "
                         f"(b, hkv, s, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"GQA requires hq % hkv == 0, got {q.shape[1]} % "
                         f"{k.shape[1]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch: float32 einsum over the GQA groups, mask, softmax."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(d)
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def padded_head_dim(d: int) -> int:
    """The narrowest compiled head dim that holds ``d`` (8 and 16 -> 32,
    112 -> 128); raises above 128."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"flash_attention_cuda: head dim {d} above the widest "
                     f"compiled one, {HEAD_DIMS[-1]}")


def flash_attention_work(b: int, hq: int, hkv: int, s_q: int, s_k: int,
                         d: int, causal: bool, dtype) -> Tuple[int, int]:
    """(flops, bytes) of one call from shapes and dtype alone: 4 d flops
    (two products of two) for each unmasked (query, key) pair of each query
    head; q and k, v read once and the output written once."""
    if causal:                  # query i reads keys 0..i
        m = min(s_q, s_k)
        pairs = m * (m + 1) // 2 + (s_q - m) * s_k
    else:
        pairs = s_q * s_k
    return (4 * b * hq * d * pairs,
            dtype.itemsize * (2 * b * hq * s_q * d + 2 * b * hkv * s_k * d))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors; raises on an
    unsupported dtype or head dim and on any failure to build or launch.

    A head dim the kernels are not compiled for is zero-padded to
    :func:`padded_head_dim`, and the output cut back to d: zero columns add
    nothing to q k^T and give zero output columns.  The softmax keeps the
    true d's scale 1/sqrt(d).  The JAX wrapper multiplies the padded q by
    sqrt(d_pad / d) for that; the kernel takes the scale as an argument,
    so here q is not rescaled (and not rounded again in bfloat16)."""
    return _flash(q, k, v, causal, "cuda")


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """The meta route: checks and allocates what
    :func:`flash_attention_cuda` does on meta tensors (the padded and
    contiguous copies of q, k, v, the output, its cut) and computes
    nothing, for a dry run."""
    return _flash(q, k, v, causal, "meta")


def _flash(q, k, v, causal: bool, device_type: str) -> torch.Tensor:
    global launches
    _check(q, k, v)
    if not (q.device.type == k.device.type == v.device.type == device_type):
        raise ValueError(f"flash_attention_{device_type} takes "
                         f"{device_type.upper()} tensors, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_{device_type} takes float32 or "
                         f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    d_pad = padded_head_dim(d)
    if d_pad != d:
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad - d))
                   for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    # the kernels copy rows in 16-byte chunks
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if device_type == "cuda":
        lib = _build.library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, sk, d_pad, int(bool(causal)), _DTYPES[q.dtype],
            1.0 / math.sqrt(d), stream)
        _build.check(err, "flash_attention")
        launches += 1
        route = lib.repro_flash_attention_route(d_pad, _DTYPES[q.dtype])
        route_launches["wgmma" if route else "cuda_core"] += 1
    return out if d_pad == d else out[..., :d].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """The JAX module's public name, as the JAX ``ops.flash_attention``
    takes it: q (b, hq, s, d), k and v (b, hkv, s, d), the device dispatch
    of :func:`repro_torch.kernels.ops.flash_attention` (imported at the
    call: ``ops`` imports this module), so a launch is counted once.  The
    JAX kernel's own (b h, s, d) layout and its ``block_q`` / ``block_k``
    tiling keywords, which change no result, are left out."""
    from . import ops
    return ops.flash_attention(q, k, v, causal=causal)
