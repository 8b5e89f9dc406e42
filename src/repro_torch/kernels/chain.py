"""Andrew's monotone chain over a batch of runs — the reducer of the 2-D
convex hull (:mod:`repro_torch.core.geometry.chain`), reached through
:func:`repro_torch.kernels.ops.monotone_chain`.

``monotone_chain(pts, counts)`` takes a (V, L, 2) float32 batch of runs,
each lex-sorted by (x, y) and deduplicated, whose live points are a prefix
of ``counts[v]`` slots, and returns

- ``hull`` (V, L, 2) float32: each run's strict hull CCW from its lex-min,
  the lower chain without its last point followed by the upper chain
  without its last point, zero from slot ``h`` on;
- ``h`` (V,) int32: the hull's vertex count (a run of 0 or 1 points is its
  own hull).

Pops on cross <= 0, so collinear points are left out — the JAX package's
convention.  The cross product rounds as the JAX package's does under XLA
on the CPU, which computes it with one fused multiply-add and flushes
subnormal values to zero (:func:`_turn`).  The JAX package computes this
outside any Pallas kernel, as a ``lax.scan`` with a ``lax.while_loop`` of
pops (``src/repro/core/geometry/chain.py:31-61``); the port runs it on the
card as the hand-written kernel of ``csrc/monotone_chain.cu``
(:func:`monotone_chain_cuda`), and :func:`monotone_chain_plain` is plain
PyTorch, for the CPU and as the kernel's yardstick on the card.  The two
are equal bit for bit.  :func:`monotone_chain_meta` allocates what the
kernel's wrapper allocates on the meta device, for a dry run, and
:func:`monotone_chain_work` gives a call's flops and bytes.

On the card each chain's input arrives in stages of shared memory and its
stack keeps a window of entries there; :func:`kernel_shape` names the stage
size, ring depth and window a launch takes (the rule is in the source's
header).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (ops.reset_launches)
launches = 0


def _check(pts: torch.Tensor, counts: torch.Tensor) -> None:
    if pts.ndim != 3 or pts.shape[2] != 2:
        raise ValueError(f"monotone_chain expects (V, L, 2) points, got "
                         f"{tuple(pts.shape)}")
    if counts.shape != pts.shape[:1]:
        raise ValueError(f"monotone_chain expects ({pts.shape[0]},) counts, "
                         f"got {tuple(counts.shape)}")
    if pts.dtype != torch.float32:
        raise ValueError(f"monotone_chain takes float32 points, got "
                         f"{pts.dtype}")


#: the smallest normal float32; XLA flushes anything smaller to zero
_TINY = 2.0 ** -126


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values flushed to zero, as XLA's float32 arithmetic does."""
    return torch.where(t.abs() < _TINY, 0.0, t)


def _turn(ax, ay, bx, by, px, py) -> torch.Tensor:
    """(b - a) x (p - a) as the JAX package's chain computes it under XLA
    on the CPU, for coordinates already flushed (:func:`_ftz`): the four
    differences and the second product rounded to float32, the first
    product exact and fused into the subtraction (an fma: XLA contracts
    ``u * v - w * z`` into one), and every result below the smallest normal
    float32 flushed to zero.  In float64 the first product is exact and the
    subtraction rounds once; cast back to float32 and flushed, the result
    is zero or of the fma's sign wherever the chain reads it (``<= 0``)."""
    x, y = _ftz(bx - ax), _ftz(py - ay)
    q = _ftz(_ftz(by - ay) * _ftz(px - ax))
    return _ftz((x.double() * y.double() - q.double()).float())


def monotone_chain_plain(pts: torch.Tensor, counts: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: one slot loop over the runs' live prefixes, vectorized
    over 2V chains (each run's lower chain reads its points forward, its
    upper chain backward), each step popping while any chain still turns,
    as JAX's vmapped scan does.  The top two stack entries of each chain
    are kept beside the stack, as the kernel keeps the top of its stack in
    registers.  Reads the longest run on the host."""
    _check(pts, counts)
    V, L, _ = pts.shape
    dev = pts.device
    cnt = counts.long().clamp(0, L)
    if V == 0 or L == 0:
        return torch.zeros_like(pts), cnt.to(torch.int32)
    lane_cnt = torch.cat([cnt, cnt])
    upper = torch.arange(2 * V, device=dev) >= V
    # (2V, L) per lane; the tests read them flushed, as XLA flushes every
    # operand, and the hulls are the input points as they are: the stacks
    # hold the flushed coordinates and the slot each entry came from
    raw_x = torch.cat([pts[..., 0], pts[..., 0]])
    raw_y = torch.cat([pts[..., 1], pts[..., 1]])
    xs, ys = _ftz(raw_x), _ftz(raw_y)
    sx, sy = torch.zeros_like(xs), torch.zeros_like(ys)  # the stacks
    s_slot = torch.zeros_like(xs, dtype=torch.long)
    top = torch.zeros((2 * V,), dtype=torch.long, device=dev)
    # stack[top - 2] and stack[top - 1] of each chain, where they exist
    ax, ay, bx, by = (torch.zeros((2 * V,), dtype=pts.dtype, device=dev)
                      for _ in range(4))
    for i in range(int(cnt.max())):
        live = i < lane_cnt
        slot = torch.where(upper, lane_cnt - 1 - i, i).clamp(0, L - 1)
        px = xs.gather(1, slot[:, None])[:, 0]
        py = ys.gather(1, slot[:, None])[:, 0]
        t = top
        while True:
            turning = live & (t >= 2) & (_turn(ax, ay, bx, by, px, py) <= 0)
            if not bool(turning.any()):
                break
            t = t - turning.long()
            bx, by = torch.where(turning, ax, bx), torch.where(turning, ay, by)
            below = (t - 2).clamp_min(0)[:, None]
            ax = torch.where(turning, sx.gather(1, below)[:, 0], ax)
            ay = torch.where(turning, sy.gather(1, below)[:, 0], ay)
        at = t.clamp_max(L - 1)[:, None]
        sx.scatter_(1, at, torch.where(live[:, None], px[:, None],
                                       sx.gather(1, at)))
        sy.scatter_(1, at, torch.where(live[:, None], py[:, None],
                                       sy.gather(1, at)))
        s_slot.scatter_(1, at, torch.where(live[:, None], slot[:, None],
                                           s_slot.gather(1, at)))
        ax, ay = torch.where(live, bx, ax), torch.where(live, by, ay)
        bx, by = torch.where(live, px, bx), torch.where(live, py, by)
        top = torch.where(live, t + 1, top)
    stack = torch.stack([raw_x.gather(1, s_slot), raw_y.gather(1, s_slot)],
                        -1)
    lo_top, up_top = top[:V], top[V:]
    h = torch.where(cnt >= 2, lo_top + up_top - 2, cnt)
    n_lower = (lo_top - 1).clamp_min(0)
    i = torch.arange(L, device=dev)[None, :]
    up_slot = (i - n_lower[:, None]).clamp(0, L - 1)
    upper_chain = torch.gather(stack[V:], 1,
                               up_slot[..., None].expand(V, L, 2))
    hull = torch.where((i < n_lower[:, None])[..., None], stack[:V],
                       upper_chain)
    hull = torch.where((i < h[:, None])[..., None], hull, 0.0)
    return hull, h.to(torch.int32)


def monotone_chain_work(V: int, L: int, live: int, tests: int
                        ) -> Tuple[int, int]:
    """(flops, bytes) of one call over V runs of L slots holding ``live``
    points in all, whose chains make ``tests`` turn tests: the live points
    and the counts read once, the (V, L, 2) hulls and the counts h written
    once; 8 flops a turn test.  The tests depend on the data: about 4 c - h
    for a run of c points whose hull has h (each chain tests once a push
    and once a pop)."""
    return 8 * tests, live * 8 + V * 4 + V * L * 8 + V * 4


def monotone_chain_cuda(pts: torch.Tensor, counts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/monotone_chain.cu`` on CUDA tensors (one block a run);
    raises on any failure to build or launch.  A batch with no run or no
    slot launches nothing."""
    return _chain(pts, counts, "cuda")


def monotone_chain_meta(pts: torch.Tensor, counts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The meta route: checks and allocates what
    :func:`monotone_chain_cuda` does on meta tensors and computes
    nothing."""
    return _chain(pts, counts, "meta")


def _chain(pts, counts, device_type: str):
    global launches
    _check(pts, counts)
    if pts.device.type != device_type or counts.device != pts.device \
            or counts.dtype != torch.int32:
        raise ValueError(f"monotone_chain_{device_type} takes "
                         f"{device_type.upper()} float32 points and int32 "
                         f"counts on one device, got {pts.dtype} on "
                         f"{pts.device} and {counts.dtype} on "
                         f"{counts.device}")
    V, L, _ = pts.shape
    if V == 0 or L == 0:
        return torch.zeros_like(pts), torch.zeros_like(counts)
    if V >= 1 << 31 or L >= 1 << 31:
        raise ValueError(f"monotone_chain_{device_type}: {V} runs of {L} "
                         f"slots: both must stay below 2^31")
    pts, counts = pts.contiguous(), counts.contiguous()
    if pts.data_ptr() % 8:           # the kernel copies points as float2
        pts = pts.clone()
    hull = torch.empty_like(pts)
    h = torch.empty_like(counts)
    upper = torch.empty_like(pts)
    if device_type == "meta":
        return hull, h
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = _build.library().repro_monotone_chain(
        pts.data_ptr(), counts.data_ptr(), V, L, hull.data_ptr(),
        h.data_ptr(), upper.data_ptr(), stream)
    _build.check(err, "monotone_chain")
    launches += 1
    return hull, h


def kernel_shape(V: int, L: int) -> Dict[str, int]:
    """The stage size (points), ring depth (stages) and window size (stack
    entries) that a launch of :func:`monotone_chain_cuda` over V runs of L
    slots takes on the current CUDA device; asks the built library."""
    out = (ctypes.c_int * 3)()
    err = _build.library().repro_monotone_chain_shape(int(V), int(L),
                                                      ctypes.addressof(out))
    _build.check(err, "monotone_chain shape")
    return {"stage": out[0], "depth": out[1], "window": out[2]}
