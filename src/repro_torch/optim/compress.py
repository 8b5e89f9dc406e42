"""Gradient compression with error feedback, as ``repro.optim.compress``.

The cross-pod hop of the gradient funnel moves |params| bytes a step over
the slowest links.  Error-feedback int8 quantization cuts that 4x (fp32)
or 2x (bf16): the quantization residual is added back into the next
step's gradient (Seide et al. / EF-SGD).

:func:`compressed_allreduce` is the hop over a process group, the
counterpart of the JAX package's ``compressed_psum`` inside ``shard_map``:
each rank quantizes its error-corrected gradient to int8 with one float32
scale, the group all-gathers the int8 payloads and the scales, and every
rank sums the dequantized parts in rank order.  So the wire carries a
quarter of float32's bytes.  :func:`stacked_compressed_mean` is the JAX
package's GSPMD formulation (an explicit leading pod dimension) on one
process.  Parameters, moments and the within-pod reduce-scatter stay
exact.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..core import distributed as D
from ..core.distributed import all_gather


class EFState(NamedTuple):
    residual: Any              # nest like grads (+ leading pod dim if stacked)


def ef_init(grads_shape: Any, n_pod: int = 0) -> EFState:
    """Zero residuals like ``grads_shape`` (tensors: their shapes and
    devices).  n_pod > 0 builds per-pod residuals (a leading dim) for the
    stacked formulation: each pod carries its own quantization error."""
    lead = (n_pod,) if n_pod else ()
    return EFState(residual=tree_map(
        lambda g: torch.zeros(lead + tuple(g.shape), dtype=torch.float32,
                              device=getattr(g, "device", None)),
        grads_shape))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q, float32 scale)."""
    scale = _scale(torch.max(torch.abs(x)))
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor):
    """Returns (q, scale, new_residual): the residual carries what
    quantization lost into the next step."""
    corrected = g.to(torch.float32) + residual
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_allreduce(g: torch.Tensor, residual: torch.Tensor,
                         group=None, scale_group=None):
    """Error-feedback int8 mean of ``g`` over ``group``.

    ``scale_group``, when given, is a group (or a list of groups) over
    which ``g`` is one shard of a larger tensor: the scale is then taken
    from the MAX over it of the shards' maxima, so each shard quantizes as
    the whole tensor would.  Returns (the mean of the dequantized parts,
    summed in rank order, and the updated residual)."""
    corrected = g.to(torch.float32) + residual
    amax = torch.max(torch.abs(corrected))
    if scale_group is not None and not isinstance(scale_group,
                                                  (list, tuple)):
        scale_group = [scale_group]
    for sg in scale_group or ():
        if dist.get_world_size(sg) > 1:
            D.all_reduce_(amax, op=dist.ReduceOp.MAX, group=sg)
    scale = _scale(amax)
    q = _quantize(corrected, scale)
    new_res = corrected - dequantize_int8(q, scale)
    n = dist.get_world_size(group)
    if n == 1:
        return dequantize_int8(q, scale), new_res
    qs = all_gather(q.reshape((1,) + tuple(q.shape)), group)
    scales = all_gather(scale.reshape(1), group)
    total = dequantize_int8(qs[0], scales[0])
    for i in range(1, n):
        total = total + dequantize_int8(qs[i], scales[i])
    return total / n, new_res


def tree_compressed_allreduce(grads: Any, ef: EFState, group=None,
                              scale_group=None):
    """:func:`compressed_allreduce` over every leaf: (mean grads in each
    leaf's dtype, the new ``EFState``)."""
    flat_g, tdef = tree_flatten(grads)
    reduced, residuals = [], []
    for g, r in zip(flat_g, tree_leaves(ef.residual)):
        m, nr = compressed_allreduce(g, r, group, scale_group)
        reduced.append(m.to(g.dtype))
        residuals.append(nr)
    return (tree_unflatten(tdef, reduced),
            EFState(residual=tree_unflatten(tdef, residuals)))


def stacked_compressed_mean(g: torch.Tensor, residual: torch.Tensor):
    """``g`` carries an explicit leading pod dimension: per-pod
    error-feedback int8 quantization, then the mean of the dequantized
    per-pod gradients.  Returns (mean, new per-pod residuals)."""
    parts = [compress_with_feedback(g[i], residual[i])
             for i in range(g.shape[0])]
    total = torch.sum(torch.stack([dequantize_int8(q, s)
                                   for q, s, _ in parts]), dim=0)
    return total / g.shape[0], torch.stack([r for _, _, r in parts])


def tree_stacked_compressed_mean(grads: Any, ef: EFState):
    """Tree version of :func:`stacked_compressed_mean`; grads leaves have a
    leading pod dim matching ``ef_init(..., n_pod=)``."""
    flat_g, tdef = tree_flatten(grads)
    reduced, residuals = [], []
    for g, r in zip(flat_g, tree_leaves(ef.residual)):
        m, nr = stacked_compressed_mean(g, r)
        reduced.append(m.to(g.dtype))
        residuals.append(nr)
    return (tree_unflatten(tdef, reduced),
            EFState(residual=tree_unflatten(tdef, residuals)))


def compression_wire_bytes(grads: Any) -> Tuple[int, int]:
    """(uncompressed, compressed) bytes a rank sends per cross-pod hop:
    each leaf's bytes, against one byte an element and a float32 scale."""
    leaves = tree_leaves(grads)
    un = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() * 1 + 4 for g in leaves)
    return int(un), int(comp)
