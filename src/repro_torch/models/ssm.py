"""Mamba2 (SSD) block — zamba2's sequence mixer.

The port of ``repro.models.ssm``.  Chunked state-space duality: the
sequence is tiled into chunks of ``cfg.ssm_chunk``; within a chunk the
recurrence is evaluated in quadratic (matmul) form, and across chunks the
per-head state H (d_state x head dim) obeys the diagonal recurrence
``H_c = A_c * H_{c-1} + S_c``, which runs on
:func:`repro_torch.kernels.ops.ssm_scan` with channels = heads * d_state *
head dim (the hand-written CUDA kernel on the card).  Chunks are evaluated
one at a time, as the JAX package's ``lax.map`` does, so one chunk's
(b, q, q, heads) decay tensor is alive at a time.

In a mesh step with a ``"model"`` axis: ``in_proj`` packs [z, x, B, C,
dt] into one column block, which a ``"model"`` split always cuts, so it
is gathered over the axis, and every rank runs the whole block (and
``ssm_scan``) on all of its channels; ``out_proj``'s rows are gathered
too, so the block is one device's, with no all-reduce of its output.
With the sequence split over ``"model"`` (sequence parallelism) the
block gathers the sequence, scans all of it, and keeps the output of the
rank's slice; each rank then back-propagates its slice only, so the
gathered projections' gradients are the ranks' parts, reduce-scattered
over the axis.

Decode is the single-step recurrent update, O(1) in context length.
Initialisers draw from an explicit ``torch.Generator``, as
:mod:`repro_torch.models.layers` does; ``lead`` prepends stacked-layer axes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import as_device
from ..configs.base import ArchConfig
from ..kernels import ops as kops
from . import sharding
from .layers import (Params, _dense_init, _full, cdtype, cols, meshed,
                     model_part, pdtype, repeat_each, rows, split_dim)

D_CONV = 4
SSM_HEAD = 64


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_in, heads, d_state)."""
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // SSM_HEAD
    return d_in, n_heads, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    d_in, n_heads, d_state = ssm_dims(cfg)
    # in_proj emits [z (d_in), x (d_in), B (d_state), C (d_state), dt (heads)]
    d_proj = 2 * d_in + 2 * d_state + n_heads

    def f32(value):
        return torch.full((*lead, n_heads), value, dtype=torch.float32,
                          device=gen.device)

    return {
        "in_proj": _dense_init(gen, (d, d_proj), pdtype(cfg), lead=lead),
        "conv_w": _dense_init(gen, (D_CONV, d_in + 2 * d_state), pdtype(cfg),
                              scale=0.5, lead=lead),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "out_proj": _dense_init(gen, (d_in, d), pdtype(cfg), lead=lead),
        "norm_scale": _full(1.0, (d_in,), cfg, gen, lead),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_in, n_heads, d_state = ssm_dims(cfg)
    z = proj[..., :d_in]
    x = proj[..., d_in:2 * d_in]
    b_mat = proj[..., 2 * d_in:2 * d_in + d_state]
    c_mat = proj[..., 2 * d_in + d_state:2 * d_in + 2 * d_state]
    dt = proj[..., 2 * d_in + 2 * d_state:]
    return z, x, b_mat, c_mat, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq.  x: (b, s, c); w: (D_CONV, c).
    Returns (y, new_state) with state = the last D_CONV-1 inputs, in x's
    dtype."""
    b, s, c = x.shape
    if state is None:
        state = x.new_zeros((b, D_CONV - 1, c))
    xx = torch.cat([state.to(x.dtype), x], 1)
    y = sum(xx[:, i:i + s] * w[i] for i in range(D_CONV))
    return F.silu(y), xx[:, -(D_CONV - 1):]


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor):
    xf = x.float() * F.silu(z.float())
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 of (b, s, c) at the end."""
    return F.pad(t, (0, 0, 0, pad), value=value)


def apply_mamba(p: Params, cfg: ArchConfig, x: torch.Tensor,
                return_state: bool = False):
    """Prefill forward.  x: (b, s, d).  With ``return_state`` also returns
    the :class:`MambaState` after the last token (for prefill -> decode)."""
    dt_c = cdtype(cfg)
    sp = sharding.seq_split()
    if sp is not None:
        x = sp.enter(x)                 # the scan runs over every position
    b, s, _ = x.shape
    d_in, n_heads, d_state = ssm_dims(cfg)
    q = cfg.ssm_chunk
    for k, dim in (("in_proj", -1), ("out_proj", -2)):
        # over "model": the whole block on every rank, from the weights
        # gathered (with the sequence split each rank back-propagates its
        # slice only, so their gradients are parts, summed over the axis)
        tp = sharding.tp_split(p[k], dim)
        if tp is not None:
            full = p[k].shape[dim] * tp.size
            p = dict(p, **{k: tp.whole(p[k], dim, full) if sp is not None
                           else tp.gather_out(p[k], dim)})
    proj = x @ p["in_proj"].to(dt_c)
    z, xs, b_mat, c_mat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b_mat, c_mat], -1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"].to(dt_c))
    xs = conv_out[..., :d_in]
    b_mat = conv_out[..., d_in:d_in + d_state]
    c_mat = conv_out[..., d_in + d_state:]

    dt = F.softplus(dt.float() + p["dt_bias"])                   # (b,s,h)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                   # (b,s,h)

    # pad the sequence to a chunk multiple: a = 1 and inputs 0, so the
    # state after the last chunk is the state after token s-1
    s_pad = -(-s // q) * q
    if s_pad != s:
        pad = s_pad - s
        xs, b_mat, c_mat, dt = (_pad_seq(t, pad) for t in
                                (xs, b_mat, c_mat, dt))
        a = _pad_seq(a, pad, 1.0)
    nc = s_pad // q

    xh = xs.reshape(b, nc, q, n_heads, SSM_HEAD).float()
    bc = b_mat.reshape(b, nc, q, d_state).float()
    cc = c_mat.reshape(b, nc, q, d_state).float()
    ac = a.reshape(b, nc, q, n_heads)
    dtc = dt.reshape(b, nc, q, n_heads)
    xh = xh * dtc[..., None]                  # effective input dt * x

    cum = torch.cumsum(torch.log(ac.clamp(min=1e-20)), 2)   # log cumdecay

    # chunk summaries S_c = sum_j (prod_{j<t<=q} a) B_j x_j^T  (h, s, e)
    tail = torch.exp(cum[:, :, -1:] - cum)                       # (b,nc,q,h)
    s_c = torch.einsum("bnjs,bnjhe->bnhse", bc, xh * tail[..., None])
    # inter-chunk scan: the kernel; a_chunk spread over each head's
    # d_state * head-dim channels (jnp.repeat: each value in a row)
    a_chunk = torch.exp(cum[:, :, -1])                           # (b,nc,h)
    flat_s = s_c.reshape(b, nc, n_heads * d_state * SSM_HEAD)
    flat_a = repeat_each(a_chunk, d_state * SSM_HEAD, dim=-1)
    h_all = kops.ssm_scan(flat_a, flat_s)          # state AFTER each chunk
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], 1)
    h_prev = h_prev.reshape(b, nc, n_heads, d_state, SSM_HEAD)

    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        cc_, bc_, xh_, cum_ = cc[:, c], bc[:, c], xh[:, c], cum[:, c]
        # the decay from j to i, zero above the diagonal: masked before the
        # exp, where the JAX package masks the product after it.  Above
        # the diagonal cum_i - cum_j > 0 and its exp overflows at long
        # chunks of strong decay; the masked-off inf then turns the
        # backward's 0 * inf into NaN (the values are the same).
        decay = torch.exp((cum_[:, :, None, :] - cum_[:, None, :, :])
                          .masked_fill(~causal, float("-inf")))
        gmat = torch.einsum("bis,bjs->bij", cc_, bc_)[..., None] * decay
        y_in = torch.einsum("bijh,bjhe->bihe", gmat, xh_)
        y_x = torch.einsum("bis,bhse->bihe", cc_, h_prev[:, c]) \
            * torch.exp(cum_)[..., None]
        ys.append(y_in + y_x)
    y = torch.stack(ys, 1).reshape(b, s_pad, n_heads, SSM_HEAD)[:, :s]
    y = y + p["D"][:, None] * xs.reshape(b, s_pad, n_heads, SSM_HEAD)[:, :s]
    y = y.reshape(b, s, d_in).to(dt_c)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    if sp is not None:
        y = sp.own(y)                   # the output of the rank's slice
    out = y @ p["out_proj"].to(dt_c)
    if not return_state:
        return out
    h_last = h_all[:, -1].reshape(b, n_heads, d_state, SSM_HEAD)
    return out, MambaState(h=h_last, conv=conv_state.float())


class MambaState(NamedTuple):
    h: torch.Tensor          # (b, heads, d_state, SSM_HEAD) float32
    conv: torch.Tensor       # (b, D_CONV-1, d_in + 2*d_state)


def init_mamba_state(cfg: ArchConfig, batch: int,
                     device="cuda") -> MambaState:
    """Zeroed decode state on ``device``: the card unless the caller asks
    for the CPU; raises without CUDA."""
    device = as_device(device, "state")
    d_in, n_heads, d_state = ssm_dims(cfg)
    return MambaState(
        h=torch.zeros((batch, n_heads, d_state, SSM_HEAD), device=device),
        conv=torch.zeros((batch, D_CONV - 1, d_in + 2 * d_state),
                         device=device))


def mamba_decode_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      state: MambaState, lay=None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """x: (b, 1, d) -> (y (b, 1, d), new state).  O(1) in context length.
    The new state's conv is in the compute dtype, as in the JAX package.

    In a mesh step ``state.h`` is the rank's part in ``lay`` (one layer's
    ``mamba_h`` layout: heads over ``"model"``): the projections run on
    the rank's columns and rows of ``in_proj`` and ``out_proj`` with the
    activations gathered, the rank's heads update their state, and their
    outputs are gathered over ``"model"``."""
    if meshed(lay):
        return _decode_mesh(p, cfg, x, state, lay)
    dt_c = cdtype(cfg)
    b = x.shape[0]
    d_in, n_heads, d_state = ssm_dims(cfg)
    proj = x @ p["in_proj"].to(dt_c)
    z, xs, b_mat, c_mat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b_mat, c_mat], -1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"].to(dt_c),
                                      state.conv)
    xs = conv_out[..., :d_in]
    b_mat = conv_out[:, 0, d_in:d_in + d_state].float()
    c_mat = conv_out[:, 0, d_in + d_state:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])              # (b,h)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    x_raw = xs[:, 0].reshape(b, n_heads, SSM_HEAD).float()
    xh = x_raw * dt[..., None]
    upd = b_mat[:, None, :, None] * xh[:, :, None, :]             # (b,h,s,e)
    h = a[:, :, None, None] * state.h + upd
    y = torch.einsum("bs,bhse->bhe", c_mat, h)
    y = y + p["D"][None, :, None] * x_raw
    y = y.reshape(b, 1, d_in).to(dt_c)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_c)
    return out, MambaState(h=h, conv=new_conv)


def _decode_mesh(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 state: MambaState, lay) -> Tuple[torch.Tensor, MambaState]:
    dt_c = cdtype(cfg)
    b = x.shape[0]
    d_in, n_heads, d_state = ssm_dims(cfg)
    z, xs, b_mat, c_mat, dt = _split_proj(cfg, cols(cfg, x, p["in_proj"]))
    conv_in = torch.cat([xs, b_mat, c_mat], -1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"].to(dt_c),
                                      state.conv)
    xs = conv_out[..., :d_in]
    b_mat = conv_out[:, 0, d_in:d_in + d_state].float()
    c_mat = conv_out[:, 0, d_in + d_state:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])              # (b,h)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    x_raw = xs[:, 0].reshape(b, n_heads, SSM_HEAD).float()
    # the rank's heads (dimension 1 of a (b, heads, ...) state)
    a, dt_x, d_skip = (model_part(t, lay) for t in (
        a, x_raw * dt[..., None], p["D"][None].expand(b, -1)))
    x_mine = model_part(x_raw, lay)
    h = a[:, :, None, None] * state.h + b_mat[:, None, :, None] * \
        dt_x[:, :, None, :]
    y = torch.einsum("bs,bhse->bhe", c_mat, h) + d_skip[..., None] * x_mine
    if split_dim(lay) is not None:
        y = sharding.tp().gather_out(y, 1)
    y = _gated_rmsnorm(y.reshape(b, 1, d_in).to(dt_c), z, p["norm_scale"])
    return rows(cfg, y, p["out_proj"]), MambaState(h=h, conv=new_conv)
