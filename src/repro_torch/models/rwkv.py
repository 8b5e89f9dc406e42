"""RWKV6 "Finch" block — attention-free sequence mixing with data-dependent
per-channel decay (arXiv:2404.05892), on the chunked-scan substrate.

The port of ``repro.models.rwkv``.  Time mixing, per head with key/value
dims (dk, dv) and state S in R^{dk x dv}:

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(-exp(w0 + lora(x_t)))

Chunked execution: the intra-chunk terms use bounded log-space decay
tensors evaluated one chunk at a time (the JAX package's ``lax.map``: at
full width the (b, q, q, heads, dk) ratio tensor is 268 MB a chunk at batch
8); the inter-chunk state runs on :func:`repro_torch.kernels.ops.ssm_scan`
over channels = heads * dk * dv.  Channel mixing is the squared-ReLU MLP
with token shift.  Decode is the O(1) recurrent update.

In a mesh step with a ``"model"`` axis both mixes are tensor-parallel
regions.  Time mixing runs on the rank's heads where the column split of
``receptance``/``key``/``value``/``gate`` falls on whole heads of 64
(the decay, bonus and group norm are per channel or per head, sliced to
them), else on every head with those four gathered; ``output`` is
row-parallel, then an all-reduce.  Channel mixing: ``wk`` column- and
``wv`` row-parallel with an all-reduce; ``wr`` column-parallel gates the
rank's columns, which are then gathered.
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

RWKV_HEAD = 64          # dk = dv = 64
DECAY_LORA = 64


def rwkv_dims(cfg: ArchConfig) -> Tuple[int, int]:
    return cfg.d_model // RWKV_HEAD, RWKV_HEAD


def init_rwkv_time(gen: torch.Generator, cfg: ArchConfig,
                   lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    n_heads, hd = rwkv_dims(cfg)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu": _full(0.5, (5, d), cfg, gen, lead),     # r,k,v,w,g shift mixes
        "receptance": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
        "key": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
        "value": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
        "gate": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
        "output": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
        "w0": torch.full((*lead, d), -2.0, **f32),
        "w_lora_a": _dense_init(gen, (d, DECAY_LORA), torch.float32,
                                lead=lead),
        "w_lora_b": _dense_init(gen, (DECAY_LORA, d), torch.float32,
                                scale=0.01, lead=lead),
        "u": torch.zeros((*lead, n_heads, hd), **f32),          # bonus
        "ln_x_scale": _full(1.0, (d,), cfg, gen, lead),
    }


def init_rwkv_channel(gen: torch.Generator, cfg: ArchConfig,
                      lead: Tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": _full(0.5, (2, d), cfg, gen, lead),     # k, r mixes
        "wk": _dense_init(gen, (d, f), pdtype(cfg), lead=lead),
        "wv": _dense_init(gen, (f, d), pdtype(cfg), lead=lead),
        "wr": _dense_init(gen, (d, d), pdtype(cfg), lead=lead),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (prev fills position 0).  x: (b, s, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1]], 1)


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """log w_t in (-inf, 0): -exp(w0 + tanh(x A) B), clamped for the chunked
    log-space evaluation."""
    lora = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(p["w0"] + lora)
    return torch.clamp(logw, -5.0, -1e-4)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, n_heads: int):
    """Per-head RMS normalization of the wkv output (RWKV's ln_x)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-6)
    return (xh.reshape(b, s, d) * scale.float()).to(x.dtype)


def _mixes(x: torch.Tensor, xx: torch.Tensor, mu: torch.Tensor):
    """x + mu[i] * (xx - x) for each row of mu (the token-shift mixes)."""
    return [x + mu[i] * (xx - x) for i in range(mu.shape[0])]


def apply_rwkv_time(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    chunk: int = 32, return_state: bool = False):
    """Prefill time mixing.  x: (b, s, d).  With ``return_state`` also
    returns (S after the last token (b, h, dk, dv) float32, x_last (b, d)
    float32) for prefill -> decode."""
    dt_c = cdtype(cfg)
    b, s, d = x.shape
    n_heads, hd = rwkv_dims(cfg)
    tp = sharding.tp_split(p["output"], -2)
    rows = p["output"].shape[-2]
    width = d                       # the channels computed here
    if tp is not None:
        p, width = _time_region(p, d, tp)
        x = tp.copy(x)
        n_heads = width // hd
    xx = _shift(x, x.new_zeros((b, d)))
    xr, xk, xv, xw, xg = _mixes(x, xx, p["mu"].to(dt_c))
    r = (xr @ p["receptance"].to(dt_c)).reshape(b, s, n_heads, hd)
    k = (xk @ p["key"].to(dt_c)).reshape(b, s, n_heads, hd)
    v = (xv @ p["value"].to(dt_c)).reshape(b, s, n_heads, hd)
    g = F.silu(xg @ p["gate"].to(dt_c))
    logw = _decay(p, xw).reshape(b, s, n_heads, hd)       # (b,s,h,dk) f32

    # pad to a chunk multiple: logw 0 (decay 1) and k = 0, so the state
    # after the last chunk is the state after token s-1
    s_pad = -(-s // chunk) * chunk
    if s_pad != s:
        pad = (0, 0, 0, 0, 0, s_pad - s)
        r, k, v, logw = (F.pad(t, pad) for t in (r, k, v, logw))
    nc = s_pad // chunk
    rc, kc, vc = (t.reshape(b, nc, chunk, n_heads, hd).float()
                  for t in (r, k, v))
    cum = torch.cumsum(logw.reshape(b, nc, chunk, n_heads, hd), 2)

    # inter-chunk state scan (the kernel): S_c = W_c * S_{c-1}
    # + sum_j e^{L_end - L_j} k_j v_j^T
    tail = torch.exp(cum[:, :, -1:] - cum)                # (b,nc,q,h,dk)
    s_c = torch.einsum("bnjhk,bnjhv->bnhkv", kc * tail, vc)
    a_chunk = torch.exp(cum[:, :, -1])                    # (b,nc,h,dk)
    flat_a = repeat_each(a_chunk.reshape(b, nc, -1), hd, dim=-1)
    flat_s = s_c.reshape(b, nc, n_heads * hd * hd)
    h_all = kops.ssm_scan(flat_a, flat_s)
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], 1)
    h_prev = h_prev.reshape(b, nc, n_heads, hd, hd)

    iq = torch.arange(chunk, device=x.device)
    strict = (iq[:, None] > iq[None, :])[None, :, :, None]    # j < t
    ys = []
    for c in range(nc):
        rc_, kc_, vc_, cum_ = rc[:, c], kc[:, c], vc[:, c], cum[:, c]
        # L_{t-1} relative to the chunk start (0 for t = 0)
        lwq = torch.cat([torch.zeros_like(cum_[:, :1]), cum_[:, :-1]], 1)
        # intra: A[t,j] = sum_i r_t[i] k_j[i] e^{L_{t-1}[i] - L_j[i]}, j < t;
        # the (b,t,j,h,dk) ratio tensor is updated in place when no gradient
        # is taken (serving), and computed out of place under autograd,
        # which saves the intermediates for the backward
        ratio = lwq[:, :, None] - cum_[:, None]
        if torch.is_grad_enabled():
            ratio = ratio.clamp(-60.0, 60.0).exp()
            att = (ratio * rc_[:, :, None] * kc_[:, None]).sum(-1)
        else:
            ratio = ratio.clamp_(-60.0, 60.0).exp_()
            att = ratio.mul_(rc_[:, :, None]).mul_(kc_[:, None]).sum(-1)
        att = torch.where(strict, att, 0.0)                    # (b,t,j,h)
        del ratio
        y_intra = torch.einsum("btjh,bjhv->bthv", att, vc_)
        # bonus: (r_t . (u*k_t)) v_t
        y_bonus = (rc_ * p["u"] * kc_).sum(-1, keepdim=True) * vc_
        # inter: r_t e^{L_{t-1}} . H_prev
        y_inter = torch.einsum("bthk,bhkv->bthv", rc_ * torch.exp(lwq),
                               h_prev[:, c])
        ys.append(y_intra + y_bonus + y_inter)
    y = torch.stack(ys, 1).reshape(b, s_pad, width)[:, :s].to(dt_c)
    y = _group_norm(y, p["ln_x_scale"], n_heads) * g
    if tp is not None:
        if width == d:
            y = tp.block(y, -1, rows)
        out = tp.sum(y @ p["output"].to(dt_c))
    else:
        out = y @ p["output"].to(dt_c)
    if not return_state:
        return out
    S_last = h_all[:, -1].reshape(b, n_heads, hd, hd)
    return out, (S_last, x[:, -1].float())


_TIME_MATS = ("receptance", "key", "value", "gate")


def _time_region(p: Params, d: int, tp):
    """Time mixing's params on this rank of a ``"model"`` axis, entered
    into the region, and the channels it computes: the rank's heads where
    the column split falls on whole heads, else every channel."""
    w = p["receptance"].shape[-1]
    if not sharding.unit_split(w, d, RWKV_HEAD):
        return ({k: v if k == "output" else
                 tp.whole(v, -1, d) if k in _TIME_MATS else tp.copy(v)
                 for k, v in p.items()}, d)
    cols = {"w0": -1, "w_lora_b": -1, "ln_x_scale": -1}
    out = {}
    for k, v in p.items():
        if k in _TIME_MATS or k == "output":
            out[k] = v
        elif k == "u":                          # (heads, hd)
            out[k] = tp.block(tp.copy(v), -2, w // RWKV_HEAD)
        elif k in cols:
            out[k] = tp.block(tp.copy(v), -1, w)
        else:                                   # mu, w_lora_a
            out[k] = tp.copy(v)
    return out, w


def apply_rwkv_channel(p: Params, cfg: ArchConfig, x: torch.Tensor,
                       prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt_c = cdtype(cfg)
    b, s, d = x.shape
    tp = sharding.tp_split(p["wv"], -2)
    if tp is not None:
        return _channel_region(p, cfg, x, prev, tp)
    xx = _shift(x, x.new_zeros((b, d)) if prev is None else prev)
    xk, xr = _mixes(x, xx, p["mu"].to(dt_c))
    k = torch.square(F.relu(xk @ p["wk"].to(dt_c)))
    kv = k @ p["wv"].to(dt_c)
    return torch.sigmoid(xr @ p["wr"].to(dt_c)) * kv


def _channel_region(p: Params, cfg: ArchConfig, x, prev, tp):
    """Channel mixing over a ``"model"`` axis: k on the rank's d_ff
    columns, kv summed over the axis; the receptance gate on the rank's
    columns of ``wr`` (then gathered), or whole where ``wr`` is not
    split."""
    dt_c = cdtype(cfg)
    b, _, d = x.shape
    shift = lambda t: _shift(t, t.new_zeros((b, d)) if prev is None
                             else prev)
    mu = p["mu"].to(dt_c)
    xl = tp.copy(x)
    xk, xr = _mixes(xl, shift(xl), tp.copy(mu))
    k = torch.square(F.relu(xk @ p["wk"].to(dt_c)))
    kv = tp.sum(k @ p["wv"].to(dt_c))
    n = p["wr"].shape[-1]
    if n == d:
        _, xr = _mixes(x, shift(x), mu)
        return torch.sigmoid(xr @ p["wr"].to(dt_c)) * kv
    r = torch.sigmoid(xr @ p["wr"].to(dt_c))
    return tp.gather_out(r * tp.block(tp.copy(kv), -1, n), -1)


class RWKVState(NamedTuple):
    S: torch.Tensor           # (b, h, dk, dv) float32 wkv state
    x_time: torch.Tensor      # (b, d) last input of time mix
    x_chan: torch.Tensor      # (b, d) last input of channel mix


def init_rwkv_state(cfg: ArchConfig, batch: int,
                    device="cuda") -> RWKVState:
    """Zeroed decode state on ``device``: the card unless the caller asks
    for the CPU; raises without CUDA."""
    device = as_device(device, "state")
    n_heads, hd = rwkv_dims(cfg)
    d = cfg.d_model
    return RWKVState(S=torch.zeros((batch, n_heads, hd, hd), device=device),
                     x_time=torch.zeros((batch, d), device=device),
                     x_chan=torch.zeros((batch, d), device=device))


def rwkv_time_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     state: RWKVState, lay=None
                     ) -> Tuple[torch.Tensor, RWKVState]:
    """x: (b, 1, d) one-token decode.  In a mesh step ``state.S`` is the
    rank's part in ``lay`` (one layer's ``S`` layout: the value dimension
    over ``"model"``): r, k, v and the gate for every head from the
    rank's columns with the activations gathered, the rank's value block
    of the state and the output, gathered before the group norm."""
    if meshed(lay):
        return _time_decode_mesh(p, cfg, x, state, lay)
    dt_c = cdtype(cfg)
    b, _, d = x.shape
    n_heads, hd = rwkv_dims(cfg)
    x1 = x[:, 0]
    xx = state.x_time.to(x1.dtype)
    xr, xk, xv, xw, xg = _mixes(x1, xx, p["mu"].to(dt_c))
    r = (xr @ p["receptance"].to(dt_c)).reshape(b, n_heads, hd)
    k = (xk @ p["key"].to(dt_c)).reshape(b, n_heads, hd)
    v = (xv @ p["value"].to(dt_c)).reshape(b, n_heads, hd)
    g = F.silu(xg @ p["gate"].to(dt_c))
    w = torch.exp(_decay(p, xw)).reshape(b, n_heads, hd)
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]                  # (b,h,dk,dv)
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       state.S + p["u"][None, :, :, None] * kv)
    new_S = w[..., None] * state.S + kv
    y = out.reshape(b, 1, d).to(dt_c)
    y = _group_norm(y, p["ln_x_scale"], n_heads) * g[:, None]
    y = (y[:, 0] @ p["output"].to(dt_c))[:, None]
    return y, state._replace(S=new_S, x_time=x1.float())


def _time_decode_mesh(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      state: RWKVState, lay) -> Tuple[torch.Tensor,
                                                      RWKVState]:
    dt_c = cdtype(cfg)
    b, _, d = x.shape
    n_heads, hd = rwkv_dims(cfg)
    x1 = x[:, 0]
    xr, xk, xv, xw, xg = _mixes(x1, state.x_time.to(x1.dtype),
                                p["mu"].to(dt_c))
    r, k, v = (cols(cfg, t, p[n]).reshape(b, n_heads, hd).float()
               for t, n in ((xr, "receptance"), (xk, "key"), (xv, "value")))
    g = F.silu(cols(cfg, xg, p["gate"]))
    w = torch.exp(_decay(p, xw)).reshape(b, n_heads, hd)
    kv = k[..., :, None] * model_part(v[..., None, :], lay)   # (b,h,k,v')
    out = torch.einsum("bhk,bhkv->bhv", r,
                       state.S + p["u"][None, :, :, None] * kv)
    new_S = w[..., None] * state.S + kv
    if split_dim(lay) is not None:
        out = sharding.tp().gather_out(out, -1)
    y = out.reshape(b, 1, d).to(dt_c)
    y = _group_norm(y, p["ln_x_scale"], n_heads) * g[:, None]
    y = rows(cfg, y[:, 0], p["output"])[:, None]
    return y, state._replace(S=new_S, x_time=x1.float())


def rwkv_channel_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    dt_c = cdtype(cfg)
    if sharding.tp() is not None:
        # over "model": channel mixing's tensor-parallel region
        y = apply_rwkv_channel(p, cfg, x, prev=state.x_chan.to(x.dtype))
        return y, state._replace(x_chan=x[:, 0].float())
    x1 = x[:, 0]
    xx = state.x_chan.to(x1.dtype)
    xk, xr = _mixes(x1, xx, p["mu"].to(dt_c))
    k = torch.square(F.relu(xk @ p["wk"].to(dt_c)))
    kv = k @ p["wv"].to(dt_c)
    y = (torch.sigmoid(xr @ p["wr"].to(dt_c)) * kv)[:, None]
    return y, state._replace(x_chan=x1.float())
