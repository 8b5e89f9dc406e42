"""Shared neural layers: norms, rotary, GQA attention, MLP, embeddings.

The port of ``repro.models.layers`` for one device.  Functional style as
there: ``init_*`` draws a params dict from a ``torch.Generator``, the
apply-style functions read one (a dict of tensors, or the model's parameter
nest, which indexes the same way).  Params are stored in
``cfg.param_dtype``; every product runs in ``cfg.compute_dtype``, each
weight cast at its use as the JAX package does (a cast to the dtype a
tensor already has is free, so a caller may pass weights already cast).
Norms, rotary angles and attention softmax compute in float32 and cast back.

Attention has the JAX package's three execution paths, picked by
:func:`sdpa`: plain einsum, query-chunked softmax for long sequences, and
the flash kernel (``attn_impl="flash"``, more than one query), which is the
hand-written CUDA kernel on the card (:mod:`repro_torch.kernels.ops`),
forward only there: training runs ``attn_impl="xla"``.  The
encoder-decoder's :func:`cross_attention` takes the same paths, unmasked,
over the K/V :func:`init_cross_kv` computes once from the encoder output.
The training loss is :func:`cross_entropy`.
The JAX package's sharding constraints are identities on one device and
are left out.

In a mesh step with a ``"model"`` axis (:func:`.sharding.tp`) the
training functions compute Megatron style on the rank's part of each
weight (:mod:`repro_torch.train.zero`): the embedding is a masked lookup
in the rank's vocabulary slice plus an all-reduce; ``lm_head`` gives the
rank's slice of the logits and :func:`vocab_parallel_cross_entropy` takes
the log-sum-exp, the z-loss and the gold logit across the slices; the
MLP and attention run on the rank's d_ff columns and heads
(column-parallel ``w_gate``/``w_up``/``wq``/``wk``/``wv``, row-parallel
``w_down``/``wo``, then an all-reduce).  A ``wq``/``wk``/``wv`` split
that cuts a head is gathered over ``"model"`` (kimi-k2's 2 KV heads at 4
ranks), and each local query head reads its own KV head.  Replicated
biases are entered into the region and sliced to the local columns.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.distributed import AttnPartial, all_reduce, softmax_merge_axis
from ..kernels import ops as kops
from . import sharding

Params = Dict[str, Any]
NEG_INF = -1e30
#: the most float32 elements _dense_init draws at once (1 GiB)
_INIT_CHUNK = 1 << 28


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


class MetaSource:
    """Stands in for the ``torch.Generator`` of the ``init_*`` functions
    when a model is built on the meta device: they read its ``device``
    and draw nothing (:func:`randn`), so the stand-in model has the drawn
    model's names, shapes and dtypes and holds no memory."""

    device = torch.device("meta")


def randn(gen, shape: Sequence[int]) -> torch.Tensor:
    """float32 N(0, 1) of ``shape`` drawn from ``gen``; an empty meta
    tensor for a :class:`MetaSource`."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), device=gen.device)
    return torch.randn(*shape, generator=gen, device=gen.device)


def _dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
                scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    """Normal(0, 1) * scale (default 1/sqrt(fan_in)), cast to ``dtype``;
    ``lead`` prepends stacked-layer axes.  Allocated, not drawn, on the
    meta device."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (*lead, *shape)
    if gen.device.type == "meta":
        return torch.empty(full, dtype=dtype, device=gen.device)
    if math.prod(full) <= _INIT_CHUNK:
        x = torch.randn(*full, generator=gen, device=gen.device) * s
        return x.to(dtype)
    # too large to hold in float32 beside its cast (kimi-k2's experts, 22.5
    # GB a tensor): drawn a block of rows of the first axis at a time
    out = torch.empty(full, dtype=dtype, device=gen.device)
    rows = out.flatten(0, len(lead))
    step = max(1, _INIT_CHUNK // math.prod(rows.shape[1:]))
    for i in range(0, rows.shape[0], step):
        blk = rows[i:i + step]
        blk.copy_(torch.randn(blk.shape, generator=gen,
                              device=gen.device).mul_(s))
    return out


def _full(value: float, shape, cfg, gen, lead=()):
    return torch.full((*lead, *shape), value, dtype=pdtype(cfg),
                      device=gen.device)


# ----------------------------------------------------------------- norms
def init_norm(gen, cfg: ArchConfig, kind: Optional[str] = None,
              lead: Tuple[int, ...] = ()) -> Params:
    kind = kind or cfg.norm
    d = cfg.d_model
    if kind == "rmsnorm":
        return {"scale": _full(1.0, (d,), cfg, gen, lead)}
    if kind == "layernorm":
        return {"scale": _full(1.0, (d,), cfg, gen, lead),
                "bias": _full(0.0, (d,), cfg, gen, lead)}
    if kind == "nonparam_ln":          # OLMo: no affine parameters
        return {}
    raise ValueError(kind)


def apply_norm(p: Params, cfg: ArchConfig, x: torch.Tensor,
               kind: Optional[str] = None) -> torch.Tensor:
    kind = kind or cfg.norm
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * p["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    elif kind != "nonparam_ln":
        raise ValueError(kind)
    return y.to(x.dtype)


# ----------------------------------------------------------------- rotary
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., seq, heads, hd); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs        # (..., s, half)
    cos = torch.cos(angles)[..., None, :]                # (..., s, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- embeddings
def init_embed(gen, cfg: ArchConfig) -> Params:
    # padded_vocab rows: no token id reaches them, and their logits are
    # masked in apply_lm_head
    return {"table": _dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                 pdtype(cfg), scale=0.02)}


def apply_embed(p: Params, cfg: ArchConfig, ids: torch.Tensor) -> torch.Tensor:
    table = p["table"].to(cdtype(cfg))
    tp = sharding.tp_split(table, 0)
    if tp is None:
        return table[ids.long()]
    # vocab-parallel: the rows of the rank's slice, zero elsewhere, summed
    n = table.shape[0]
    local = ids.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)]
    return tp.sum(torch.where(inside[..., None], x, 0))


def init_lm_head(gen, cfg: ArchConfig) -> Params:
    return {"w": _dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                             pdtype(cfg))}


def apply_lm_head(p: Optional[Params], cfg: ArchConfig, x: torch.Tensor,
                  embed: Optional[Params] = None) -> torch.Tensor:
    """Logits over ``padded_vocab``, the padding tail masked to -1e30 (so a
    softmax or argmax sees exactly the real vocabulary)."""
    if cfg.tie_embeddings and embed is not None:
        tp = sharding.tp_split(embed["table"], 0)
        w = embed["table"].to(cdtype(cfg)).T
    else:
        w = p["w"].to(cdtype(cfg))
        tp = sharding.tp_split(w, -1)
    first = 0
    if tp is not None:
        # vocab-parallel: the rank's slice of the logits
        x, first = tp.copy(x), tp.rank * w.shape[-1]
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(first, first + logits.shape[-1],
                           device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    if tp is not None:
        logits.tp_dim = logits.ndim - 1    # the rank's vocabulary slice
    return logits


# -------------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ArchConfig, d_ff: Optional[int] = None,
             bias: bool = False, lead: Tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": _dense_init(gen, (d, f), pdtype(cfg), lead=lead),
         "w_down": _dense_init(gen, (f, d), pdtype(cfg), lead=lead)}
    if cfg.act == "silu":
        p["w_gate"] = _dense_init(gen, (d, f), pdtype(cfg), lead=lead)
    if bias:
        p["b_up"] = _full(0.0, (f,), cfg, gen, lead)
        p["b_down"] = _full(0.0, (d,), cfg, gen, lead)
    return p


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP; over a ``"model"`` axis on the rank's d_ff columns
    (``w_gate``/``w_up`` column-parallel, ``w_down`` row-parallel, then an
    all-reduce; ``b_up`` sliced to the columns, ``b_down`` after the
    sum)."""
    dt = cdtype(cfg)
    tp = sharding.tp_split(p["w_down"], 0)
    b_up = p.get("b_up")
    if tp is not None:
        x = tp.copy(x)
        if b_up is not None:
            b_up = tp.block(tp.copy(b_up), -1, p["w_down"].shape[0])
    up = x @ p["w_up"].to(dt)
    if b_up is not None:
        up = up + b_up.to(dt)
    if cfg.act == "silu":
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")        # jax.nn.gelu's default
    out = h @ p["w_down"].to(dt)
    if tp is not None:
        out = tp.sum(out)
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


# -------------------------------------------------------------- attention
def init_attention(gen, cfg: ArchConfig,
                   lead: Tuple[int, ...] = ()) -> Params:
    d, hd = cfg.d_model, cfg.hd
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": _dense_init(gen, (d, h * hd), pdtype(cfg), lead=lead),
         "wk": _dense_init(gen, (d, kvh * hd), pdtype(cfg), lead=lead),
         "wv": _dense_init(gen, (d, kvh * hd), pdtype(cfg), lead=lead),
         "wo": _dense_init(gen, (h * hd, d), pdtype(cfg), lead=lead)}
    if cfg.qkv_bias:
        p["bq"] = _full(0.0, (h * hd,), cfg, gen, lead)
        p["bk"] = _full(0.0, (kvh * hd,), cfg, gen, lead)
        p["bv"] = _full(0.0, (kvh * hd,), cfg, gen, lead)
    return p


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    dt = cdtype(cfg)
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_each(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``torch.repeat_interleave(x, n, dim)`` for an int ``n`` (each slice
    along ``dim`` n times in a row), as a broadcast copy: its backward sums
    the copies in a fixed order, where ``repeat_interleave``'s backward
    adds them with atomics on the card, in an order that changes from run
    to run."""
    dim = dim % x.ndim
    shape = tuple(x.shape)
    wide = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], n, *shape[dim + 1:])
    return wide.reshape(*shape[:dim], shape[dim] * n, *shape[dim + 1:])


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """Broadcast GQA KV heads (axis 2) to the full head count: query head i
    reads KV head i // (h / kvh)."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return repeat_each(k, h // kvh, dim=2)


def _sdpa_einsum(q, k, v, causal: bool, q_offset: int = 0):
    """(b, s, h, hd) x (b, t, kvh, hd) full-materialisation attention."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(s, device=q.device)[:, None] + q_offset
        ki = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(qi < ki, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    return out.to(q.dtype)


def _sdpa_chunked(q, k, v, causal: bool, chunk: int = 1024,
                  q_offset: int = 0):
    """Query-chunked attention: O(chunk * T) live score memory."""
    b, s, h, hd = q.shape
    if s % chunk != 0:
        pad = chunk - s % chunk
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        return _sdpa_chunked(q, k, v, causal, chunk, q_offset)[:, :s]
    t = k.shape[1]
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h).float()
    kpos = torch.arange(t, device=q.device)[None, :]
    outs = []
    for ci in range(q.shape[1] // chunk):
        qi_block = q[:, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("bshd,bthd->bhst", qi_block.float(),
                              k) / math.sqrt(hd)
        if causal:
            qpos = (ci * chunk + torch.arange(chunk, device=q.device)[:, None]
                    + q_offset)
            scores = scores.masked_fill(qpos < kpos, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", w, v).to(q.dtype))
    return torch.cat(outs, dim=1)


def sdpa(cfg: ArchConfig, q, k, v, causal: bool, q_offset: int = 0):
    """Attention of q (b, s, h, hd) over k, v (b, t, kvh, hd)."""
    s, t = q.shape[1], k.shape[1]
    if cfg.attn_impl == "flash" and s > 1:
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    if s * t > 2048 * 4096 and s > 1:
        return _sdpa_chunked(q, k, v, causal, chunk=2048, q_offset=q_offset)
    return _sdpa_einsum(q, k, v, causal, q_offset=q_offset)


class _Heads(NamedTuple):
    """A rank's part of an attention's tensor-parallel region: its query
    heads [q0, q0 + hq) with their weights (the rank's columns of ``wq``,
    or the whole gathered ``wq`` where the split cuts a head), the KV
    weights likewise, and ``kv_pick``, the KV head each query head reads
    where the rank computes every KV head (None: its own KV heads, in
    GQA order)."""
    wq: torch.Tensor
    bq: Optional[torch.Tensor]
    q0: int
    hq: int
    wk: torch.Tensor
    wv: torch.Tensor
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]
    kv_pick: Optional[torch.Tensor]


def _tp_heads(p: Params, cfg: ArchConfig, tp, kv: bool = True) -> _Heads:
    """The rank's :class:`_Heads` (without the KV weights unless
    ``kv``)."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = p["wq"].device

    def side(w, b, heads):
        if sharding.unit_split(w.shape[-1], heads * hd, hd):
            n = w.shape[-1]
            bias = None if b is None else tp.block(tp.copy(b), -1, n)
            return w, bias, tp.rank * (n // hd), n // hd
        bias = None if b is None else tp.copy(b)
        return tp.whole(w, -1, heads * hd), bias, 0, heads

    wq, bq, q0, hq = side(p["wq"], p.get("bq"), h)
    if not kv:
        return _Heads(wq, bq, q0, hq, None, None, None, None, None)
    wk, bk, _, hk = side(p["wk"], p.get("bk"), kvh)
    wv, bv, _, _ = side(p["wv"], p.get("bv"), kvh)
    pick = None
    if hk == kvh and hq < h:
        # every KV head here: each local query head picks its own
        pick = (q0 + torch.arange(hq, device=dev)) // (h // kvh)
    elif hk < kvh and hq == h:
        raise ValueError("KV heads split where query heads are not")
    return _Heads(wq, bq, q0, hq, wk, wv, bk, bv, pick)


def _tp_kv(hs: _Heads, cfg: ArchConfig, src: torch.Tensor,
           positions: Optional[torch.Tensor]):
    """The rank's K/V (b, t, heads, hd) of ``src`` (already entered into
    the region): its own KV heads, or for each local query head its KV
    head."""
    dt = cdtype(cfg)
    b, t, _ = src.shape
    k = src @ hs.wk.to(dt)
    v = src @ hs.wv.to(dt)
    if hs.bk is not None:
        k, v = k + hs.bk.to(dt), v + hs.bv.to(dt)
    k = k.reshape(b, t, -1, cfg.hd)
    v = v.reshape(b, t, -1, cfg.hd)
    if positions is not None and cfg.use_rope:
        k = rope(k, positions, cfg.rope_theta)
    if hs.kv_pick is not None:
        k, v = k[:, :, hs.kv_pick], v[:, :, hs.kv_pick]
    return k, v


def _tp_out(hs: _Heads, cfg: ArchConfig, p: Params, out: torch.Tensor,
            tp) -> torch.Tensor:
    """The region's row-parallel ``wo`` on the computed heads' output
    (b, s, heads * hd), summed over ``"model"``."""
    rows = p["wo"].shape[0]
    if out.shape[-1] != rows:              # every head computed here
        out = tp.block(out, -1, rows)
    return tp.sum(out @ p["wo"].to(cdtype(cfg)))


def _tp_q(hs: _Heads, cfg: ArchConfig, x: torch.Tensor, positions):
    dt = cdtype(cfg)
    b, s, _ = x.shape
    q = x @ hs.wq.to(dt)
    if hs.bq is not None:
        q = q + hs.bq.to(dt)
    q = q.reshape(b, s, hs.hq, cfg.hd)
    if positions is not None and cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def apply_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Training self-attention over the full sequence: y (b, s, d); over
    a ``"model"`` axis on the rank's heads."""
    b, s, _ = x.shape
    tp = sharding.tp_split(p["wo"], 0)
    if tp is not None:
        hs = _tp_heads(p, cfg, tp)
        x = tp.copy(x)
        q = _tp_q(hs, cfg, x, positions)
        k, v = _tp_kv(hs, cfg, x, positions)
        out = sdpa(cfg, q, k, v, causal)
        return _tp_out(hs, cfg, p, out.reshape(b, s, -1), tp)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = sdpa(cfg, q, k, v, causal)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(cdtype(cfg))


# ---------------------------------------------------- serving on a mesh
# Prefill and decode in a mesh step (an active ShardRun): the weights are
# the rank's blocks where "model" splits them, the decode state is the
# rank's part in the layout of launch.specs.mesh_decode_state_specs (KV
# heads, or else the head dimension, over "model"; the sequence over
# "data" when the batch does not split), and the activations between the
# layers are whole on every "model" rank.

def split_dim(lay) -> Optional[int]:
    """The dimension of a layout that ``"model"`` splits over more than
    one rank, or None (no layout, or whole)."""
    if lay is None or lay.model_dim is None or lay.parts[lay.model_dim] < 2:
        return None
    return lay.model_dim


def model_part(t: torch.Tensor, lay) -> torch.Tensor:
    """The rank's block of ``t`` (whole along the dimension ``lay``
    splits over ``"model"``; the other dimensions already the rank's)."""
    md = split_dim(lay)
    if md is None:
        return t
    n = lay.local_shape[md]
    return t.narrow(md, lay.index[md] * n, n)


def seq_split(lay) -> bool:
    """Whether ``lay`` (one layer's cache, (B, T, ...)) splits the
    sequence over ``"data"``."""
    return lay is not None and lay.parts[1] > 1


def meshed(lay) -> bool:
    """Whether a serving step's layer runs its mesh form: a ``"model"``
    axis of more than one rank, or a cache layout ``lay`` whose sequence
    is split (else the rank's rows run as on one device)."""
    return sharding.tp() is not None or seq_split(lay)


def write_prompt(cache: torch.Tensor, kv: torch.Tensor, lay=None) -> None:
    """Write a prompt's K or V ``kv`` (b, s, kvh, hd; every head) at
    positions 0..s-1 of one layer's cache (b, T, ...), the rank's part of
    it in ``lay``: its heads or head-dimension block, and of the positions
    only those in its slice of the sequence."""
    kv = model_part(kv, lay)
    if seq_split(lay):
        t = cache.shape[1]
        lo = lay.index[1] * t
        kv = kv[:, lo:lo + max(0, min(t, kv.shape[1] - lo))]
    cache[:, :kv.shape[1]] = kv


def cols(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor,
         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` for every column of ``w``: on a ``"model"`` axis
    that splits ``w``'s columns, the ranks' blocks gathered."""
    dt = cdtype(cfg)
    y = x @ w.to(dt)
    tp = sharding.tp_split(w, -1)
    if tp is not None:
        y = tp.gather_out(y, -1)
    return y if b is None else y + b.to(dt)


def rows(cfg: ArchConfig, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y @ w`` for ``y`` whole along its last dimension: on a
    ``"model"`` axis that splits ``w``'s rows, the rank's block of ``y``
    times its rows, summed over the axis."""
    dt = cdtype(cfg)
    tp = sharding.tp_split(w, -2)
    if tp is None:
        return y @ w.to(dt)
    return tp.sum(tp.block(y, -1, w.shape[-2]) @ w.to(dt))


def _kv_all(p: Params, cfg: ArchConfig, x: torch.Tensor,
            positions: Optional[torch.Tensor]):
    """K and V (b, t, kvh, hd) of every KV head of ``x``."""
    b, t, _ = x.shape
    k = cols(cfg, x, p["wk"], p.get("bk")).reshape(b, t, cfg.n_kv_heads,
                                                   cfg.hd)
    v = cols(cfg, x, p["wv"], p.get("bv")).reshape(b, t, cfg.n_kv_heads,
                                                   cfg.hd)
    if positions is not None and cfg.use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _kv_of_heads(hs: _Heads, cfg: ArchConfig, k: torch.Tensor):
    """The K (or V) of every KV head cut to the rank's query heads: the
    block of KV heads they read where they form whole groups, else one KV
    head a query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    if hs.q0 % g == 0 and hs.hq % g == 0:
        return k[:, :, hs.q0 // g:(hs.q0 + hs.hq) // g]
    pick = (hs.q0 + torch.arange(hs.hq, device=k.device)) // g
    return k[:, :, pick]


def _attend(cfg: ArchConfig, q: torch.Tensor, ck: torch.Tensor,
            cv: torch.Tensor, lay, keep: Optional[torch.Tensor]):
    """One query (b, 1, h', hd') over the rank's cache part (b, t, kvh',
    hd') in ``lay``: the partial scores summed over ``"model"`` where it
    splits the head dimension, the partials merged over ``"data"``
    (:func:`repro_torch.core.distributed.softmax_merge_axis`) where it
    splits the sequence.  ``keep`` (b, t) masks the positions.  Returns
    (b, 1, h', hd')."""
    b = q.shape[0]
    hk = ck.shape[2]
    qg = q.float().reshape(b, 1, hk, q.shape[2] // hk, q.shape[3])
    scores = torch.einsum("bsngd,btnd->bngst", qg, ck.float())
    if split_dim(lay) == 3:
        scores = all_reduce(scores, group=sharding.tp().group)
    scores = scores / math.sqrt(cfg.hd)
    if keep is not None:
        scores = scores.masked_fill(~keep[:, None, None, None, :], NEG_INF)
    if seq_split(lay):
        m = scores.amax(-1)
        e = torch.exp(scores - m[..., None])
        o = torch.einsum("bngst,btnd->bngsd", e, cv.float())
        data = sharding.shard_run().groups.group("data")
        out = softmax_merge_axis(AttnPartial(m, e.sum(-1), o), data)
        out = out.permute(0, 3, 1, 2, 4)
    else:
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bngst,btnd->bsngd", w, cv.float())
    return out.reshape(b, 1, -1, out.shape[-1])


def _attend_out(p: Params, cfg: ArchConfig, out: torch.Tensor,
                lay) -> torch.Tensor:
    """The output projection of one query's heads ``out`` (b, 1, h',
    hd') in ``lay``: the rank's heads times its rows of ``wo`` where they
    match, else every head gathered first."""
    b, dt = out.shape[0], cdtype(cfg)
    md = split_dim(lay)
    tp = sharding.tp()
    if md == 2:
        wo_tp = sharding.tp_split(p["wo"], -2)
        if wo_tp is not None and p["wo"].shape[0] == out.shape[2] * cfg.hd:
            return tp.sum(out.reshape(b, 1, -1).to(dt) @ p["wo"].to(dt))
        out = tp.gather_out(out, 2)
    elif md == 3:
        out = tp.gather_out(out, 3)
    return rows(cfg, out.reshape(b, 1, -1).to(dt), p["wo"])


def _q_part(q: torch.Tensor, cfg: ArchConfig, lay) -> torch.Tensor:
    """The query heads (b, 1, h, hd) the rank's cache part in ``lay``
    serves: the heads that read its KV heads, or every head's block of
    the head dimension."""
    md = split_dim(lay)
    if md == 2:
        n = q.shape[2] * lay.local_shape[2] // cfg.n_kv_heads
        return q.narrow(2, lay.index[2] * n, n)
    return model_part(q, lay) if md == 3 else q


def _decode_mesh(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos: torch.Tensor, lay):
    """:func:`attention_decode` in a mesh step: the new token's Q, K, V
    for every head, its K/V written at ``pos`` by the rank whose part
    holds that slot, attention on the rank's part (:func:`_attend`)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = cols(cfg, x, p["wq"], p.get("bq")).reshape(b, 1, h, hd)
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
    k, v = _kv_all(p, cfg, x, pos[:, None])
    t = cache_k.shape[1]
    lo = lay.index[1] * t if seq_split(lay) else 0
    slot = pos.long().clamp(0, lay.shape[1] - 1) - lo
    mine = ((slot >= 0) & (slot < t))[:, None, None]
    slot = slot.clamp(0, t - 1)
    at = torch.arange(b, device=x.device)
    for cache, new in ((cache_k, k), (cache_v, v)):
        new = model_part(new, lay)[:, 0].to(cache.dtype)
        cache[at, slot] = torch.where(mine, new, cache[at, slot])
    keep = (torch.arange(t, device=x.device)[None, :] + lo) <= pos[:, None]
    out = _attend(cfg, _q_part(q, cfg, lay), cache_k, cache_v, lay, keep)
    return _attend_out(p, cfg, out, lay), cache_k, cache_v


def cross_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 kv_k: torch.Tensor, kv_v: torch.Tensor,
                 lay=None) -> torch.Tensor:
    """Decoder cross-attention of one token x (b, 1, d) over the cached
    encoder K/V: :func:`cross_attention`, and in a mesh step on the
    rank's part of the cache in ``lay``."""
    if not meshed(lay):
        return cross_attention(p, cfg, x, kv_k, kv_v)
    b = x.shape[0]
    q = cols(cfg, x, p["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
    out = _attend(cfg, _q_part(q, cfg, lay), kv_k, kv_v, lay, None)
    return _attend_out(p, cfg, out, lay)


def attention_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor):
    """Returns (y, (k, v)) — k and v in (b, s, kvh, hd), every KV head;
    over a ``"model"`` axis the attention runs on the rank's query
    heads."""
    b, s, _ = x.shape
    tp = sharding.tp_split(p["wo"], 0)
    if tp is not None:
        hs = _tp_heads(p, cfg, tp, kv=False)
        x = tp.copy(x)
        k, v = _kv_all(p, cfg, x, positions)
        out = sdpa(cfg, _tp_q(hs, cfg, x, positions),
                   _kv_of_heads(hs, cfg, k), _kv_of_heads(hs, cfg, v),
                   causal=True)
        return _tp_out(hs, cfg, p, out.reshape(b, s, -1), tp), (k, v)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = sdpa(cfg, q, k, v, causal=True)
    y = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(cdtype(cfg))
    return y, (k, v)


def attention_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, lay=None):
    """One-token decode.  x: (b, 1, d); caches: (b, T_max, kvh, hd);
    pos: (b,) tokens already in the cache.

    Attends the new token to cache[0:pos] and itself, and writes its K/V
    at ``pos`` — **in place**, into ``cache_k`` and ``cache_v``, which are
    returned.  A position past the end writes the last slot, as JAX's
    ``dynamic_update_slice`` clamps its start.

    In a mesh step the caches are the rank's part in ``lay``, one layer's
    cache layout (:func:`_decode_mesh`)."""
    if meshed(lay):
        return _decode_mesh(p, cfg, x, cache_k, cache_v, pos, lay)
    b = x.shape[0]
    dt = cdtype(cfg)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    t = cache_k.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = pos.long().clamp(0, t - 1)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    # the GQA broadcast as a grouped einsum: query head i = n * (h / kvh) + j
    # reads KV head n, as _repeat_kv maps it, without copying the cache
    qg = q.float().reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bsngd,btnd->bngst", qg,
                          cache_k.float()) / math.sqrt(hd)
    keep = torch.arange(t, device=x.device)[None, :] <= pos[:, None]  # (b, t)
    scores = scores.masked_fill(~keep[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", w, cache_v.float())
    out = out.reshape(b, 1, h * hd).to(dt)
    return out @ p["wo"].to(dt), cache_k, cache_v


def cross_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    kv_k: torch.Tensor, kv_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention of x (b, s, d) against the encoder's
    precomputed K/V (b, t, kvh, hd), unmasked and without rope: the flash
    kernel (s_q != s_k) for more than one query under ``attn_impl="flash"``,
    the einsum path at decode."""
    dt = cdtype(cfg)
    b, s, _ = x.shape
    tp = sharding.tp_split(p["wo"], 0)
    if tp is not None:
        # the rank's heads; kv_k, kv_v are init_cross_kv's for them
        hs = _tp_heads(p, cfg, tp, kv=False)
        q = _tp_q(hs, cfg, tp.copy(x), None)
        out = sdpa(cfg, q, kv_k, kv_v, causal=False)
        return _tp_out(hs, cfg, p, out.reshape(b, s, -1), tp)
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.hd)
    out = sdpa(cfg, q, kv_k, kv_v, causal=False)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)


def cross_kv_all(p: Params, cfg: ArchConfig, enc_out: torch.Tensor):
    """(the cross-attention K/V of every KV head (b, t, kvh, hd), those
    the rank's query heads read): :func:`init_cross_kv` twice over on
    one device; over a ``"model"`` axis the first is the cache's and the
    second :func:`cross_attention`'s."""
    tp = sharding.tp_split(p["wo"], 0)
    if tp is None:
        kv = init_cross_kv(p, cfg, enc_out)
        return kv, kv
    k, v = _kv_all(p, cfg, tp.copy(enc_out), None)
    hs = _tp_heads(p, cfg, tp, kv=False)
    return (k, v), (_kv_of_heads(hs, cfg, k), _kv_of_heads(hs, cfg, v))


def init_cross_kv(p: Params, cfg: ArchConfig, enc_out: torch.Tensor):
    """The cross-attention K/V (b, t, kvh, hd) of the encoder output; over
    a ``"model"`` axis those the rank's query heads read."""
    dt = cdtype(cfg)
    b, t, _ = enc_out.shape
    tp = sharding.tp_split(p["wo"], 0)
    if tp is not None:
        return _tp_kv(_tp_heads(p, cfg, tp), cfg, tp.copy(enc_out), None)
    k = (enc_out @ p["wk"].to(dt)).reshape(b, t, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"].to(dt)).reshape(b, t, cfg.n_kv_heads, cfg.hd)
    return k, v


# ------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE with the z-loss regulariser, in float32; with
    ``mask`` the mean over the positions where it is nonzero.  Over a
    ``"model"`` axis, logits narrower than ``vocab`` are the rank's
    vocabulary slice (:func:`vocab_parallel_cross_entropy`)."""
    tp = None if vocab is None else sharding.tp_split(logits, -1)
    if tp is not None:
        return vocab_parallel_cross_entropy(
            logits, labels, mask, z_loss, first=tp.rank * logits.shape[-1],
            psum=tp.sum,
            pmax=lambda t: all_reduce(t, torch.distributed.ReduceOp.MAX,
                                      tp.group))
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 z_loss: float = 1e-4, first=0,
                                 psum=None, pmax=None) -> torch.Tensor:
    """:func:`cross_entropy` of logits split over the vocabulary: this
    part's ``logits`` (..., n) are vocabulary entries [first, first + n),
    ``psum`` sums over the parts (with a gradient) and ``pmax`` takes the
    MAX (without one).  The log-sum-exp is the parts' summed exponentials
    about the global max, the gold logit the one part's that holds the
    label; the padded vocabulary is already masked in the logits.  The
    parts may also lie on a leading axis of one tensor (``first`` then
    broadcasts against ``labels``), for checking on one rank."""
    lf = logits.float()
    lse = _SplitLogSumExp.apply(lf, psum, pmax)
    n = lf.shape[-1]
    local = labels.long() - first
    inside = (local >= 0) & (local < n)
    gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = psum(torch.where(inside, gold, 0.0))
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return torch.mean(nll)
    m = mask.float().expand_as(nll)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


class _SplitLogSumExp(torch.autograd.Function):
    """The log-sum-exp over every part's last axis (the parts' summed
    exponentials about the global max); its backward is
    ``torch.logsumexp``'s, the gradient times exp(x - lse), which the
    parts' replicated gradient of lse gives each part's own slice of."""

    @staticmethod
    def forward(ctx, lf, psum, pmax):
        m = pmax(lf.amax(-1))
        lse = torch.log(psum(torch.exp(lf - m[..., None]).sum(-1))) + m
        ctx.save_for_backward(lf, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        lf, lse = ctx.saved_tensors
        return grad[..., None] * (lf - lse[..., None]).exp(), None, None
