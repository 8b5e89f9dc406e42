"""Whisper-style encoder-decoder LM (the audio frontend is a stub).

The port of ``repro.models.encdec``.  As there, the conv frontend is not
modelled: the encoder takes precomputed frame embeddings (B, n_frames,
d_model).  The encoder is bidirectional self-attention; the decoder is
causal self-attention, cross-attention and GELU MLPs, with LayerNorm and
biases and sinusoidal positions instead of rope, the whisper flavour.

Params (the JAX package's names): ``embed``, ``enc_norm``, ``dec_norm``,
``lm_head``, and the lists ``enc`` (``attn_norm``, ``attn``, ``mlp_norm``,
``mlp`` a layer) and ``dec`` (the same with ``xattn_norm`` and ``xattn``),
one nest a layer.  Decode state :class:`EncDecState`: the decoder's
self-attention K/V caches and the cross-attention K/V, computed once at
prefill from the encoder output.

With sequence parallelism the encoder's frames and the decoder's tokens
each split over ``"model"`` where the axis divides their length (whisper
-base's 1500 frames on 16 ranks do not), and the decoder's
cross-attention reads the encoder output whole.

Attention goes through the flash kernel under ``attn_impl="flash"``
wherever more than one query attends: the encoder (unmasked), the
decoder's prefill (causal) and its cross-attention at prefill (the prompt
against every frame, s_q != s_k).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import (Params, apply_attention, apply_embed, apply_lm_head,
                     apply_mlp, apply_norm, attention_decode,
                     attention_prefill, cdtype, cross_attention, cross_decode,
                     cross_kv_all, init_attention, init_cross_kv, init_embed,
                     init_lm_head, init_mlp, init_norm, model_part,
                     write_prompt)
from .sharding import seq_split, sequence
from .transformer import _LM, whole_vocab

LN = "layernorm"


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) float32 sinusoidal embeddings of the positions ``pos``:
    sin then cos of pos / 10000^(2 i / d), i < d / 2."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    angle = pos.float()[..., None] / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32: the embeddings of positions 0..length-1."""
    return _sinusoid_at(torch.arange(length, device=device), d)


class EncDecState(NamedTuple):
    self_k: torch.Tensor      # (L, B, T, kvh, hd) compute dtype
    self_v: torch.Tensor
    cross_k: torch.Tensor     # (L, B, F, kvh, hd) compute dtype
    cross_v: torch.Tensor
    pos: torch.Tensor         # (B,) int32


def _ln(p, cfg, x):
    return apply_norm(p, cfg, x, kind=LN)


def _enc_block(lp, cfg, positions, h):
    h = h + apply_attention(lp["attn"], cfg, _ln(lp["attn_norm"], cfg, h),
                            positions, causal=False)
    return h + apply_mlp(lp["mlp"], cfg, _ln(lp["mlp_norm"], cfg, h))


def _dec_tail(lp, cfg, x, kx, vx):
    """The decoder block after its self-attention: cross-attention over
    (kx, vx), then the MLP."""
    x = x + cross_attention(lp["xattn"], cfg, _ln(lp["xattn_norm"], cfg, x),
                            kx, vx)
    return x + apply_mlp(lp["mlp"], cfg, _ln(lp["mlp_norm"], cfg, x))


class EncDecLM(_LM):
    """The whisper-style encoder-decoder over a params nest (see the module
    docstring)."""

    FAMILIES = ("encdec",)
    CAST = frozenset({"embed", "lm_head", "enc.attn", "enc.mlp", "dec.attn",
                      "dec.xattn", "dec.mlp"})
    STACKED = False

    @staticmethod
    def param_names(cfg):
        return {"embed", "enc_norm", "dec_norm", "lm_head", "enc", "dec"}

    @staticmethod
    def init(cfg: ArchConfig, gen: torch.Generator) -> Params:
        """The params nest of the JAX ``build_encdec(cfg).init``, drawn from
        ``gen`` with the same distributions: LayerNorm, GELU MLPs with
        biases."""
        enc = [{"attn_norm": init_norm(gen, cfg, kind=LN),
                "attn": init_attention(gen, cfg),
                "mlp_norm": init_norm(gen, cfg, kind=LN),
                "mlp": init_mlp(gen, cfg, bias=True)}
               for _ in range(cfg.enc_layers)]
        dec = [{"attn_norm": init_norm(gen, cfg, kind=LN),
                "attn": init_attention(gen, cfg),
                "xattn_norm": init_norm(gen, cfg, kind=LN),
                "xattn": init_attention(gen, cfg),
                "mlp_norm": init_norm(gen, cfg, kind=LN),
                "mlp": init_mlp(gen, cfg, bias=True)}
               for _ in range(cfg.n_layers)]
        return {"embed": init_embed(gen, cfg),
                "enc_norm": init_norm(gen, cfg, kind=LN),
                "dec_norm": init_norm(gen, cfg, kind=LN),
                "lm_head": init_lm_head(gen, cfg),
                "enc": enc, "dec": dec}

    def _encode(self, P: Params, frames) -> torch.Tensor:
        """The encoder output; where it runs on a split sequence the
        frames' slices are gathered for the decoder: with their parts of
        the gradient summed (reduce-scattered) where the decoder's
        sequence is split too, else as whole values (the rank's block of
        the whole gradient kept)."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(cdtype(cfg))
        b, f = x.shape[:2]
        x = x + _sinusoid(f, cfg.d_model, self.device).to(x.dtype)[None]
        positions = torch.arange(f, device=self.device).expand(b, f)
        # cfg.remat applies where a gradient is built (loss_fn)
        remat = self._remat if torch.is_grad_enabled() else (lambda fn: fn)
        split = seq_split() is not None
        with sequence(f):
            sp = seq_split()
            if sp is not None:
                x = sp.own(x)
            for lp in P["enc"]:
                x = remat(lambda h, lp=lp: _enc_block(self._use(lp), cfg,
                                                      positions, h))(x)
            x = _ln(self._use(P["enc_norm"]), cfg, x)
        if sp is not None:
            return (sp.enter(x) if split else
                    sp.gather_out(x.contiguous(), 1))
        if split:
            # whole on every rank: each rank's decoder adds its part
            return seq_split().enter_whole(x)
        return x

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """frames (B, F, d), the stub frontend's embeddings -> the encoder
        output (B, F, d) in the compute dtype."""
        return self._encode(self.compute_params()[0], frames)

    def _embed(self, P: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = apply_embed(P["embed"], self.cfg, tokens)
        pe = _sinusoid(tokens.shape[1], self.cfg.d_model, self.device)[None]
        sp = seq_split()
        return x + (pe if sp is None else sp.own(pe)).to(x.dtype)

    def _logits(self, P: Params, x: torch.Tensor,
                tail: Optional[int] = None) -> torch.Tensor:
        return apply_lm_head(P["lm_head"], self.cfg,
                             _ln(P["dec_norm"], self.cfg, x), tail=tail)

    def _use_top(self, P: Params) -> Params:
        """``P`` with its decoder-side top-level leaves taken (the
        encoder's norm is taken where the encoder runs)."""
        return dict(P, **self._use({k: v for k, v in P.items()
                                    if k not in ("enc", "dec", "enc_norm")}))

    def loss_fn(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce": loss}) of the JAX enc-dec ``loss_fn`` on ``batch``
        (``frames`` (B, F, d), ``tokens``, ``labels`` (B, S) int32, optional
        ``loss_mask``), each encoder and decoder layer under
        ``cfg.remat``."""
        P, _ = self.train_params()
        tokens = self._batch_tensor(batch, "tokens")
        cfg = self.cfg
        with sequence(tokens.shape[1]):
            P = self._use_top(P)
            enc_out = self._encode(P, self._batch_tensor(batch, "frames"))
            b, s = tokens.shape
            x = self._embed(P, tokens)
            positions = torch.arange(s, device=self.device).expand(b, s)

            def dec_block(lp, h):
                lp = self._use(lp)
                h = h + apply_attention(lp["attn"], cfg,
                                        _ln(lp["attn_norm"], cfg, h),
                                        positions, causal=True)
                return _dec_tail(lp, cfg, h, *init_cross_kv(lp["xattn"], cfg,
                                                            enc_out))

            for lp in P["dec"]:
                x = self._remat(lambda h, lp=lp: dec_block(lp, h))(x)
            loss = self._ce(self._logits(P, x), batch)
            return loss, {"ce": loss}

    def init_decode_state(self, batch_size: int,
                          max_len: int) -> EncDecState:
        cfg = self.cfg
        dt, dev = cdtype(cfg), self.device
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        xkv = (cfg.n_layers, batch_size, max(cfg.n_frames, 1),
               cfg.n_kv_heads, cfg.hd)
        return EncDecState(
            self_k=torch.zeros(kv, dtype=dt, device=dev),
            self_v=torch.zeros(kv, dtype=dt, device=dev),
            cross_k=torch.zeros(xkv, dtype=dt, device=dev),
            cross_v=torch.zeros(xkv, dtype=dt, device=dev),
            pos=self._pos(batch_size, 0))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, EncDecState]:
        """Encode ``frames`` (B, F, d), then prefill the decoder on the
        prompt ``tokens`` (B, S): (logits of the last position (B, V), the
        decode state with the prompt's K/V in slots 0..S-1 of ``max_len``
        and every layer's cross K/V of the F frames)."""
        tokens, max_len = self._prompt(tokens, max_len)
        cfg = self.cfg
        with sequence(tokens.shape[1]):
            P, _ = self.serve_params()
            P = self._use_top(P)
            enc_out = self._encode(P, frames)
            b, s = tokens.shape
            x = self._embed(P, tokens)
            positions = torch.arange(s, device=self.device).expand(b, s)
            f = enc_out.shape[1]
            state = self._new_state(b, max_len)
            if state.cross_k.shape[2] != f:       # frames other than n_frames
                shape = (cfg.n_layers, b, f, cfg.n_kv_heads, cfg.hd)
                state = state._replace(cross_k=state.cross_k.new_zeros(shape),
                                       cross_v=state.cross_v.new_zeros(shape))
            lay, lay_x = (self._state_layout(n)
                          for n in ("self_k", "cross_k"))
            for i, lp in enumerate(P["dec"]):
                lp = self._use(lp)
                z = _ln(lp["attn_norm"], cfg, x)
                h, (k, v) = attention_prefill(lp["attn"], cfg, z, positions)
                write_prompt(state.self_k[i], k, lay)
                write_prompt(state.self_v[i], v, lay)
                (kx, vx), heads = cross_kv_all(lp["xattn"], cfg, enc_out)
                state.cross_k[i] = model_part(kx, lay_x)
                state.cross_v[i] = model_part(vx, lay_x)
                x = _dec_tail(lp, cfg, x + h, *heads)
            logits = whole_vocab(self._logits(P, *self._tail(x, 1)))[:, 0]
            return logits, state._replace(pos=self._pos(b, s))

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: EncDecState
                    ) -> Tuple[torch.Tensor, EncDecState]:
        """tok (B,) -> (logits (B, V), the next state); the token's
        sinusoidal position is ``state.pos``."""
        cfg = self.cfg
        P, _ = self.serve_params()
        P = self._use_top(P)
        tok = torch.as_tensor(tok, device=self.device)
        x = apply_embed(P["embed"], cfg, tok[:, None])
        x = x + _sinusoid_at(state.pos, cfg.d_model)[:, None].to(x.dtype)
        lay, lay_x = (self._state_layout(n) for n in ("self_k", "cross_k"))
        for i, lp in enumerate(P["dec"]):
            lp = self._use(lp)
            z = _ln(lp["attn_norm"], cfg, x)
            h, _, _ = attention_decode(lp["attn"], cfg, z, state.self_k[i],
                                       state.self_v[i], state.pos, lay)
            x = x + h
            x = x + cross_decode(lp["xattn"], cfg,
                                 _ln(lp["xattn_norm"], cfg, x),
                                 state.cross_k[i], state.cross_v[i], lay_x)
            x = x + apply_mlp(lp["mlp"], cfg, _ln(lp["mlp_norm"], cfg, x))
        return (whole_vocab(self._logits(P, x))[:, 0],
                state._replace(pos=state.pos + 1))
