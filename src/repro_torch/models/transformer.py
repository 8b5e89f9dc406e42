"""Decoder-only LM: the dense family of ``repro.models.transformer``.

One model object serves both entry points of the JAX package's model API:

  model = build_model(cfg)                      # DecoderLM on cuda, seeded
  logits, state = model.prefill(tokens, max_len)    # (B, V), KVDecodeState
  logits, state = model.decode_step(tok, state)     # one token per slot
  state = model.init_decode_state(batch, max_len)   # zeroed state

:class:`DecoderLM` is an ``nn.Module`` whose parameters keep the JAX
params nest's names (``embed.table``, ``layers.attn.wq``, ...), the layers
stacked on axis 0 as ``jax.vmap`` init makes them, stored in
``cfg.param_dtype``.  Products run in ``cfg.compute_dtype`` from one copy
of the weights cast at first use (norm params stay float32, which is what
the norms read): the same bits as a cast at every use, without moving the
float32 weights each step.  The copy is made again when a parameter has
changed since: ``load_state_dict``, an in-place update such as an
optimizer's step, or ``model.to(...)``.  Writes through ``param.data``
bypass PyTorch's version counter and are not seen: update parameters in
place under ``torch.no_grad()`` instead.  Prefill attention goes through
:func:`repro_torch.kernels.ops.flash_attention` when
``cfg.attn_impl == "flash"``.

Only ``family == "dense"`` is ported; :func:`build_model` raises
``NotImplementedError`` for the others, which later slices of the port add.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .._device import as_device
from .._tree import tree_map
from ..configs.base import ArchConfig
from .layers import (Params, apply_embed, apply_lm_head, apply_mlp,
                     apply_norm, attention_decode, attention_prefill, cdtype,
                     init_attention, init_embed, init_lm_head, init_mlp,
                     init_norm)

#: the slice of the port that brings each family that is not ported yet
_LATER = {"hybrid": "the hybrid/rwkv slice (ssm_scan)",
          "ssm": "the hybrid/rwkv slice (ssm_scan)",
          "moe": "the MoE/VLM/enc-dec slice",
          "vlm": "the MoE/VLM/enc-dec slice",
          "encdec": "the MoE/VLM/enc-dec slice"}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {_LATER.get(cfg.family, 'a later slice')}")


class KVDecodeState(NamedTuple):
    k: torch.Tensor          # (L, B, T, kvh, hd), compute dtype
    v: torch.Tensor
    pos: torch.Tensor        # (B,) int32: tokens already in the cache


def _block_prefill(p, cfg, x, positions):
    z = apply_norm(p["attn_norm"], cfg, x)
    h, kv = attention_prefill(p["attn"], cfg, z, positions)
    x = x + h
    x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["mlp_norm"], cfg, x))
    return x, kv


def _block_decode(p, cfg, x, ck, cv, pos):
    z = apply_norm(p["attn_norm"], cfg, x)
    h, ck, cv = attention_decode(p["attn"], cfg, z, ck, cv, pos)
    x = x + h
    x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["mlp_norm"], cfg, x))
    return x, ck, cv


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """The params nest of ``build_decoder_lm(cfg).init``, drawn from
    ``gen`` (on ``gen.device``) with the same distributions."""
    L = (cfg.n_layers,)
    params = {"embed": init_embed(gen, cfg),
              "final_norm": init_norm(gen, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(gen, cfg)
    params["layers"] = {"attn_norm": init_norm(gen, cfg, lead=L),
                        "attn": init_attention(gen, cfg, lead=L),
                        "mlp_norm": init_norm(gen, cfg, lead=L),
                        "mlp": init_mlp(gen, cfg, lead=L)}
    return params


class ParamNest(nn.Module):
    """A nest of parameters that indexes like the JAX params dict:
    ``p["attn"]["wq"]``, ``"b_up" in p``."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamNest(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def param_tree(self) -> Params:
        """The nest as plain dicts of tensors (parameter data, no copies),
        under the JAX package's names and shapes."""
        out = {n: p.data for n, p in self._parameters.items()}
        out.update({n: m.param_tree() for n, m in self._modules.items()})
        return out


def _cast_weights(tree: Params, dt: torch.dtype) -> Params:
    """Every leaf cast to ``dt``, except under norms (read in float32)."""
    return {k: v if k.endswith("norm")
            else _cast_weights(v, dt) if isinstance(v, dict) else v.to(dt)
            for k, v in tree.items()}


class DecoderLM(ParamNest):
    """The dense decoder LM over a params nest (see the module docstring);
    its top-level children are the nest's ``embed``, ``final_norm``,
    ``lm_head`` (untied only) and ``layers``."""

    def __init__(self, cfg: ArchConfig, params: Params):
        _check_family(cfg)
        want = {"embed", "final_norm", "layers"} | (
            set() if cfg.tie_embeddings else {"lm_head"})
        if set(params) != want:
            raise ValueError(f"{cfg.name}: params nest has {sorted(params)}, "
                             f"expected {sorted(want)}")
        super().__init__(params)
        self.cfg = cfg
        self._compute: Optional[Tuple[Params, List[Params]]] = None
        self._compute_key: Optional[Tuple] = None

    @property
    def device(self) -> torch.device:
        return self["embed"]["table"].device

    def _params_key(self) -> Tuple:
        # storage, version counter, dtype and device of every parameter:
        # changes when one is replaced, moved or updated in place
        return tuple((p.data_ptr(), p._version, p.dtype, p.device)
                     for p in self.parameters())

    def compute_params(self) -> Tuple[Params, List[Params]]:
        """(whole nest, per-layer nests) in the compute dtype, made at first
        use and again whenever a parameter has changed since."""
        key = self._params_key()
        if key != self._compute_key:
            tree = _cast_weights(self.param_tree(), cdtype(self.cfg))
            layers = [tree_map(lambda a, i=i: a[i], tree["layers"])
                      for i in range(self.cfg.n_layers)]
            self._compute, self._compute_key = (tree, layers), key
        return self._compute

    def init_decode_state(self, batch_size: int,
                          max_len: int) -> KVDecodeState:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        dt, dev = cdtype(cfg), self.device
        return KVDecodeState(
            k=torch.zeros(shape, dtype=dt, device=dev),
            v=torch.zeros(shape, dtype=dt, device=dev),
            pos=torch.zeros((batch_size,), dtype=torch.int32, device=dev))

    def _logits(self, P: Params, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(P["final_norm"], self.cfg, x)
        return apply_lm_head(P.get("lm_head"), self.cfg, x,
                             embed=P["embed"])[:, 0]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVDecodeState]:
        """tokens (B, S) -> (logits of the last position (B, V), the decode
        state with the prompt's K/V in slots 0..S-1 of ``max_len``)."""
        cfg = self.cfg
        P, layers = self.compute_params()
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        max_len = s if max_len is None else int(max_len)
        if max_len < s:
            raise ValueError(f"max_len {max_len} < prompt length {s}")
        x = apply_embed(P["embed"], cfg, tokens)
        positions = torch.arange(s, device=self.device).expand(b, s)
        state = self.init_decode_state(b, max_len)
        for i, lp in enumerate(layers):
            x, (k, v) = _block_prefill(lp, cfg, x, positions)
            state.k[i, :, :s] = k
            state.v[i, :, :s] = v
        logits = self._logits(P, x[:, -1:])
        return logits, state._replace(
            pos=torch.full((b,), s, dtype=torch.int32, device=self.device))

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: KVDecodeState
                    ) -> Tuple[torch.Tensor, KVDecodeState]:
        """tok (B,) -> (logits (B, V), the next state).  The new K/V are
        written into ``state``'s caches in place; the returned state shares
        them and holds ``pos + 1``."""
        cfg = self.cfg
        P, layers = self.compute_params()
        tok = torch.as_tensor(tok, device=self.device)
        x = apply_embed(P["embed"], cfg, tok[:, None])
        for i, lp in enumerate(layers):
            x, _, _ = _block_decode(lp, cfg, x, state.k[i], state.v[i],
                                    state.pos)
        return self._logits(P, x), state._replace(pos=state.pos + 1)


def build_model(cfg: ArchConfig, device="cuda", seed: int = 0) -> DecoderLM:
    """A :class:`DecoderLM` for ``cfg`` with params drawn from a generator
    seeded with ``seed``, on ``device``."""
    _check_family(cfg)
    dev = as_device(device, "model")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return DecoderLM(cfg, init_params(cfg, gen))
