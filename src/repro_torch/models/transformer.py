"""The port's LMs: the dense, MoE, VLM, hybrid (zamba2), RWKV6 and
encoder-decoder families of ``repro.models.transformer`` and
``repro.models.encdec``.

One model object per family serves the JAX package's model API:

  model = build_model(cfg)                          # on cuda, seeded
  loss, metrics = model.loss_fn(batch)              # train: {"ce", ...}
  logits, state = model.prefill(tokens, max_len)    # (B, V), decode state
  logits, state = model.decode_step(tok, state)     # one token per slot
  state = model.init_decode_state(batch, max_len)   # zeroed state

Each family is an ``nn.Module`` whose parameters keep the JAX params
nest's names, the layers stacked on axis 0 as ``jax.vmap`` init makes them
(the encoder-decoder's are lists, one nest a layer, as the JAX package
keeps them), stored in ``cfg.param_dtype``:

- :class:`DecoderLM` (``family`` ``"dense"``, ``"moe"`` or ``"vlm"``):
  ``embed``, ``final_norm``, ``lm_head`` (untied only),
  ``layers.{attn_norm, attn, mlp_norm, mlp}``, with ``layers.moe`` (the
  router, the experts and the optional shared expert, :mod:`.moe`) in
  place of ``layers.mlp`` for MoE configs, and ``vision_proj`` for the VLM,
  whose ``prefill`` and ``loss_fn`` put the projected ``patch_embeds``
  (B, n_patches, d) before the token embeddings; state
  :class:`KVDecodeState`.  The MoE loss is ``ce + 0.01 aux``.
- :class:`HybridLM` (``"hybrid"``, zamba2): ``embed``, ``final_norm``,
  ``lm_head``, ``shared.{attn_norm, attn, mlp_norm, mlp}``,
  ``layers.{norm, mamba}``.  One shared attention + MLP block runs before
  the Mamba2 block of every ``shared_attn_period``-th layer, each
  invocation with its own K/V cache; state :class:`HybridDecodeState`.
- :class:`RWKVLM` (``"ssm"``, rwkv6): ``embed``, ``final_norm``
  (layernorm), ``lm_head``, ``layers.{ln1, time, ln2, chan}``; state
  :class:`RWKVDecodeState`.
- :class:`~repro_torch.models.encdec.EncDecLM` (``"encdec"``, whisper):
  see :mod:`.encdec`.

The parameters are trainable (``requires_grad``): ``loss_fn`` builds its
graph on them and ``loss.backward()`` leaves each gradient in ``.grad``
(:mod:`repro_torch.train` reads them there).  ``loss_fn`` casts ``CAST``'s
leaves inside the graph on every call, and applies ``cfg.remat`` where the
JAX package applies ``_remat``: per layer with
``torch.utils.checkpoint.checkpoint`` for the decoder families and the
hybrid, and for RWKV6 under ``cfg.scan_layers``.

Prefill and decode run under ``torch.no_grad()``.  Their products run in
``cfg.compute_dtype`` from one copy of the weights cast at first use:
exactly the leaves the JAX package casts with ``.astype`` to the compute
dtype where it reads them (each class's ``CAST``).  Every other
leaf stays as stored, because the JAX code reads it in float32 or the param
dtype: norm params, the MoE router, Mamba2's ``A_log``, ``D``,
``dt_bias`` and ``norm_scale``, RWKV6's ``w0``, ``w_lora_a``,
``w_lora_b``, ``u`` and ``ln_x_scale``.  That gives the bits of a cast at
every use without moving the float32 weights each step.  The copy is made
again when a parameter has changed since: ``load_state_dict``, an
in-place update such as an optimizer's step, or ``model.to(...)``.  Writes
through ``param.data`` bypass PyTorch's version counter and are not seen:
update parameters in place under ``torch.no_grad()`` instead.

``decode_step`` writes the new state into the given state's buffers in
place and returns a state that shares them, with ``pos + 1``.  Buffers keep
the dtypes of ``init_decode_state``: the hybrid's ``mamba_conv`` stays
float32 where the JAX package's decode returns it in the compute dtype; the
values are the same (a bfloat16 value is exact in float32).

Prefill attention goes through :func:`repro_torch.kernels.ops.flash_attention`
when ``cfg.attn_impl == "flash"``, and the Mamba2 and RWKV6 prefill through
:func:`repro_torch.kernels.ops.ssm_scan`.  :func:`model_class` raises
``ValueError`` for a family it does not know.
"""
from __future__ import annotations

import contextvars
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import as_device
from .._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..configs.base import ArchConfig
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .sharding import (LeafRef, materialize, seq_split, sequence, shard_run,
                       tp)
from .layers import (Params, apply_attention, apply_embed, apply_lm_head,
                     apply_mlp, apply_norm, attention_decode,
                     attention_prefill, cdtype, cross_entropy,
                     init_attention, init_embed, init_lm_head, init_mlp,
                     init_norm, MetaSource, model_part, pdtype, randn,
                     write_prompt)

class ParamNest(nn.Module):
    """A nest of parameters that indexes like the JAX params nest:
    ``p["attn"]["wq"]``, ``"b_up" in p``, and ``p["enc"][0]`` for a list
    of nests (its children named "0", "1", ...)."""

    def __init__(self, tree):
        super().__init__()
        self.is_list = isinstance(tree, (list, tuple))
        for name, val in (enumerate(tree) if self.is_list else tree.items()):
            if isinstance(val, (dict, list, tuple)):
                self.add_module(str(name), ParamNest(val))
            else:
                self.register_parameter(str(name),
                                        nn.Parameter(val.detach()))

    def __getitem__(self, name):
        name = str(name)
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def _nest(self, out: Dict):
        return [out[str(i)] for i in range(len(out))] if self.is_list else out

    def param_tree(self) -> Params:
        """The nest as plain dicts (and lists) of tensors (parameter data,
        no copies), under the JAX package's names and shapes."""
        out = {n: p.data for n, p in self._parameters.items()}
        out.update({n: m.param_tree() for n, m in self._modules.items()})
        return self._nest(out)

    def trainable_tree(self) -> Params:
        """The nest of the parameters themselves, under the JAX package's
        names: what a loss is built on and an optimizer updates."""
        out = dict(self._parameters)
        out.update({n: m.trainable_tree() for n, m in self._modules.items()})
        return self._nest(out)


def _cast_tree(tree, dt, cast: frozenset, prefix: str = "",
               fn: Optional[Callable] = None):
    """``tree`` with every leaf whose dotted name is, or lies under, one of
    the names in ``cast`` cast to ``dt``; everything else kept as it is.  A
    list's items take the list's own name (``enc.attn`` names the
    ``attn`` of every layer in ``enc``).  ``fn(leaf, dtype or None)``,
    when given, replaces the cast."""
    fn = fn or (lambda a, d: a if d is None else a.to(d))
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dt, cast, prefix, fn) for v in tree]
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if any(name == c or name.startswith(c + ".") for c in cast):
            out[k] = tree_map(lambda a: fn(a, dt), v)
        elif isinstance(v, (dict, list, tuple)):
            out[k] = _cast_tree(v, dt, cast, name + ".", fn)
        else:
            out[k] = fn(v, None)
    return out


class _LM(ParamNest):
    """What the families share: the params nest, its check against the
    family's names, and the compute-dtype copy.  Each family's class sets
    ``FAMILIES`` and ``CAST`` and defines ``param_names(cfg)`` (the
    nest's top-level names) and ``init(cfg, gen)``."""

    #: the config families the class serves
    FAMILIES: Tuple[str, ...] = ()
    #: the dotted names (leaves or subtrees) the compute copy casts
    CAST: frozenset = frozenset()
    #: whether the layers are stacked on axis 0 under ``layers``
    STACKED = True

    def __init__(self, cfg: ArchConfig, params: Params):
        if cfg.family not in self.FAMILIES:
            raise ValueError(
                f"{type(self).__name__} serves family "
                f"{' or '.join(map(repr, self.FAMILIES))}, not "
                f"{cfg.family!r}")
        want = self.param_names(cfg)
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
        """(whole nest, per-layer nests of the stack: none where the layers
        are not stacked) with ``CAST``'s leaves in the compute dtype, made
        at first use and again whenever a parameter has changed since."""
        key = self._params_key()
        if key != self._compute_key:
            tree = _cast_tree(self.param_tree(), cdtype(self.cfg), self.CAST)
            layers = [tree_map(lambda a, i=i: a[i], tree["layers"])
                      for i in range(self.cfg.n_layers)] if self.STACKED \
                else []
            self._compute, self._compute_key = (tree, layers), key
        return self._compute

    def train_params(self) -> Tuple[Params, List[Params]]:
        """(whole nest, per-layer nests) of the trainable parameters with
        ``CAST``'s leaves cast to the compute dtype inside the graph, so the
        gradient reaches the stored parameters.  The layers are unbound from
        their stack once: the backward stacks their gradients once.

        In a mesh step (an active :class:`~repro_torch.models.sharding.
        ShardRun`) the leaves that an FSDP axis splits are
        :class:`~repro_torch.models.sharding.LeafRef` s of the rank's
        shards instead, gathered and cast where :meth:`_use` takes them, at
        their layer; the others are cast here, as on one device."""
        leaves, struct = tree_flatten(self.trainable_tree())
        dtypes = [d or None for d in tree_leaves(_cast_tree(
            tree_unflatten(struct, list(range(len(leaves)))),
            cdtype(self.cfg), self.CAST, fn=lambda a, d: d or ""))]
        run = shard_run()
        if run is None:
            tree = tree_unflatten(struct, [p if d is None else p.to(d)
                                           for p, d in zip(leaves, dtypes)])
        else:
            tree = tree_unflatten(struct, run.refs(leaves, dtypes))
        if not self.STACKED:
            return tree, []
        leaves, structure = tree_flatten(tree["layers"])
        index = tree_leaves(tree_unflatten(struct, list(range(len(dtypes))))
                            ["layers"])
        cols = [leaf.unbind(0) if run is None else
                run.layer_refs(leaf) if isinstance(leaf, LeafRef) else
                run.layer_views(leaf, i) for leaf, i in zip(leaves, index)]
        layers = [tree_unflatten(structure, [c[i] for c in cols])
                  for i in range(self.cfg.n_layers)]
        return tree, layers

    def serve_params(self) -> Tuple[Params, List[Params]]:
        """What prefill and decode compute with: :meth:`compute_params`,
        or in a mesh step (an active ShardRun) :meth:`train_params`, the
        rank's blocks, each layer's taken through :meth:`_use` where it
        runs."""
        return (self.compute_params() if shard_run() is None
                else self.train_params())

    def _new_state(self, batch_size: int, max_len: int):
        """A zeroed decode state: :meth:`init_decode_state`, or on a
        serving mesh the rank's part of the state the mesh serves."""
        run = shard_run()
        if run is None or run.state_layouts is None:
            return self.init_decode_state(batch_size, max_len)
        return run.init_state()

    @staticmethod
    def _state_layout(name: str):
        """One layer's layout of the decode state's leaf ``name`` on a
        serving mesh, else None."""
        run = shard_run()
        return None if run is None else run.state_layout(name)

    @staticmethod
    def _use(tree):
        """``tree`` as its layer computes with it: in a mesh step, each
        leaf gathered over the FSDP axes and cast (call it where the layer
        runs, inside its checkpointed function); else ``tree`` itself."""
        return materialize(tree)

    def _remat(self, fn: Callable) -> Callable:
        """``fn`` under ``cfg.remat``, as the JAX package's ``_remat``:
        ``"none"`` saves what autograd saves; ``"full"`` keeps only the
        layer's input and runs the layer again in the backward.  ``"dots"``
        does the same as ``"full"``: PyTorch has no counterpart of JAX's
        dots-saveable policy (keep the matmul outputs, recompute the
        rest)."""
        if self.cfg.remat == "none":
            return fn

        def run(*args):
            # the recompute runs in the backward, which on the card runs on
            # autograd's device thread, where context variables (the MoE's
            # expert group) are unset: recompute in the forward's context
            ctx = contextvars.copy_context()
            return checkpoint(ctx.run, fn, *args, use_reentrant=False)
        return run

    @staticmethod
    def _tail(x: torch.Tensor, n: int):
        """(the stream ``x`` for the LM head, the positions the head keeps):
        the last ``n`` positions cut here, or with the sequence split over
        ``"model"`` cut by the head once gathered
        (:func:`.layers.apply_lm_head`)."""
        if seq_split() is None:
            return x[:, -n:], None
        return x, n

    def _batch_tensor(self, batch, key: str) -> Optional[torch.Tensor]:
        v = batch.get(key)
        return None if v is None else torch.as_tensor(v, device=self.device)

    def _ce(self, logits: torch.Tensor, batch) -> torch.Tensor:
        """The training CE; over a ``"model"`` axis the logits are the
        rank's vocabulary slice
        (:func:`.layers.vocab_parallel_cross_entropy`)."""
        return cross_entropy(logits, self._batch_tensor(batch, "labels"),
                             self._batch_tensor(batch, "loss_mask"),
                             vocab=self.cfg.padded_vocab)

    def _prompt(self, tokens, max_len: Optional[int], prefix: int = 0):
        """The prompt on the model's device and the cache length: at least
        the ``prefix`` positions before the prompt and the prompt."""
        tokens = torch.as_tensor(tokens, device=self.device)
        s = prefix + tokens.shape[1]
        max_len = s if max_len is None else int(max_len)
        if max_len < s:
            raise ValueError(f"max_len {max_len} < prompt length {s}")
        return tokens, max_len

    def _pos(self, b: int, value: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.int32, device=self.device)


# ===================================================================== dense
class KVDecodeState(NamedTuple):
    k: torch.Tensor          # (L, B, T, kvh, hd), compute dtype
    v: torch.Tensor
    pos: torch.Tensor        # (B,) int32: tokens already in the cache


def _ffn(p, cfg, z):
    """The block's FFN on z: the MoE layer's output and auxiliary loss
    where the config has experts, else the MLP's output and None."""
    if cfg.is_moe:
        out = moe_mod.apply_moe(p["moe"], cfg, z)
        return out.y, out.aux_loss
    return apply_mlp(p["mlp"], cfg, z), None


def _block_prefill(p, cfg, x, positions):
    z = apply_norm(p["attn_norm"], cfg, x)
    h, kv = attention_prefill(p["attn"], cfg, z, positions)
    x = x + h
    x = x + _ffn(p, cfg, apply_norm(p["mlp_norm"], cfg, x))[0]
    return x, kv


def _block_decode(p, cfg, x, ck, cv, pos, lay=None):
    z = apply_norm(p["attn_norm"], cfg, x)
    h, ck, cv = attention_decode(p["attn"], cfg, z, ck, cv, pos, lay)
    x = x + h
    x = x + _ffn(p, cfg, apply_norm(p["mlp_norm"], cfg, x))[0]
    return x, ck, cv


def _block_train(p, cfg, positions, x):
    """(the block's output, its auxiliary loss: 0 without experts)."""
    h = apply_attention(p["attn"], cfg, apply_norm(p["attn_norm"], cfg, x),
                        positions, causal=True)
    x = x + h
    y, aux = _ffn(p, cfg, apply_norm(p["mlp_norm"], cfg, x))
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return x + y, aux


class DecoderLM(_LM):
    """The dense, MoE and VLM decoder LM over a params nest (see the
    module docstring)."""

    FAMILIES = ("dense", "moe", "vlm")
    CAST = frozenset({"embed", "lm_head", "layers.attn", "layers.mlp",
                      "layers.moe.w_gate", "layers.moe.w_up",
                      "layers.moe.w_down", "layers.moe.shared",
                      "vision_proj"})

    @staticmethod
    def param_names(cfg):
        return {"embed", "final_norm", "layers"} | (
            set() if cfg.tie_embeddings else {"lm_head"}) | (
            {"vision_proj"} if cfg.family == "vlm" else set())

    @staticmethod
    def init(cfg: ArchConfig, gen: torch.Generator) -> Params:
        """The params nest of the JAX ``build_decoder_lm(cfg).init``, drawn
        from ``gen`` (on ``gen.device``) with the same distributions."""
        L = (cfg.n_layers,)
        params = {"embed": init_embed(gen, cfg),
                  "final_norm": init_norm(gen, cfg)}
        if not cfg.tie_embeddings:
            params["lm_head"] = init_lm_head(gen, cfg)
        params["layers"] = {"attn_norm": init_norm(gen, cfg, lead=L),
                            "attn": init_attention(gen, cfg, lead=L),
                            "mlp_norm": init_norm(gen, cfg, lead=L)}
        if cfg.is_moe:
            params["layers"]["moe"] = moe_mod.init_moe(gen, cfg, lead=L)
        else:
            params["layers"]["mlp"] = init_mlp(gen, cfg, lead=L)
        if cfg.family == "vlm":
            # N(0, 1) * 0.02, cast to the param dtype before the scale
            w = randn(gen, (cfg.d_model, cfg.d_model)).to(pdtype(cfg))
            params["vision_proj"] = {"w": w * 0.02}
        return params

    def init_decode_state(self, batch_size: int,
                          max_len: int) -> KVDecodeState:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        dt, dev = cdtype(cfg), self.device
        return KVDecodeState(
            k=torch.zeros(shape, dtype=dt, device=dev),
            v=torch.zeros(shape, dtype=dt, device=dev),
            pos=self._pos(batch_size, 0))

    def _head(self, P: Params, x: torch.Tensor,
              tail: Optional[int] = None) -> torch.Tensor:
        x = apply_norm(P["final_norm"], self.cfg, x)
        return apply_lm_head(P.get("lm_head"), self.cfg, x, embed=P["embed"],
                             tail=tail)

    def _logits(self, P: Params, x: torch.Tensor) -> torch.Tensor:
        """The last position's logits (B, V) of the stream ``x``."""
        return whole_vocab(self._head(P, *self._tail(x, 1)))[:, 0]

    def _embed_inputs(self, P: Params, tokens: torch.Tensor,
                      patch_embeds) -> torch.Tensor:
        """The token embeddings, after the projected patch embeddings for
        the VLM."""
        cfg = self.cfg
        if cfg.family != "vlm":
            return apply_embed(P["embed"], cfg, tokens)
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: the VLM needs patch_embeds "
                             f"(B, n_patches, d)")
        dt = cdtype(cfg)
        pe = torch.as_tensor(patch_embeds, device=self.device).to(dt)
        return apply_embed(P["embed"], cfg, tokens,
                           prefix=pe @ P["vision_proj"]["w"].to(dt))

    @staticmethod
    def _prefix_len(patch_embeds) -> int:
        return 0 if patch_embeds is None else patch_embeds.shape[1]

    def loss_fn(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(ce + 0.01 aux, {"ce", "aux"}) of the JAX decoder ``loss_fn`` on
        ``batch`` (``tokens``, ``labels`` (B, S) int32, optional
        ``loss_mask``, and ``patch_embeds`` for the VLM): the mean
        next-token CE with z-loss, over the text positions; ``aux`` is the
        MoE layers' load-balancing loss summed over layers, 0 without
        experts."""
        cfg = self.cfg
        P, layers = self.train_params()
        tokens = self._batch_tensor(batch, "tokens")
        b, s = tokens.shape
        t_all = self._prefix_len(batch.get("patch_embeds")) + s
        with sequence(t_all):
            P = self._use({k: v for k, v in P.items() if k != "layers"})
            x = self._embed_inputs(P, tokens, batch.get("patch_embeds"))
            positions = torch.arange(t_all,
                                     device=self.device).expand(b, t_all)
            aux = torch.zeros((), device=self.device)
            for lp in layers:
                x, a = self._remat(lambda h, lp=lp: _block_train(
                    self._use(lp), cfg, positions, h))(x)
                aux = aux + a
            loss = self._ce(self._head(P, *self._tail(x, s)), batch)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVDecodeState]:
        """tokens (B, S) -> (logits of the last position (B, V), the decode
        state with the prompt's K/V in slots 0..S-1 of ``max_len``).  The
        VLM takes ``patch_embeds`` (B, n_patches, d) too: they fill the
        first n_patches slots and the prompt the S after them."""
        cfg = self.cfg
        P, layers = self.serve_params()
        n_pre = self._prefix_len(patch_embeds)
        tokens, max_len = self._prompt(tokens, max_len, n_pre)
        b, s = tokens.shape[0], n_pre + tokens.shape[1]
        with sequence(s):
            P = self._use({k: v for k, v in P.items() if k != "layers"})
            x = self._embed_inputs(P, tokens, patch_embeds)
            positions = torch.arange(s, device=self.device).expand(b, s)
            state = self._new_state(b, max_len)
            lay = self._state_layout("k")
            for i, lp in enumerate(layers):
                x, (k, v) = _block_prefill(self._use(lp), cfg, x, positions)
                write_prompt(state.k[i], k, lay)
                write_prompt(state.v[i], v, lay)
            logits = self._logits(P, x)
        return logits, state._replace(pos=self._pos(b, s))

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: KVDecodeState
                    ) -> Tuple[torch.Tensor, KVDecodeState]:
        """tok (B,) -> (logits (B, V), the next state)."""
        cfg = self.cfg
        P, layers = self.serve_params()
        P = self._use({k: v for k, v in P.items() if k != "layers"})
        tok = torch.as_tensor(tok, device=self.device)
        x = apply_embed(P["embed"], cfg, tok[:, None])
        lay = self._state_layout("k")
        for i, lp in enumerate(layers):
            x, _, _ = _block_decode(self._use(lp), cfg, x, state.k[i],
                                    state.v[i], state.pos, lay)
        return self._logits(P, x), state._replace(pos=state.pos + 1)


# ==================================================================== hybrid
class HybridDecodeState(NamedTuple):
    mamba_h: torch.Tensor     # (L, B, heads, d_state, SSM_HEAD) float32
    mamba_conv: torch.Tensor  # (L, B, D_CONV-1, conv_ch) float32
    shared_k: torch.Tensor    # (n_inv, B, T, kvh, hd) compute dtype
    shared_v: torch.Tensor
    pos: torch.Tensor         # (B,) int32


def _shared_positions(cfg: ArchConfig) -> List[int]:
    """The layers before whose Mamba2 block the shared block runs."""
    period = max(1, cfg.shared_attn_period)
    return [i for i in range(cfg.n_layers) if i % period == 0]


def _shared_block_tail(sp, cfg, x, h):
    x = x + h
    return x + apply_mlp(sp["mlp"], cfg, apply_norm(sp["mlp_norm"], cfg, x))


class HybridLM(_LM):
    """The zamba2 hybrid: a Mamba2 stack with one shared attention block
    (see the module docstring)."""

    FAMILIES = ("hybrid",)
    CAST = frozenset({"embed", "lm_head", "shared.attn", "shared.mlp",
                      "layers.mamba.in_proj", "layers.mamba.conv_w",
                      "layers.mamba.out_proj"})

    @staticmethod
    def param_names(cfg):
        return {"embed", "final_norm", "lm_head", "shared", "layers"}

    @staticmethod
    def init(cfg: ArchConfig, gen: torch.Generator) -> Params:
        """The params nest of the JAX ``build_hybrid_lm(cfg).init``."""
        L = (cfg.n_layers,)
        return {
            "embed": init_embed(gen, cfg),
            "final_norm": init_norm(gen, cfg),
            "lm_head": init_lm_head(gen, cfg),
            "shared": {"attn_norm": init_norm(gen, cfg),
                       "attn": init_attention(gen, cfg),
                       "mlp_norm": init_norm(gen, cfg),
                       "mlp": init_mlp(gen, cfg)},
            "layers": {"norm": init_norm(gen, cfg, lead=L),
                       "mamba": ssm_mod.init_mamba(gen, cfg, lead=L)},
        }

    def init_decode_state(self, batch_size: int,
                          max_len: int) -> HybridDecodeState:
        cfg = self.cfg
        d_in, n_heads, d_state = ssm_mod.ssm_dims(cfg)
        n_inv = len(_shared_positions(cfg))
        L, dev = cfg.n_layers, self.device
        kv = (n_inv, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return HybridDecodeState(
            mamba_h=torch.zeros((L, batch_size, n_heads, d_state,
                                 ssm_mod.SSM_HEAD), device=dev),
            mamba_conv=torch.zeros((L, batch_size, ssm_mod.D_CONV - 1,
                                    d_in + 2 * d_state), device=dev),
            shared_k=torch.zeros(kv, dtype=cdtype(cfg), device=dev),
            shared_v=torch.zeros(kv, dtype=cdtype(cfg), device=dev),
            pos=self._pos(batch_size, 0))

    def _head(self, P: Params, x: torch.Tensor,
              tail: Optional[int] = None) -> torch.Tensor:
        x = apply_norm(P["final_norm"], self.cfg, x)
        return apply_lm_head(P["lm_head"], self.cfg, x, tail=tail)

    def _logits(self, P: Params, x: torch.Tensor) -> torch.Tensor:
        """The last position's logits (B, V) of the stream ``x``."""
        return whole_vocab(self._head(P, *self._tail(x, 1)))[:, 0]

    def loss_fn(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce": loss}) of the JAX hybrid ``loss_fn``: each layer,
        under ``cfg.remat``, runs the shared attention + MLP block first
        when its index is a multiple of ``shared_attn_period``, then its
        Mamba2 block."""
        cfg = self.cfg
        P, layers = self.train_params()
        shared_refs, shared_at = P["shared"], _shared_positions(cfg)
        tokens = self._batch_tensor(batch, "tokens")
        b, s = tokens.shape
        with sequence(s):
            P = self._use({k: v for k, v in P.items()
                           if k not in ("layers", "shared")})
            x = apply_embed(P["embed"], cfg, tokens)
            positions = torch.arange(s, device=self.device).expand(b, s)

            def body(lp, shared, h):
                lp = self._use(lp)
                if shared:
                    sp = self._use(shared_refs)
                    a = apply_attention(sp["attn"], cfg,
                                        apply_norm(sp["attn_norm"], cfg, h),
                                        positions, causal=True)
                    h = _shared_block_tail(sp, cfg, h, a)
                return h + ssm_mod.apply_mamba(lp["mamba"], cfg,
                                               apply_norm(lp["norm"], cfg, h))

            for i, lp in enumerate(layers):
                x = self._remat(lambda h, lp=lp, sh=i in shared_at:
                                body(lp, sh, h))(x)
            loss = self._ce(self._head(P, x), batch)
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, HybridDecodeState]:
        """tokens (B, S) -> (logits of the last position (B, V), the decode
        state: each layer's Mamba2 state after the prompt, and each shared
        invocation's K/V in slots 0..S-1 of ``max_len``)."""
        tokens, max_len = self._prompt(tokens, max_len)
        cfg = self.cfg
        with sequence(tokens.shape[1]):
            P, layers = self.serve_params()
            shared_refs, shared_at = P["shared"], _shared_positions(cfg)
            P = self._use({k: v for k, v in P.items()
                           if k not in ("layers", "shared")})
            b, s = tokens.shape
            x = apply_embed(P["embed"], cfg, tokens)
            positions = torch.arange(s, device=self.device).expand(b, s)
            state = self._new_state(b, max_len)
            lay_kv, lay_h = (self._state_layout(n)
                             for n in ("shared_k", "mamba_h"))
            inv = 0
            for i, lp in enumerate(layers):
                lp = self._use(lp)
                if i in shared_at:
                    sp = self._use(shared_refs)
                    z = apply_norm(sp["attn_norm"], cfg, x)
                    h, (k, v) = attention_prefill(sp["attn"], cfg, z,
                                                  positions)
                    write_prompt(state.shared_k[inv], k, lay_kv)
                    write_prompt(state.shared_v[inv], v, lay_kv)
                    inv += 1
                    x = _shared_block_tail(sp, cfg, x, h)
                y, ms = ssm_mod.apply_mamba(lp["mamba"], cfg,
                                            apply_norm(lp["norm"], cfg, x),
                                            return_state=True)
                x = x + y
                state.mamba_h[i] = model_part(ms.h, lay_h)
                state.mamba_conv[i] = ms.conv
            return self._logits(P, x), state._replace(pos=self._pos(b, s))

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: HybridDecodeState
                    ) -> Tuple[torch.Tensor, HybridDecodeState]:
        """tok (B,) -> (logits (B, V), the next state)."""
        cfg = self.cfg
        P, layers = self.serve_params()
        shared_refs, shared_at = P["shared"], _shared_positions(cfg)
        P = self._use({k: v for k, v in P.items()
                       if k not in ("layers", "shared")})
        tok = torch.as_tensor(tok, device=self.device)
        x = apply_embed(P["embed"], cfg, tok[:, None])
        lay_kv, lay_h = (self._state_layout(n)
                         for n in ("shared_k", "mamba_h"))
        inv = 0
        for i, lp in enumerate(layers):
            lp = self._use(lp)
            if i in shared_at:
                sp = self._use(shared_refs)
                z = apply_norm(sp["attn_norm"], cfg, x)
                h, _, _ = attention_decode(sp["attn"], cfg, z,
                                           state.shared_k[inv],
                                           state.shared_v[inv], state.pos,
                                           lay_kv)
                inv += 1
                x = _shared_block_tail(sp, cfg, x, h)
            y, ms = ssm_mod.mamba_decode_step(
                lp["mamba"], cfg, apply_norm(lp["norm"], cfg, x),
                ssm_mod.MambaState(h=state.mamba_h[i],
                                   conv=state.mamba_conv[i]), lay_h)
            x = x + y
            state.mamba_h[i] = ms.h
            state.mamba_conv[i] = ms.conv
        return self._logits(P, x), state._replace(pos=state.pos + 1)


# ====================================================================== rwkv
class RWKVDecodeState(NamedTuple):
    S: torch.Tensor           # (L, B, h, dk, dv) float32
    x_time: torch.Tensor      # (L, B, d) float32
    x_chan: torch.Tensor      # (L, B, d) float32
    pos: torch.Tensor         # (B,) int32


class RWKVLM(_LM):
    """The RWKV6 LM (see the module docstring)."""

    FAMILIES = ("ssm",)
    CAST = frozenset({"embed", "lm_head", "layers.chan"} | {
        f"layers.time.{k}" for k in ("mu", "receptance", "key", "value",
                                     "gate", "output")})

    @staticmethod
    def param_names(cfg):
        return {"embed", "final_norm", "lm_head", "layers"}

    @staticmethod
    def init(cfg: ArchConfig, gen: torch.Generator) -> Params:
        """The params nest of the JAX ``build_rwkv_lm(cfg).init``."""
        L = (cfg.n_layers,)
        return {
            "embed": init_embed(gen, cfg),
            "final_norm": init_norm(gen, cfg, kind="layernorm"),
            "lm_head": init_lm_head(gen, cfg),
            "layers": {"ln1": init_norm(gen, cfg, kind="layernorm", lead=L),
                       "time": rwkv_mod.init_rwkv_time(gen, cfg, lead=L),
                       "ln2": init_norm(gen, cfg, kind="layernorm", lead=L),
                       "chan": rwkv_mod.init_rwkv_channel(gen, cfg, lead=L)},
        }

    def init_decode_state(self, batch_size: int,
                          max_len: Optional[int] = None) -> RWKVDecodeState:
        """The state does not grow with context: ``max_len`` is unused."""
        cfg = self.cfg
        n_heads, hd = rwkv_mod.rwkv_dims(cfg)
        L, d, dev = cfg.n_layers, cfg.d_model, self.device
        return RWKVDecodeState(
            S=torch.zeros((L, batch_size, n_heads, hd, hd), device=dev),
            x_time=torch.zeros((L, batch_size, d), device=dev),
            x_chan=torch.zeros((L, batch_size, d), device=dev),
            pos=self._pos(batch_size, 0))

    def _head(self, P: Params, x: torch.Tensor,
              tail: Optional[int] = None) -> torch.Tensor:
        x = apply_norm(P["final_norm"], self.cfg, x, kind="layernorm")
        return apply_lm_head(P["lm_head"], self.cfg, x, tail=tail)

    def _logits(self, P: Params, x: torch.Tensor) -> torch.Tensor:
        """The last position's logits (B, V) of the stream ``x``."""
        return whole_vocab(self._head(P, *self._tail(x, 1)))[:, 0]

    def loss_fn(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce": loss}) of the JAX RWKV6 ``loss_fn``: time mixing
        with chunks of ``min(ssm_chunk, 64)``, then channel mixing, each
        layer under ``cfg.remat`` when ``cfg.scan_layers`` (the JAX package
        applies ``_remat`` to its ``lax.scan`` body only)."""
        tokens = self._batch_tensor(batch, "tokens")
        cfg = self.cfg
        with sequence(tokens.shape[1]):
            P, layers = self.train_params()
            P = self._use({k: v for k, v in P.items() if k != "layers"})
            x = apply_embed(P["embed"], cfg, tokens)
            chunk = min(cfg.ssm_chunk, 64)

            def layer(lp, h):
                lp = self._use(lp)
                z = apply_norm(lp["ln1"], cfg, h, kind="layernorm")
                h = h + rwkv_mod.apply_rwkv_time(lp["time"], cfg, z,
                                                 chunk=chunk)
                return h + rwkv_mod.apply_rwkv_channel(
                    lp["chan"], cfg, apply_norm(lp["ln2"], cfg, h,
                                                kind="layernorm"))

            for lp in layers:
                step = lambda h, lp=lp: layer(lp, h)
                x = (self._remat(step) if cfg.scan_layers else step)(x)
            loss = self._ce(self._head(P, x), batch)
            return loss, {"ce": loss}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, RWKVDecodeState]:
        """tokens (B, S) -> (logits of the last position (B, V), the decode
        state after the prompt).  ``max_len`` is checked, not used."""
        tokens, _ = self._prompt(tokens, max_len)
        cfg = self.cfg
        with sequence(tokens.shape[1]):
            P, layers = self.serve_params()
            P = self._use({k: v for k, v in P.items() if k != "layers"})
            b, s = tokens.shape
            x = apply_embed(P["embed"], cfg, tokens)
            sp = seq_split()
            state = self._new_state(b, max_len)
            lay = self._state_layout("S")
            chunk = min(cfg.ssm_chunk, 64)
            for i, lp in enumerate(layers):
                lp = self._use(lp)
                z = apply_norm(lp["ln1"], cfg, x, kind="layernorm")
                y, (S, x_last) = rwkv_mod.apply_rwkv_time(
                    lp["time"], cfg, z, chunk=chunk, return_state=True)
                x = x + y
                z2 = apply_norm(lp["ln2"], cfg, x, kind="layernorm")
                x = x + rwkv_mod.apply_rwkv_channel(lp["chan"], cfg, z2)
                if S.shape[1] < cfg.d_model // rwkv_mod.RWKV_HEAD:
                    S = tp().gather_out(S, 1)       # the rank's heads: all
                state.S[i] = model_part(S, lay)
                state.x_time[i] = x_last
                # the last position: on the last rank of a split sequence
                state.x_chan[i] = (z2 if sp is None else sp.enter(z2))[:, -1]
            return self._logits(P, x), state._replace(pos=self._pos(b, s))

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: RWKVDecodeState
                    ) -> Tuple[torch.Tensor, RWKVDecodeState]:
        """tok (B,) -> (logits (B, V), the next state)."""
        cfg = self.cfg
        P, layers = self.serve_params()
        P = self._use({k: v for k, v in P.items() if k != "layers"})
        tok = torch.as_tensor(tok, device=self.device)
        x = apply_embed(P["embed"], cfg, tok[:, None])
        lay = self._state_layout("S")
        for i, lp in enumerate(layers):
            lp = self._use(lp)
            st = rwkv_mod.RWKVState(S=state.S[i], x_time=state.x_time[i],
                                    x_chan=state.x_chan[i])
            z = apply_norm(lp["ln1"], cfg, x, kind="layernorm")
            y, st = rwkv_mod.rwkv_time_decode(lp["time"], cfg, z, st, lay)
            x = x + y
            z = apply_norm(lp["ln2"], cfg, x, kind="layernorm")
            y, st = rwkv_mod.rwkv_channel_decode(lp["chan"], cfg, z, st)
            x = x + y
            state.S[i] = st.S
            state.x_time[i] = st.x_time
            state.x_chan[i] = st.x_chan
        return self._logits(P, x), state._replace(pos=state.pos + 1)


def whole_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary: on a ``"model"`` axis that split
    the LM head, the ranks' slices gathered."""
    if getattr(logits, "tp_dim", None) is None:
        return logits
    return tp().gather_out(logits, -1)


# ================================================================== building
def model_class(cfg: ArchConfig):
    """The module class that serves ``cfg.family``; raises ``ValueError``
    for an unknown family."""
    from .encdec import EncDecLM
    for cls in (DecoderLM, HybridLM, RWKVLM, EncDecLM):
        if cfg.family in cls.FAMILIES:
            return cls
    raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """The params nest of the JAX ``build_model(cfg).init``, drawn from
    ``gen`` (on ``gen.device``) with the same distributions."""
    return model_class(cfg).init(cfg, gen)


def build_model(cfg: ArchConfig, device="cuda", seed: int = 0) -> _LM:
    """The family's model for ``cfg``, with params drawn from a generator
    seeded with ``seed``, on ``device``.  On ``"meta"`` nothing is drawn:
    the model has the drawn one's parameter names, shapes and dtypes and
    holds no memory (the counterpart of ``jax.eval_shape(model.init)``),
    for a dry run."""
    cls = model_class(cfg)
    dev = as_device(device, "model")
    if dev.type == "meta":
        return cls(cfg, cls.init(cfg, MetaSource()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return cls(cfg, cls.init(cfg, gen))
