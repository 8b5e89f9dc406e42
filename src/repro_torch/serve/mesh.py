"""Prefill and decode on a mesh: the serving counterpart of the mesh
training step (:class:`repro_torch.train.zero.MeshStep`).

Every rank of a ``DeviceMesh`` over ``("pod", "data", "model")`` holds
its shard of each parameter (by its spec,
:class:`~repro_torch.train.zero.MeshParams`), its rows of the batch (over
:func:`repro_torch.launch.specs.batch_spec`'s axes, or every row where the
batch does not split) and its part of the decode state in the layout of
:func:`repro_torch.launch.specs.mesh_decode_state_specs`: the caches'
KV heads over ``"model"`` where they divide, else their head dimension,
and their sequence over ``"data"`` when the batch does not split;
Mamba2's state by heads and RWKV6's by the value dimension.  The model
runs under the rank's :class:`~repro_torch.models.sharding.ShardRun`:
each layer gathers its weights over the FSDP axes, computes Megatron
style over ``"model"``, and its attention combines the ranks' parts of
the cache (partial scores summed over ``"model"``, partial softmaxes
merged over ``"data"``).  The logits come back whole on every rank.

The state's ``pos`` is the rank's rows (the JAX spec replicates it).

    serve = MeshServe(model, mesh, batch=B, max_len=T)
    logits, state = serve.prefill(serve.rows(tokens), max_len=T)
    logits, state = serve.decode_step(serve.rows(tok), state)
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..launch import specs as S
from ..models import build_model
from ..models import sharding as shmod
from ..train.zero import MeshParams


class MeshServe:
    """``model`` served on ``mesh`` for a batch of ``batch`` slots and a
    cache of ``max_len`` positions (module docstring).  Building it keeps
    only this rank's shard of each parameter (cut in place)."""

    def __init__(self, model, mesh, batch: int, max_len: int):
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        mp = MeshParams(model, mesh)
        self.g, self.coord, self.layouts = mp.g, mp.coord, mp.layouts
        self.batch_axes = S.batch_spec(mesh, batch) or ()
        self.run = shmod.ShardRun(self.g, self.layouts, self.batch_axes,
                                  seq_shard=cfg.seq_shard_activations)
        whole = build_model(cfg, device="meta").init_decode_state(batch,
                                                                  max_len)
        self.state_type = type(whole)
        self.state_layouts = {
            name: S.layout_of(S.state_spec(cfg, name, tuple(leaf.shape),
                                           batch, max_len, mesh),
                              tuple(leaf.shape), mesh, self.coord)
            for name, leaf in zip(whole._fields, whole)}
        self.state_dtypes = {n: t.dtype for n, t in zip(whole._fields,
                                                         whole)}
        self.run.state_layouts = self.state_layouts
        self.run.init_state = self.init_state
        self.n_rows = batch // self._row_parts()
        mp.keep_shards(model.trainable_tree())

    def _row_parts(self) -> int:
        return math.prod(self.g.sizes.get(a, 1) for a in self.batch_axes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (the global batch on dim 0)."""
        i = 0
        for a in self.batch_axes:
            i = i * self.g.sizes[a] + self.coord[a]
        n = x.shape[0] // self._row_parts()
        return x[i * n:(i + 1) * n]

    def init_state(self):
        """The rank's part of a zeroed decode state (``pos``: its
        rows)."""
        dev = self.model.device
        out = {}
        for name, lay in self.state_layouts.items():
            shape = (self.n_rows,) if name == "pos" else lay.local_shape
            out[name] = torch.zeros(shape, dtype=self.state_dtypes[name],
                                    device=dev)
        return self.state_type(**out)

    def local_state(self, whole):
        """The rank's part of a decode state of whole tensors (copies)."""
        return self.state_type(**{
            name: (self.rows(t) if name == "pos" else
                   self.state_layouts[name].shard(t)).clone()
            for name, t in zip(whole._fields, whole)})

    def prefill(self, *args: Any, **kw: Any):
        """``model.prefill`` on the rank's rows: (the last position's
        logits (b, V), the rank's part of the decode state)."""
        with shmod.use_shard_run(self.run):
            return self.model.prefill(*args, **kw)

    def decode_step(self, tok: torch.Tensor, state):
        """``model.decode_step`` on the rank's rows and state part."""
        with shmod.use_shard_run(self.run):
            return self.model.decode_step(tok, state)
