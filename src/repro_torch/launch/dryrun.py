"""Dry run of every (architecture x input shape) cell on one H100: the port
of ``repro.launch.dryrun``.

Each cell's step (a training step with ``cfg.grad_accum`` microbatches, a
prefill, or one decode step) runs on the ``meta`` device: the model, its
optimizer state and its inputs are stand-ins with the real names, shapes
and dtypes and no memory (:mod:`.specs`), and every operation only
propagates shapes.  :class:`Counter`, a ``TorchDispatchMode``, records
what the step would cost on the card:

- FLOPs of the aten matmuls, convolutions and attention, by
  ``torch.utils.flop_counter``'s formulas;
- bytes, the inputs plus the outputs of every aten op that is not a view;
- each kernel call of :mod:`repro_torch.kernels.ops` at its work
  function's figures (and not the aten ops under it), and the calls by
  kernel name;
- peak live bytes, from the lifetimes of the storages the step allocates
  on top of its arguments: the counterpart of XLA's argument and temp
  sizes (``memory_analysis``).

These numbers are computed from shapes for an H100, not measured: the dry
run touches no card.  The same counter over the same step on the card (or
on the CPU) counts the same FLOPs, bytes and kernel calls; ``chip_smoke``
holds the peak against ``torch.cuda.max_memory_allocated``.  One card has
no collectives: every collective count of its record is zero.

Per rank of a mesh (``--mesh``): the cell's step runs as rank 0 of the
JAX package's production layouts on H100 ranks, ``single`` (the JAX
``(16, 16)``, here ``(1, 16, 16)`` over ``("pod", "data", "model")``) and
``multi`` (``(2, 16, 16)``), on a stand-in process group with no peers
(:func:`repro_torch.launch.mesh.stand_in_mesh`): a training step is the
mesh step's (:class:`repro_torch.train.zero.MeshStep`, ``cfg.grad_accum``
microbatches of the rank's rows), prefill and decode the sharded ones of
:class:`repro_torch.serve.mesh.MeshServe`, the parameters the rank's
shards under the config's rules and the caches in
:func:`.specs.mesh_decode_state_specs`' layout.  The counter also takes
every collective the rank makes (:mod:`repro_torch.core.distributed`):
bytes of its result on the rank and count, by op.  The ranks are
symmetric, so rank 0 stands for all.  The record adds ``rank``,
``chips`` and ``mesh_shape``.  A training record's ``memory`` (one
card's too) also holds the peak before the optimizer's update
(``peak_before_update_bytes``: the forward's, the backward's and the
gradients' reduction).  With
``--seq-shard`` the config's ``seq_shard_activations`` is set (Megatron
sequence parallelism: the residual stream's sequence split over
``"model"``) and the record's mesh is named ``<mesh>_sp``.

Prefill cells run the flash kernel (``attn_impl="flash"``), as the port
serves on the card; training and decode keep each config's own attention
(``"xla"``: the flash kernel has no backward, and decode has one query).
MoE cells use each config's ``moe_dispatch``, as the JAX dry run does.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b \\
      --shape long_500k [--mesh multi] [--seq-shard]

writes ``experiments/dryrun_torch/<arch>_<shape>_h100.json`` (a directory
git ignores), ``..._h100_16x16.json`` and ``..._h100_2x16x16.json`` per
rank of a mesh (``..._sp.json`` with ``--seq-shard``); :mod:`.roofline`
reads them.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import weakref
from typing import Any, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from .._tree import tree_leaves, tree_map
from ..configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, get_config,
                       get_shape, shape_applicable)
from ..core.distributed import COLLECTIVE_OPS
from ..models import build_model
from ..optim import make_optimizer
from ..optim.schedule import warmup_cosine
from . import specs as S
from .mesh import MESHES

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
DEVICE = "h100"
NOTE = ("computed from shapes for one NVIDIA H100 (meta device), not "
        "measured")
MESH_NOTE = ("computed from shapes for one rank of a mesh of NVIDIA H100 "
             "ranks (meta device, a stand-in process group), not measured")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(node, out: list) -> list:
    """The tensors of an aten op's arguments or outputs (nested lists,
    tuples and dicts), appended to ``out``."""
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _tensors(x, out)
    elif isinstance(node, dict):
        for x in node.values():
            _tensors(x, out)
    return out


class Counter(TorchDispatchMode):
    """Counts FLOPs, bytes, kernel calls and peak live bytes of the aten
    ops run under it (see the module docstring).  ``track(tree)`` before
    the step names the arguments: their bytes are the base of the peak,
    and their storages are not counted again.

    ``flops`` and ``bytes`` are totals; ``kernels`` the calls by kernel
    name; ``peak`` the most bytes live at once (arguments included);
    ``args`` the arguments' bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, int] = collections.Counter()
        self.args = 0
        self.live = 0
        self.peak = 0
        self._inside = 0
        self._storages: Dict[int, int] = {}
        self.collectives: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.n_collectives: Dict[str, int] = {op: 0 for op in
                                              COLLECTIVE_OPS}
        #: label -> the peak up to the moment :meth:`mark` was called
        self.marks: Dict[str, int] = {}

    def mark(self, label: str) -> None:
        """Keep the peak so far under ``label`` (the step's peak before
        one of its phases)."""
        self.marks[label] = self.peak

    # -- arguments and storages ------------------------------------------
    def track(self, tree) -> None:
        """Count ``tree``'s tensors as arguments: live from the start."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage(), arg=True)

    def _add(self, st, arg: bool = False) -> None:
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        if arg:
            self.args += n
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- the hook of kernels.ops -------------------------------------------
    @contextlib.contextmanager
    def kernel_call(self, name: str, flops: int, nbytes: int):
        """One call of kernel ``name`` with its work; the aten ops inside
        add their allocations to the peak and nothing to the counts."""
        if not self._inside:
            self.kernels[name] += 1
            self.flops += flops
            self.bytes += nbytes
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    # -- the hook of core.distributed ---------------------------------------
    @contextlib.contextmanager
    def collective(self, op: str, nbytes: Optional[int]):
        """One collective ``op`` whose result on this rank is ``nbytes``
        (None: a group of one rank, not counted); the aten ops the backend
        runs inside it count nothing."""
        if nbytes is not None and not self._inside:
            self.collectives[op] += nbytes
            self.n_collectives[op] += 1
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    # -- aten ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        seen = {id(a.untyped_storage()) for a in ins}
        for o in outs:
            st = o.untyped_storage()
            if id(st) not in seen:
                self._add(st)
        if not self._inside:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    def summary(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll.update({f"n_{op}": n for op, n in self.n_collectives.items()})
        coll["raw_total"] = sum(self.collectives.values())
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": dict(sorted(self.kernels.items())),
                "peak_bytes": self.peak, "argument_bytes": self.args,
                "marks": dict(self.marks), "collectives": coll}


# ------------------------------------------------------- meta kernels
_CPP_META = {"depth": 0, "python": None, "lib": None}


def _python_meta_ops() -> Dict[Any, Any]:
    """{op: its Python meta function}: the aten ops whose Meta kernel
    ``torch._meta_registrations`` registers (its ``aten`` library)."""
    if _CPP_META["python"] is None:
        from torch._decomp import global_decomposition_table
        table: Dict[Any, Any] = {}
        for typ in ("meta", "post_autograd", "pre_autograd"):
            for op, fn in global_decomposition_table[typ].items():
                if isinstance(op, torch._ops.OpOverload):
                    table.setdefault(op, fn)
        _CPP_META["python"] = {
            op: fn for op, fn in table.items()
            if op.namespace == "aten" and any(
                line.startswith("Meta:") and "_meta_registrations" in line
                for line in torch._C._dispatch_dump(op.name()).splitlines())}
    return _CPP_META["python"]


@contextlib.contextmanager
def cpp_meta_kernels():
    """Inside the block an op on ``meta`` runs its C++ meta kernel where it
    has one, in place of the Python one that ``torch._meta_registrations``
    registers over it (written for symbolic shapes, at some 50 times the
    host time of an elementwise op); the ops with no C++ meta kernel keep
    their Python one.  Shapes, dtypes and strides are the C++ kernels',
    the ones eager CPU computes (the tests hold the counts on meta to the
    CPU's).  torch's registrations are put back on exit."""
    import torch._meta_registrations as mr
    python = _python_meta_ops()
    if _CPP_META["depth"] == 0:
        mr._meta_lib_dont_use_me_use_register_meta._destroy()
        lib = torch.library.Library("aten", "IMPL", "Meta")
        for op, fn in python.items():
            if not torch._C._dispatch_has_kernel_for_dispatch_key(
                    op.name(), "Meta"):
                lib.impl(op, fn)
        _CPP_META["lib"] = lib
    _CPP_META["depth"] += 1
    try:
        yield
    finally:
        _CPP_META["depth"] -= 1
        if _CPP_META["depth"] == 0:
            _CPP_META["lib"]._destroy()
            lib = torch.library.Library("aten", "IMPL", "Meta")
            for op, fn in python.items():
                lib.impl(op, fn)
            mr._meta_lib_dont_use_me_use_register_meta = lib


# ------------------------------------------------------------------ steps
def build_train_step(cfg: ArchConfig, model, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)`` as the JAX dry run builds it: with ``cfg.grad_accum`` > 1 the
    batch (B, ...) is cut into (accum, B / accum, ...) microbatches whose
    gradients are summed in the parameter dtype and divided by accum, and
    the loss is their mean; then ``warmup_cosine(step, 3e-4, 2000,
    100_000)`` and ``opt.update``.  ``params`` is the model's
    ``trainable_tree()``, updated in place."""
    accum = max(1, cfg.grad_accum)

    def grads_of(params, batch):
        for p in tree_leaves(params):
            p.grad = None
        loss, _ = model.loss_fn(batch)
        loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, params)
        for p in tree_leaves(params):
            p.grad = None
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        if accum > 1:
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(accum):
                loss, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                with torch.no_grad():
                    for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                        a.add_(b.to(a.dtype))
                del g
                lsum = lsum + loss
            with torch.no_grad():
                grads = tree_map(lambda g: g / accum, gsum)
            del gsum
            loss = lsum / accum
        else:
            loss, grads = grads_of(params, batch)
        lr = warmup_cosine(opt_state[0], peak_lr=3e-4, warmup_steps=2000,
                           total_steps=100_000)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, loss
    return train_step


def _prefill(model, batch: Dict[str, torch.Tensor], max_len: int):
    cfg = model.cfg
    if cfg.family == "encdec":
        return model.prefill(batch["tokens"], batch["frames"],
                             max_len=max_len)
    if cfg.family == "vlm":
        return model.prefill(batch["tokens"], max_len,
                             patch_embeds=batch["patch_embeds"])
    return model.prefill(batch["tokens"], max_len)


def build_prefill_step(cfg: ArchConfig, model, max_len: int):
    """``prefill_step(batch) -> (B,) int32``: the prefill into a cache of
    ``max_len`` positions, then the argmax of the last position's logits
    (the decode state is dropped, as JAX's step returns the tokens only)."""
    def prefill_step(batch):
        logits, _ = _prefill(model, batch, max_len)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prefill_step


def build_serve_step(cfg: ArchConfig, model):
    """``serve_step(tok, state) -> (next tokens (B,) int32, state)``: one
    decode step and its argmax."""
    def serve_step(tok, state):
        logits, state = model.decode_step(tok, state)
        return torch.argmax(logits, dim=-1).to(torch.int32), state
    return serve_step


# ------------------------------------------------------------------ cells
def cell_config(cfg: ArchConfig, kind: str) -> ArchConfig:
    """The config a cell of ``kind`` runs: prefill on the flash kernel."""
    return dataclasses.replace(cfg, attn_impl="flash") \
        if kind == "prefill" else cfg


def cell_inputs(cfg: ArchConfig, shape: ShapeConfig, device="meta",
                seed: int = 0):
    """(model, step, args) of a cell on ``device``: on meta, stand-ins;
    elsewhere the model drawn from ``seed`` and the inputs from ``seed +
    1`` (:func:`.specs.draw`).  ``step(*args)`` runs the cell once."""
    cfg = cell_config(cfg, shape.kind)
    model = build_model(cfg, device=device, seed=seed)
    vocab = cfg.vocab_size
    if shape.kind == "train":
        opt = _marked_update(make_optimizer(cfg))
        params = model.trainable_tree()
        batch = S.train_batch_specs(cfg, shape, device)
        if torch.device(device).type != "meta":
            S.draw(batch, seed + 1, vocab)
        return model, build_train_step(cfg, model, opt), \
            (params, opt.init(params), batch)
    if shape.kind == "prefill":
        batch = S.prefill_batch_specs(cfg, shape, device)
        if torch.device(device).type != "meta":
            S.draw(batch, seed + 1, vocab)
        extra = cfg.n_patches if cfg.family == "vlm" else 0
        return model, build_prefill_step(cfg, model,
                                         shape.seq_len + extra), (batch,)
    state = S.decode_state_specs(cfg, shape, model)
    tok = S.decode_input_specs(cfg, shape, device)
    if torch.device(device).type != "meta":
        S.draw((tok, state), seed + 1, vocab)
    return model, build_serve_step(cfg, model), (tok, state)


def _marked_update(opt):
    """``opt`` whose update first marks ``"update"`` on each active
    :class:`Counter`: a training record's ``peak_before_update_bytes``,
    the peak of the forward, the backward and the gradients' reduction
    (where the activations a step keeps count), apart from the
    optimizer's own."""
    def update(*args, **kw):
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, Counter):
                mode.mark("update")
        return opt.update(*args, **kw)
    return opt._replace(update=update)


def mesh_cell_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     device="meta", seed: int = 0):
    """(model, step, args) of a cell on this rank of ``mesh`` (a started
    ``DeviceMesh``; the caller applies the config's parameter rules,
    :func:`repro_torch.models.sharding.config_rules`): the model keeps
    the rank's shards; a training step is :class:`repro_torch.train.zero.
    MeshStep`'s with ``cfg.grad_accum`` microbatches of the rank's rows,
    prefill and decode run on :class:`repro_torch.serve.mesh.MeshServe`
    with the rank's rows and its part of the decode state
    (:func:`.specs.mesh_decode_state_specs`).  Off meta the whole model
    and inputs are drawn as :func:`cell_inputs` draws them and cut to the
    rank's parts, so that the mesh computes what one device does."""
    from ..serve.mesh import MeshServe
    from ..train.zero import MeshStep
    cfg = cell_config(cfg, shape.kind)
    model = build_model(cfg, device=device, seed=seed)
    meta = torch.device(device).type == "meta"
    coord = S.mesh_coord(mesh)
    vocab = cfg.vocab_size
    if shape.kind == "train":
        batch, specs = S.mesh_train_batch_specs(cfg, shape, mesh, device)
        if not meta:
            S.draw(batch, seed + 1, vocab)
        opt = _marked_update(make_optimizer(cfg))
        step = MeshStep(model, opt, mesh, lambda t: warmup_cosine(
            t, peak_lr=3e-4, warmup_steps=2000, total_steps=100_000),
            accum=cfg.grad_accum)
        rows = (S.local(batch, specs, mesh, coord) if meta
                else step.local_rows(batch))
        params = model.trainable_tree()

        def train_step(params, opt_state, rows):
            params, opt_state, _, loss = step.step_local(params, opt_state,
                                                         None, rows)
            return params, opt_state, loss
        return model, train_step, (params, opt.init(params), rows)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    serve = MeshServe(model, mesh, shape.global_batch, shape.seq_len + (
        extra if shape.kind == "prefill" else 0))
    if shape.kind == "prefill":
        batch, specs = S.mesh_prefill_batch_specs(cfg, shape, mesh, device)
        if meta:
            batch = S.local(batch, specs, mesh, coord)
        else:
            batch = {k: serve.rows(v) for k, v in S.draw(
                batch, seed + 1, vocab).items()}
        return model, build_prefill_step(cfg, serve,
                                         shape.seq_len + extra), (batch,)
    tok, _ = S.mesh_decode_input_specs(cfg, shape, mesh, device)
    if meta:
        return model, build_serve_step(cfg, serve), (
            S.local(tok, S.P((serve.batch_axes or None,)), mesh, coord),
            serve.init_state())
    state = S.decode_state_specs(cfg, shape, build_model(cfg,
                                                         device=device))
    S.draw((tok, state), seed + 1, vocab)
    return model, build_serve_step(cfg, serve), (serve.rows(tok),
                                                 serve.local_state(state))


def count(model, step, args, counter: Optional[Counter] = None) -> Counter:
    """Run ``step(*args)`` once under a :class:`Counter` (a fresh one by
    default) that takes ``args`` and ``model``'s parameters as the
    arguments, meta ops on their C++ kernels (:func:`cpp_meta_kernels`);
    the outputs are dropped before it returns."""
    counter = counter or Counter()
    counter.track((model.param_tree(), args))
    with cpp_meta_kernels(), counter:
        out = step(*args)
        del out
    return counter


def record(cfg: ArchConfig, shape: ShapeConfig, counted: Counter
           ) -> Dict[str, Any]:
    """A dry-run record's figures from a :class:`Counter` over the cell's
    step: ``cost``, ``memory``, ``kernels``, ``collectives`` (bytes and
    ``n_<op>`` counts by op), ``tokens`` (the global batch's),
    ``n_layers``, ``n_params``, ``n_active_params``."""
    out = counted.summary()
    return {
        "note": NOTE,
        "attn_impl": cell_config(cfg, shape.kind).attn_impl,
        "memory": {"available": True,
                   "argument_size_in_bytes": out["argument_bytes"],
                   "temp_size_in_bytes": out["peak_bytes"]
                   - out["argument_bytes"],
                   "peak_bytes": out["peak_bytes"],
                   **{f"peak_before_{k}_bytes": v
                      for k, v in out["marks"].items()}},
        "cost": {"flops": float(out["flops"]),
                 "bytes accessed": float(out["bytes"])},
        "kernels": out["kernels"],
        "collectives": out["collectives"],
        "tokens": shape.global_batch * (shape.seq_len
                                        if shape.kind != "decode" else 1),
        "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }


def dry_run(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """:func:`record` of ``shape``'s step for ``cfg`` on meta."""
    with cpp_meta_kernels():
        model, step, args = cell_inputs(cfg, shape, "meta")
        c = count(model, step, args)
        del model, step, args
    return record(cfg, shape, c)


def mesh_dry_run(cfg: ArchConfig, shape: ShapeConfig, mesh_shape,
                 rank: int = 0) -> Dict[str, Any]:
    """:func:`record` of ``shape``'s step for ``cfg`` on rank ``rank`` of
    a stand-in mesh of ``mesh_shape`` over ``("pod", "data", "model")``
    (:func:`repro_torch.launch.mesh.stand_in_mesh`), on meta, with
    ``rank``, ``chips`` and ``mesh_shape``."""
    from ..models.sharding import config_rules
    from .mesh import stand_in_mesh
    with stand_in_mesh(mesh_shape, rank) as mesh, config_rules(cfg), \
            cpp_meta_kernels():
        model, step, args = mesh_cell_inputs(cfg, shape, mesh, "meta")
        c = count(model, step, args)
        del model, step, args
    rec = record(cfg, shape, c)
    rec.update(rank=rank, chips=math.prod(mesh_shape),
               mesh_shape=list(mesh_shape))
    return rec


#: the suffix of a record's mesh name under sequence parallelism
SEQ_SHARD_SUFFIX = "_sp"


def mesh_name(mesh_shape) -> str:
    """``h100_16x16`` for (1, 16, 16), ``h100_2x16x16`` for (2, 16, 16):
    the JAX mesh's name on H100 ranks."""
    shape = tuple(mesh_shape)
    return DEVICE + "_" + "x".join(map(str, shape[1:] if shape[0] == 1
                                       else shape))


def run_cell(arch: str, shape: Union[str, ShapeConfig], save: bool = True,
             verbose: bool = True, out_dir: pathlib.Path = RESULTS_DIR,
             mesh_shape=None,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The dry run of one assigned (arch, shape) cell on meta: the JAX
    record's keys where they apply (``cost``, ``memory``,
    ``collectives``, ``n_layers``, ``n_params``, ``n_active_params``) with
    ``kernels`` (calls by name) and ``tokens``; ``skipped`` with JAX's
    reason for a cell that does not run (saved too, for the roofline's
    table).  ``shape`` is an assigned shape's name or any
    :class:`ShapeConfig`.  With ``mesh_shape`` (e.g. ``MESHES["multi"]``)
    the record is rank 0's of that mesh (:func:`mesh_dry_run`),
    named by :func:`mesh_name`; without it, one card's.  ``overrides``
    change the config (e.g. ``grad_accum``)."""
    cfg = get_config(arch, **(overrides or {}))
    shape = get_shape(shape) if isinstance(shape, str) else shape
    shape_name = shape.name
    ok, reason = shape_applicable(cfg, shape)
    name = DEVICE if mesh_shape is None else mesh_name(mesh_shape)
    if cfg.seq_shard_activations:
        name += SEQ_SHARD_SUFFIX
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": name, "kind": shape.kind,
                           "seq_shard": cfg.seq_shard_activations}
    if not ok:
        rec["skipped"] = reason
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {name}: {reason}",
                  flush=True)
    else:
        t0 = time.time()
        rec.update(dry_run(cfg, shape) if mesh_shape is None else
                   mesh_dry_run(cfg, shape, mesh_shape))
        if mesh_shape is not None:
            rec["note"] = MESH_NOTE
        rec["run_s"] = round(time.time() - t0, 2)
    if verbose and ok:
        mem, cost, coll = rec["memory"], rec["cost"], rec["collectives"]
        print(f"[dryrun] OK {arch} x {shape_name} x {name} "
              f"({rec['run_s']:.1f}s): "
              f"flops={cost['flops']:.3e} "
              f"bytes={cost['bytes accessed']:.3e} "
              f"peak={mem['peak_bytes'] / 1e9:.2f} GB "
              f"(args {mem['argument_size_in_bytes'] / 1e9:.2f}) "
              f"kernels={rec['kernels']} collectives/rank "
              + " ".join(f"{op}:{coll[op] / 1e6:.1f}MB({coll['n_' + op]})"
                         for op in COLLECTIVE_OPS if coll[op]),
              flush=True)
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}_{shape_name}_{name}.json").write_text(
            json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--kind", choices=["train", "prefill", "decode"],
                    help="with --arch, --batch and --seq: a step of this "
                         "kind at any batch and length instead of --shape")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS_DIR,
                    help="directory of the records")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card",
                    help="one card (default), or rank 0 of the (1, 16, 16) "
                         "or (2, 16, 16) mesh of H100 ranks, or both")
    ap.add_argument("--mesh-shape", help="P,D,M: rank 0 of this "
                    "(pod, data, model) mesh instead of --mesh")
    ap.add_argument("--grad-accum", type=int,
                    help="the config's microbatches a training step")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron sequence parallelism "
                         "(seq_shard_activations): records named "
                         f"<mesh>{SEQ_SHARD_SUFFIX}")
    args = ap.parse_args(argv)
    meshes = {"card": [None], "single": [MESHES["single"]],
              "multi": [MESHES["multi"]],
              "both": [MESHES["single"], MESHES["multi"]]}[args.mesh]
    if args.mesh_shape:
        meshes = [tuple(int(n) for n in args.mesh_shape.split(","))]
    overrides = ({} if args.grad_accum is None
                 else {"grad_accum": args.grad_accum})
    if args.seq_shard:
        overrides["seq_shard_activations"] = True
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch and args.kind and args.batch and args.seq:
        cells = [(args.arch, ShapeConfig(
            f"{args.kind}_{args.batch}x{args.seq}", args.seq, args.batch,
            args.kind))]
    else:
        ap.error("--arch and --shape (or --kind, --batch, --seq) required "
                 "unless --all")
    failures = []
    for arch, sh in cells:
        for m in meshes:
            try:
                run_cell(arch, sh, out_dir=args.out, mesh_shape=m,
                         overrides=overrides)
            except Exception as e:  # report every failing cell, then exit 1
                failures.append((arch, str(sh), str(m), repr(e)))
                print(f"[dryrun] FAIL {arch} x {sh} x {m}: {e!r}",
                      file=sys.stderr, flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:", file=sys.stderr)
        for f in failures:
            print("  ", *f, file=sys.stderr)
        return 1
    print(f"\nall {len(cells) * len(meshes)} requested dry-run cells ran "
          f"({NOTE if meshes == [None] else MESH_NOTE})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
