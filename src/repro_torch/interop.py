"""Carry data and engine state between the JAX package and this port.

Both sides meet in numpy: the JAX package's arrays convert with
``np.asarray`` and this port's tensors with :func:`to_numpy`, so nothing
here imports JAX.  A ``Mailbox`` or ``CostAccum`` of the JAX package, read
into numpy, becomes this port's with :func:`mailbox_from_numpy` and
:func:`accum_from_numpy`, and goes back with :func:`to_numpy`.  An LM's
params nest (``model.init`` of the JAX package, read into numpy) becomes
the port's model of the config's family (:class:`~repro_torch.models.DecoderLM`
for the dense, MoE and VLM families, :class:`~repro_torch.models.HybridLM`,
:class:`~repro_torch.models.RWKVLM` or :class:`~repro_torch.models.EncDecLM`)
with :func:`lm_params_from_numpy` and goes back with
:func:`lm_params_to_numpy`: the MoE layers' ``moe`` subtree (``router``,
``w_gate``, ``w_up``, ``w_down``, the optional ``shared``), the VLM's
``vision_proj`` and the encoder-decoder's ``enc`` / ``dec`` lists of layer
nests with their ``xattn`` and ``xattn_norm`` included.  An optimizer state (``AdamWState`` or
``AdafactorState`` of either package) goes over with
:func:`opt_state_from_numpy` and back with :func:`opt_state_to_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import as_device
from ._tree import tree_map
from .core.costmodel import CostAccum
from .core.mrmodel import Mailbox
from .models.transformer import model_class
from .optim import AdafactorState, AdamWState

_ACCUM_DTYPES = {"rounds": torch.int32, "communication": torch.float32,
                 "internal_time": torch.float32, "max_reducer_io": torch.int32,
                 "dropped": torch.int32}


def tree_from_numpy(tree, device="cpu"):
    """Every array-like leaf as a tensor on ``device``, dtype kept."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def mailbox_from_numpy(payload, valid, device="cpu") -> Mailbox:
    """A :class:`Mailbox` on ``device`` from a numpy payload nest and mask."""
    return Mailbox(payload=tree_from_numpy(payload, device),
                   valid=torch.from_numpy(np.array(valid, dtype=bool))
                   .to(device))


def accum_from_numpy(fields, device="cpu") -> CostAccum:
    """A :class:`CostAccum` from its five fields: a sequence in field order
    (the JAX package's ``CostAccum`` is one) or a dict by name.  Each field
    takes the port's dtype; the values must already be exact in it."""
    if isinstance(fields, dict):
        values = [fields[k] for k in CostAccum._fields]
    else:
        values = list(fields)
    if len(values) != len(CostAccum._fields):
        raise ValueError(f"CostAccum has {len(CostAccum._fields)} fields, "
                         f"got {len(values)}")
    return CostAccum(*[
        torch.tensor(np.asarray(v).item(), dtype=_ACCUM_DTYPES[k],
                     device=device)
        for k, v in zip(CostAccum._fields, values)])


def as_numpy(x) -> np.ndarray:
    """One tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(obj):
    """Tensors in any nest (Mailbox, CostAccum, dicts, ...) as numpy
    arrays, the nest's structure kept."""
    return tree_map(as_numpy, obj)


def lm_params_from_numpy(tree, cfg, device="cuda"):
    """The model of ``cfg``'s family holding the params nest ``tree``
    (numpy arrays under the JAX package's names), copied to ``device``: the
    card unless the caller passes ``device="cpu"``, as ``build_model``."""
    cls = model_class(cfg)
    return cls(cfg, tree_from_numpy(tree, as_device(device, "model")))


def lm_params_to_numpy(model):
    """The model's params nest as numpy arrays, the JAX package's names and
    shapes kept: the inverse of :func:`lm_params_from_numpy`."""
    return to_numpy(model.param_tree())


#: the optimizer states by their fields
_OPT_STATES = {AdamWState._fields: AdamWState,
               AdafactorState._fields: AdafactorState}


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``AdamWState`` or ``AdafactorState`` on ``device`` (the
    card unless the caller passes ``device="cpu"``) from a state of either
    package read into numpy: a NamedTuple with the fields (step, m, v) or
    (step, vr, vc).  Dtypes are kept (``step`` int32, the moments
    float32)."""
    fields = tuple(getattr(state, "_fields", ()))
    if fields not in _OPT_STATES:
        raise ValueError(f"no optimizer state has the fields {fields}")
    dev = as_device(device, "optimizer state")
    return _OPT_STATES[fields](*[tree_from_numpy(v, dev) for v in state])


def opt_state_to_numpy(state):
    """The optimizer state's fields as numpy arrays, the NamedTuple and
    the nests kept: the inverse of :func:`opt_state_from_numpy`."""
    return to_numpy(state)
