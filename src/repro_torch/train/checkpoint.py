"""Checkpointing: step-atomic, self-describing, async-capable; the port of
``repro.train.checkpoint`` with the same on-disk format, so a checkpoint
the JAX trainer wrote restores into this port's trainer and back.

  * *Step-atomic*: a checkpoint directory is written under a temp name and
    renamed only after every tensor file and the manifest are on disk; a
    crash mid-save leaves the previous checkpoint intact.
  * *Self-describing*: one ``.npy`` per tensor and ``manifest.json`` with
    (file, shape, dtype) under each leaf's key path (``params/embed/table``,
    ``opt_state/m/...``, ``opt_state/step``: dict keys, NamedTuple field
    names and sequence indices joined by ``/``, as the JAX package's
    ``tree_flatten_with_path`` names them), and the metadata (step, config
    name, data seed).
  * *Async*: :class:`AsyncSaver` copies the tensors to host memory on the
    caller's thread (CPU tensors too, so later in-place updates cannot
    reach the writer) and writes them on a background thread.

numpy has no bfloat16: a bfloat16 tensor is saved as float32 (exactly) and
cast back to the target's dtype on restore.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple
from urllib.parse import quote

import numpy as np
import torch

from .._tree import tree_flatten, tree_unflatten


def _key_paths(tree) -> list:
    """The key path of every leaf, in the leaf order of ``tree_flatten``."""
    paths = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name, child in zip(node._fields, node):
                walk(child, prefix + [name])
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, prefix + [str(i)])
        else:
            paths.append("/".join(prefix))

    walk(tree, [])
    return paths


def _flatten(tree) -> Dict[str, Any]:
    return dict(zip(_key_paths(tree), tree_flatten(tree)[0]))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """:func:`_host`, never a view of memory the caller may change after
    the call (a CPU tensor's ``.numpy()`` shares its storage; the
    optimizers update parameters in place)."""
    arr = _host(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return arr                       # .cpu() made the copy
    return arr.copy()


def _leaf_fname(index: int, key: str) -> str:
    """Collision-free tensor filename: an enumeration prefix plus a
    percent-quoted slice of the key (lookup goes through the manifest)."""
    return f"{index:05d}_{quote(key, safe='')[:80]}.npy"


def _sweep_stale_tmp(ckpt_dir: pathlib.Path) -> None:
    """Remove ``.tmp_save_*`` directories stranded by an earlier crash
    between mkdtemp and the atomic rename."""
    for p in ckpt_dir.glob(".tmp_save_*"):
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)


def save(ckpt_dir: str, step: int, tree: Any,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous step-atomic save.  Returns the final directory path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_"))
    try:
        manifest = {"step": step, "tensors": {}, "meta": extra_meta or {}}
        for i, (key, leaf) in enumerate(_flatten(tree).items()):
            arr = _host(leaf)
            fname = _leaf_fname(i, key)
            np.save(tmp / fname, arr)
            manifest["tensors"][key] = {"file": fname,
                                        "shape": list(arr.shape),
                                        "dtype": str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


class AsyncSaver:
    """Snapshot on the caller thread, write on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def save_async(self, ckpt_dir: str, step: int, tree: Any,
                   extra_meta=None) -> None:
        self.wait()
        leaves, structure = tree_flatten(tree)
        host_tree = tree_unflatten(structure, [_snapshot(x) for x in leaves])

        def _work():
            try:
                self.last_path = save(ckpt_dir, step, host_tree, extra_meta)
            except BaseException as e:            # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int,
            target_tree: Any) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``target_tree``: every leaf
    a new tensor with the target leaf's dtype and device (shapes are
    checked).  Returns (tree, meta with ``step``)."""
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    flat_target = _flatten(target_tree)
    loaded = {}
    for key, info in manifest["tensors"].items():
        if key not in flat_target:
            raise KeyError(f"checkpoint tensor {key} not in target tree")
        arr = np.load(final / info["file"])
        want = flat_target[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                             f"target {tuple(want.shape)}")
        loaded[key] = torch.from_numpy(arr).to(device=want.device,
                                               dtype=want.dtype)
    keys = _key_paths(target_tree)
    missing = [k for k in keys if k not in loaded]
    if missing:
        raise KeyError(f"checkpoint missing tensors: {missing[:5]}...")
    tree = tree_unflatten(tree_flatten(target_tree)[1],
                          [loaded[k] for k in keys])
    return tree, manifest["meta"] | {"step": manifest["step"]}
