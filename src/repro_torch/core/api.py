"""The query API over MREngine: compile/execute/batch + the plan cache.

A :class:`~repro_torch.core.plan.Plan` (built once from static parameters by
a ``*_plan`` builder) is bound by ``MREngine.compile(plan)`` into an
:class:`Executable`:

- ``exe(*inputs, key=...)`` runs one query, eagerly on the engine's device;
- ``exe.batch(B)`` runs B independent queries, stacked on a new leading
  axis, with outputs bit-identical to B single calls: on a batchable
  engine (``LocalEngine``) as one round program with a leading batch axis,
  each round's shuffle one shuffle for the whole batch;
- executables live in a **bounded per-engine plan cache**
  (:class:`BoundedCache`) with LRU eviction and hit/miss counters surfaced
  through ``engine.cache_info()``.

Typical use::

    from repro_torch.core.engine import LocalEngine
    from repro_torch.core.api import sort_plan

    engine = LocalEngine(shuffle_impl="kernel")   # on the card
    exe = engine.compile(sort_plan(n=4096, M=64))
    out = exe(x, key=seed)                        # one query
    outs = exe.batch(8)(xs, keys=seeds)           # 8 queries, stacked
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .._tree import tree_leaves, tree_map
from ..obs import NULL_TRACER
from ..obs import BatchTracer
from .plan import Plan, execute_plan, execute_plan_batch


class CacheInfo(NamedTuple):
    """Counters of a :class:`BoundedCache` (``engine.cache_info()``)."""

    hits: int
    misses: int
    evictions: int
    currsize: int
    maxsize: int


class BoundedCache:
    """LRU-bounded mapping with hit/miss/eviction counters."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = int(maxsize)
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key):
        """Return the cached value or None; counts a hit or a miss."""
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return value

    def store(self, key, value):
        """Insert (evicting the least-recently-used entry when full) and
        return ``value``."""
        if key in self._data:
            self._data[key] = value
            self._data.move_to_end(key)
            return value
        while len(self._data) >= self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1
        self._data[key] = value
        return value

    def info(self) -> CacheInfo:
        return CacheInfo(hits=self.hits, misses=self.misses,
                         evictions=self.evictions, currsize=len(self._data),
                         maxsize=self.maxsize)

    def keys(self) -> tuple:
        """Snapshot of the cached keys, LRU-first (read-only: touches
        neither the recency order nor the counters)."""
        return tuple(self._data.keys())

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data


class Executable:
    """A Plan bound to one engine (obtain via ``engine.compile(plan)``).

    PyTorch runs eagerly, so there is nothing to trace: every call runs the
    plan's stages on the engine's device.  ``trace_count`` counts runs of
    the round program: a single call, or a batched call on a batchable
    engine, is one run.

    With a recording tracer on the engine, each call records an
    ``exe.call`` event (its host seconds) and counts ``exe.calls``; the
    plan's ``plan.execute`` / ``plan.stage`` spans record inside it.  The
    JAX package also records ``exe.compile`` when jax lowers the round
    program; the port compiles nothing, so it never emits one."""

    #: distinct batch sizes whose callables are retained per executable
    batch_cache_size = 8

    def __init__(self, plan: Plan, engine):
        self.plan = plan
        self.engine = engine
        self._calls = 0
        self._batched = BoundedCache(self.batch_cache_size)

    @property
    def trace_count(self) -> int:
        """Number of runs of the round program."""
        return self._calls

    def _run(self, inputs, key):
        self._calls += 1
        return execute_plan(self.plan, self.engine, inputs, key=key)

    def __call__(self, *inputs, key=None):
        tr = getattr(self.engine, "tracer", NULL_TRACER)
        if not tr.enabled:
            return self._run(inputs, key)
        t0 = tr.clock()
        out = self._run(inputs, key)
        tr.event("exe.call", _dur=tr.clock() - t0, plan=self.plan.name,
                 backend=getattr(self.engine, "name", "?"))
        tr.count("exe.calls")
        return out

    # -- batching ------------------------------------------------------------
    def _batch_keys(self, keys, B: int) -> list:
        """One key per query: ``keys`` is a length-B sequence (or stack) of
        keys; None gives the seeds ``default_seed + i``."""
        if keys is None:
            return [self.plan.default_seed + i for i in range(B)]
        keys = list(keys)
        if len(keys) != B:
            raise ValueError(f"expected {B} keys, got {len(keys)}")
        return keys

    def batch(self, n_queries: int) -> Callable:
        """Return a callable running ``n_queries`` independent queries.

        Inputs are stacked along a new leading axis of size B; ``keys`` is
        an optional length-B sequence of per-query keys.  Every output leaf
        has a leading axis of size B, row b bit for bit what a single call
        on query b gives.

        On a :attr:`~repro_torch.core.engine.MREngine.batchable` engine the
        B queries run as one round program (:func:`~repro_torch.core.plan.
        execute_plan_batch`): each round is one shuffle for the batch, and
        a draw that depends on a key runs once per query in the prologue.
        A live tracer then records only the route decisions
        (:class:`~repro_torch.obs.BatchTracer`), as the JAX package's
        ``jit`` of a ``vmap`` does.  Otherwise the queries run one after
        another and their outputs are stacked; their rows record as single
        calls do, without ``exe.call`` events, as in the JAX package."""
        B = int(n_queries)
        cached = self._batched.lookup(B)
        if cached is not None:
            return cached

        if getattr(self.engine, "batchable", False):
            def call(*inputs, keys=None):
                ks = self._batch_keys(keys, B)
                self._calls += 1
                engine = self.engine
                tr = engine.tracer
                if not tr.enabled:
                    return execute_plan_batch(self.plan, engine, inputs, ks)
                engine.tracer = BatchTracer(tr)
                try:
                    return execute_plan_batch(self.plan, engine, inputs, ks)
                finally:
                    engine.tracer = tr
        else:
            def call(*inputs, keys=None):
                ks = self._batch_keys(keys, B)
                outs = [self._run(tree_map(lambda a: a[i], tuple(inputs)),
                                  ks[i]) for i in range(B)]
                return tree_map(lambda *leaves: torch.stack(leaves), *outs)

        return self._batched.store(B, call)


def pad_batch(inputs: tuple, n_queries: int, keys=None):
    """Pad ``k`` stacked queries up to a fixed batch of ``n_queries``.

    Each leaf of ``inputs`` (stacked on a leading axis of size ``k``, with
    ``1 <= k <= B``) is padded to B rows by replicating its last row, and
    ``keys`` (a length-k stack, optional) is padded the same way.  Returns
    ``(padded_inputs, padded_keys, valid)`` where ``valid`` is the boolean
    numpy mask of the k live rows.  Padding runs on the host, in numpy."""
    B = int(n_queries)
    leaves = tree_leaves(tuple(inputs))
    if not leaves:
        raise ValueError("pad_batch: empty inputs")
    k = int(np.shape(leaves[0])[0])
    if k < 1:
        raise ValueError("pad_batch: nothing to pad (k == 0)")
    if k > B:
        raise ValueError(f"pad_batch: {k} queries exceed the batch bound "
                         f"B={B}")

    def pad(leaf):
        leaf = np.asarray(leaf)
        if leaf.shape[0] != k:
            raise ValueError(
                f"pad_batch: inconsistent leading axis "
                f"{leaf.shape[0]} != {k}")
        if k == B:
            return leaf
        tail = np.broadcast_to(leaf[-1:], (B - k,) + leaf.shape[1:])
        return np.concatenate([leaf, tail], axis=0)

    padded = tree_map(pad, tuple(inputs))
    padded_keys = None if keys is None else pad(keys)
    valid = np.arange(B) < k
    return padded, padded_keys, valid


def compile_plan(plan: Plan, engine=None) -> Executable:
    """Module-level convenience for ``engine.compile(plan)`` (default
    engine = the shared LocalEngine on the card)."""
    if engine is None:
        from .engine import default_engine
        engine = default_engine()
    return engine.compile(plan)


def deprecated_entry(old: str, new: str) -> None:
    """One-liner the legacy ``fn(x, M, engine=...)`` wrappers call: points
    at the plan builder that replaces them."""
    warnings.warn(
        f"{old} is deprecated: build a plan with {new} and run it via "
        f"engine.compile(plan) — see repro_torch.core.api",
        DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# The query surface: every ported algorithm's plan builder, one import away.
# ---------------------------------------------------------------------------
from .sortmr import sort_plan                                    # noqa: E402
from .multisearch import multisearch_plan                        # noqa: E402
from .prefix import prefix_plan, PrefixResult                    # noqa: E402
from .funnel import funnel_write_plan                            # noqa: E402
from .bsp import bsp_plan, BSPResult                             # noqa: E402
from .geometry.hull2d import hull2d_plan                         # noqa: E402
from .geometry.hull3d import hull3d_plan                         # noqa: E402
from .geometry.lp import lp_plan                                 # noqa: E402

__all__ = [
    "CacheInfo", "BoundedCache", "Executable", "compile_plan", "pad_batch",
    "sort_plan", "multisearch_plan", "prefix_plan", "PrefixResult",
    "funnel_write_plan", "bsp_plan", "BSPResult",
    "hull2d_plan", "hull3d_plan", "lp_plan",
]
