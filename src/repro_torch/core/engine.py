"""Unified MREngine API: one round-program abstraction, pluggable backends.

The paper's Theorem 2.1 defines a single round-based computation model that
every algorithm in §3-§4 compiles into: each round, node v applies a
sequential function f to its state A_v(r), emitting (destination, item)
pairs; the shuffle routes items to form A_v(r+1).  This module is that model
as an API: an algorithm is a :class:`RoundProgram` and an :class:`MREngine`
executes it.  Three backends:

  ================== ========================== ===========================
  backend            substrate                  role
  ================== ========================== ===========================
  ReferenceEngine    numpy, per-item host loop  semantics oracle for tests
  LocalEngine        torch, dense mailboxes     one device, the card default
  ShardedEngine      torch.distributed group    the Shuffle across ranks
  ================== ========================== ===========================

The Shuffle of a :class:`LocalEngine` has two implementations
(``shuffle_impl=``): ``"dense"``, the stable-argsort scatter of
:func:`repro_torch.core.mrmodel.shuffle`, and ``"kernel"``, the composition
of hand-written CUDA kernels in :func:`repro_torch.core.kshuffle.
kernel_shuffle`.  Both are bit-identical.  ``get_engine("kernel")`` (alias
``"pallas"``, the JAX package's spelling) builds the kernel variant;
:class:`ShardedEngine` takes the same choice for its per-rank scatter.

Cost accounting is functional: engines return :class:`RoundStats` per round
and fold them into a :class:`CostAccum` of 0-d tensors on the engine's
device; nothing is read back to the host until a caller asks.

    >>> import numpy as np
    >>> eng = get_engine("local", device="cpu")
    >>> box, stats = eng.shuffle(np.array([1, 0, 1, 1], np.int32),
    ...                          np.arange(4.0, dtype=np.float32),
    ...                          n_nodes=2, capacity=2)
    >>> box.valid.tolist()                 # node 1 overflows: slot-FIFO keeps
    [[True, False], [True, True]]
    >>> int(stats.dropped)                 # ...the first 2, drops the third
    1
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import as_device
from .._tree import tree_flatten, tree_map, tree_unflatten
from ..obs import NULL_TRACER, round_event as _round_event
from .costmodel import CostAccum, RoundStats
from .mrmodel import Mailbox, Payload, RoundFn, unbatch_shuffle
from .mrmodel import shuffle as _dense_shuffle
from .mrmodel import shuffle_batch as _dense_shuffle_batch


def stats_row(stats: RoundStats) -> RoundStats:
    """A single query's stats from a batched round's: row 0 of a batch of
    one (what a traced ``engine.round`` event records), the (B,) fields
    unchanged otherwise."""
    if stats.items_sent.ndim == 1 and stats.items_sent.shape[0] == 1:
        return RoundStats(*(s[0] for s in stats))
    return stats


def stack_rows(rows) -> Tuple[Mailbox, RoundStats]:
    """B single queries' ``(box, stats)`` as one batched result, a
    (B, V, M) mailbox and (B,) stats; a batch of one takes views, no
    copy."""
    if len(rows) == 1:
        box, st = rows[0]
        return (tree_map(lambda l: l[None], box),
                RoundStats(*(f[None] for f in st)))
    boxes, stats = zip(*rows)
    return (tree_map(lambda *ls: torch.stack(ls), *boxes),
            RoundStats(*(torch.stack(f) for f in zip(*stats))))


class RoundProgram(NamedTuple):
    """A Theorem 2.1 computation: R applications of one round function.

    ``fn`` follows the :data:`repro_torch.core.mrmodel.RoundFn` contract
    ``f(round_idx, node_ids, mailbox) -> (dests, payload)`` with dests of
    shape (V, M_out); -1 entries mean "no item", ``dests[v, j] = v`` is the
    paper's "keep"."""

    fn: RoundFn
    n_rounds: int
    capacity: Optional[int] = None
    #: target mailbox node count per round (None = inherit the entry shape)
    n_nodes: Optional[int] = None


class MREngine:
    """Interface over the Theorem 2.1 round semantics.

    Subclasses provide :meth:`shuffle` — the capacity-bounded Shuffle step
    (flattened-source-order FIFO into slots 0..capacity-1, overflow dropped
    and counted) — while ``run_round`` / ``run_rounds`` / ``run_program`` /
    ``run_stages`` drive complete computations on top of it and account
    costs functionally.
    """

    name = "abstract"
    #: whether ``Executable.batch`` may run a batch's queries as one round
    #: program with a leading batch axis (the JAX package's ``vmappable``);
    #: otherwise it runs them one after another
    batchable = False
    #: where the engine's mailboxes and accumulators live
    device = torch.device("cpu")
    #: bound on the per-engine plan cache (see BoundedCache)
    cache_size = 128
    _cache = None
    #: observability hook: a no-op NullTracer by default
    tracer = NULL_TRACER

    def __init__(self, tracer=None):
        if tracer is not None:
            self.tracer = tracer

    # -- plan/compile/execute split (repro_torch.core.plan / .api) -----------
    def _ensure_cache(self):
        if self._cache is None:
            from .api import BoundedCache
            self._cache = BoundedCache(self.cache_size)
        return self._cache

    @staticmethod
    def plan_key(plan):
        """The cache key a plan compiles under (its fingerprint and its
        declared shape schedule)."""
        return ("plan", plan.fingerprint, plan.shape_fingerprint)

    def plan_cached(self, plan) -> bool:
        """Whether ``compile(plan)`` would be a cache hit right now (a
        read-only probe: no counters, no LRU touch)."""
        return self.plan_key(plan) in self._ensure_cache()

    def compile(self, plan):
        """Bind a :class:`~repro_torch.core.plan.Plan` to this backend.

        Returns the cached :class:`~repro_torch.core.api.Executable` when an
        equal-fingerprint plan was compiled before; the bounded cache evicts
        LRU and reports through :meth:`cache_info`."""
        from .api import Executable
        cache = self._ensure_cache()
        key = self.plan_key(plan)
        exe = cache.lookup(key)
        tr = self.tracer
        if exe is None:
            exe = cache.store(key, Executable(plan, self))
            if tr.enabled:
                tr.event("cache.miss", plan=plan.name, backend=self.name)
                tr.count("plan_cache.misses")
        elif tr.enabled:
            tr.event("cache.hit", plan=plan.name, backend=self.name)
            tr.count("plan_cache.hits")
        return exe

    def cache_info(self):
        """Hit/miss/eviction counters of this engine's bounded cache."""
        return self._ensure_cache().info()

    # -- backend layout hooks ------------------------------------------------
    def aligned_nodes(self, n_nodes: int) -> int:
        """Round a node count up to this backend's layout granularity."""
        return max(1, int(n_nodes))

    def node_ids(self, n_nodes: int) -> torch.Tensor:
        return torch.arange(n_nodes, dtype=torch.int32, device=self.device)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- the Shuffle step ----------------------------------------------------
    def shuffle(self, dests, payload: Payload, n_nodes: int,
                capacity: int) -> Tuple[Mailbox, RoundStats]:
        """Deliver item j to node ``dests[j]`` (< 0 = no item; entries must
        lie in [-1, n_nodes)).  FIFO by flattened source order; items ranked
        past ``capacity`` at their destination are dropped and counted in
        ``RoundStats.dropped`` — every backend reports the identical
        mailbox, drop set, and stats."""
        raise NotImplementedError

    def shuffle_batch(self, dests, payload: Payload, n_nodes: int,
                      capacity: int) -> Tuple[Mailbox, RoundStats]:
        """The Shuffle of B queries: ``dests`` (B, ...) and payload leaves
        (B, ...) in, a (B, n_nodes, capacity) mailbox and (B,) stats out,
        row b what :meth:`shuffle` gives for query b.  This base runs the
        rows one by one; an engine that is not :attr:`batchable` only sees
        B = 1 here (``Executable.batch`` loops over its single calls)."""
        return stack_rows([self.shuffle(dests[b],
                                        tree_map(lambda l: l[b], payload),
                                        n_nodes, capacity)
                           for b in range(len(dests))])

    # -- round drivers -------------------------------------------------------
    def run_round(self, f: RoundFn, box: Mailbox, round_idx,
                  capacity: Optional[int] = None,
                  n_nodes: Optional[int] = None, *, batched: bool = False
                  ) -> Tuple[Mailbox, RoundStats]:
        """One round: apply f at every node, then shuffle.

        ``n_nodes`` sets the target mailbox node count — a *shape-change
        round* when it differs from ``box.n_nodes``; ``f`` must then emit
        destinations in the target's numbering [0, n_nodes).  None keeps
        the current shape.

        ``batched=True`` runs B queries: ``box`` has (B, V, M) leaves, ``f``
        gets it whole with the (V,) node ids and emits (B, V, M_out)
        destinations, and the stats are (B,)."""
        cap = capacity if capacity is not None else box.capacity
        V = n_nodes if n_nodes is not None else box.n_nodes
        tr = self.tracer
        t0 = tr.clock() if tr.enabled else 0.0
        dests, payload = f(round_idx, self.node_ids(box.n_nodes), box)
        shuffle = self.shuffle_batch if batched else self.shuffle
        out_box, stats = shuffle(dests, payload, V, cap)
        if tr.enabled:
            _round_event(tr, t0, self.name, round_idx, V, cap,
                         stats_row(stats) if batched else stats)
        return out_box, stats

    def run_rounds(self, f: RoundFn, box: Mailbox, n_rounds: int,
                   capacity: Optional[int] = None,
                   accum: Optional[CostAccum] = None,
                   n_nodes: Optional[int] = None,
                   checkpointer=None, round_offset: int = 0,
                   early_dests: bool = False, *, batched: bool = False
                   ) -> Tuple[Mailbox, CostAccum]:
        """Drive R rounds, returning the final mailbox and accumulated cost.

        Every round runs at (n_nodes, capacity), so a first round whose
        target differs from the entry box is a shape-change round and the
        rest are shape-uniform.

        ``checkpointer`` (a :class:`repro_torch.core.recovery.Checkpointer`)
        activates the ``checkpoint_every`` policy: after each round the
        ``{"box", "accum"}`` state is offered to ``maybe_save`` under the
        global round index ``round_offset + r + 1`` — the round-boundary
        snapshot recovery replays from.  ``batched`` as in
        :meth:`run_round`.

        ``early_dests`` is the stage's declared scheduling bit
        (:class:`~repro_torch.core.plan.PlanStage`): True promises the
        destinations depend only on node ids and the static schedule,
        which lets :class:`ShardedEngine` overlap the rounds.  It never
        changes results; this base loop ignores it."""
        acc = accum if accum is not None else CostAccum.zero(
            self.device, tuple(box.valid.shape[:1]) if batched else ())
        for r in range(n_rounds):
            box, stats = self.run_round(f, box, r, capacity, n_nodes=n_nodes,
                                        batched=batched)
            acc = acc.add_round_stats(stats)
            if checkpointer is not None:
                checkpointer.maybe_save(round_offset + r + 1,
                                        {"box": box, "accum": acc})
        return box, acc

    def run_program(self, prog: RoundProgram, box: Mailbox,
                    accum: Optional[CostAccum] = None
                    ) -> Tuple[Mailbox, CostAccum]:
        return self.run_rounds(prog.fn, box, prog.n_rounds,
                               capacity=prog.capacity, accum=accum,
                               n_nodes=prog.n_nodes)

    def run_stages(self, stages, box: Mailbox,
                   accum: Optional[CostAccum] = None,
                   checkpointer=None, round_offset: int = 0
                   ) -> Tuple[Mailbox, CostAccum]:
        """Drive a heterogeneous round schedule: ``stages`` is a sequence of
        ``(round_fn, capacity)`` pairs, ``(round_fn, capacity, n_nodes)``
        triples or ``(round_fn, capacity, n_nodes, early_dests)``
        quadruples, each executed as one round.  ``checkpointer`` and
        ``round_offset`` as in :meth:`run_rounds`; this base loop ignores
        ``early_dests``."""
        acc = accum if accum is not None else CostAccum.zero(self.device)
        for r, stage in enumerate(stages):
            fn, cap = stage[0], stage[1]
            V = stage[2] if len(stage) > 2 else None
            box, stats = self.run_round(fn, box, r, capacity=cap, n_nodes=V)
            acc = acc.add_round_stats(stats)
            if checkpointer is not None:
                checkpointer.maybe_save(round_offset + r + 1,
                                        {"box": box, "accum": acc})
        return box, acc

    # -- host-side validity check -------------------------------------------
    def require_no_drops(self, accum: CostAccum, what: str = "program") -> None:
        """Host boundary: raise if any round overflowed mailbox capacity
        (the w.h.p. failure event of the paper's randomized algorithms).
        A batch's (B,) accumulator is read in one host read, and the error
        names the queries that dropped."""
        dropped = torch.as_tensor(accum.dropped).cpu()
        if dropped.ndim == 0:
            if int(dropped):
                raise RuntimeError(
                    f"{self.name} engine: {int(dropped)} items exceeded "
                    f"mailbox capacity while running {what}; raise the "
                    f"capacity")
            return
        rows = torch.nonzero(dropped).flatten().tolist()
        if rows:
            raise RuntimeError(
                f"{self.name} engine: queries {rows} of a batch of "
                f"{dropped.shape[0]} dropped {dropped[rows].tolist()} items "
                f"over mailbox capacity while running {what}; raise the "
                f"capacity")


# ---------------------------------------------------------------------------
# ReferenceEngine — numpy oracle
# ---------------------------------------------------------------------------

def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ReferenceEngine(MREngine):
    """Per-item host-loop shuffle: the executable spec the tensor backend is
    tested against.  Computes in numpy and hands back CPU tensors.  Slow on
    purpose; run it on small inputs."""

    name = "reference"

    def shuffle(self, dests, payload: Payload, n_nodes: int,
                capacity: int) -> Tuple[Mailbox, RoundStats]:
        dests = _numpy(dests)
        flat_dest = dests.reshape(-1)
        n = flat_dest.shape[0]
        leaves, structure = tree_flatten(payload)
        flat_leaves = [_numpy(l).reshape((n,) + _numpy(l).shape[dests.ndim:])
                       for l in leaves]
        out_leaves = [np.zeros((n_nodes, capacity) + fl.shape[1:], fl.dtype)
                      for fl in flat_leaves]
        valid = np.zeros((n_nodes, capacity), bool)
        recv_counts = np.zeros((n_nodes,), np.int64)
        dropped = 0
        for j in range(n):                       # FIFO: flattened source order
            d = int(flat_dest[j])
            if d < 0:
                continue
            r = int(recv_counts[d])
            recv_counts[d] += 1
            if r >= capacity:
                dropped += 1
                continue
            for fl, ol in zip(flat_leaves, out_leaves):
                ol[d, r] = fl[j]
            valid[d, r] = True
        if dests.ndim >= 2 and n:
            sent_per_node = np.sum(flat_dest.reshape(dests.shape[0], -1) >= 0,
                                   axis=1)
            max_sent = sent_per_node.max(initial=0)
        else:
            # n == 0 with a (V, M) send shape: no source node sent anything.
            max_sent = 0 if dests.ndim >= 2 else 1

        def i32(v):
            return torch.tensor(int(v), dtype=torch.int32)

        stats = RoundStats(items_sent=i32(np.sum(flat_dest >= 0)),
                           max_sent=i32(max_sent),
                           max_received=i32(recv_counts.max(initial=0)),
                           dropped=i32(dropped))
        box = Mailbox(payload=tree_unflatten(
            structure, [torch.from_numpy(o) for o in out_leaves]),
            valid=torch.from_numpy(valid))
        return box, stats


# ---------------------------------------------------------------------------
# LocalEngine — dense mailboxes on one device
# ---------------------------------------------------------------------------

class LocalEngine(MREngine):
    """Single-device backend on torch tensors, on the card unless the
    caller asks for the CPU (``device="cpu"``).  A CUDA device without CUDA
    raises here; the engine never carries on elsewhere.

    ``shuffle_impl`` selects the Shuffle (bit-identical either way):

    - ``"dense"`` (default): :func:`repro_torch.core.mrmodel.shuffle`;
    - ``"kernel"``: :func:`repro_torch.core.kshuffle.kernel_shuffle`, the
      multi-tile radix route on the ``bincount_tiles`` and ``bitonic_sort``
      kernels (their plain versions on the CPU).

    The kernel path's guards are re-derived per shuffle call from that
    call's (n, V) shape (:func:`repro_torch.core.kshuffle.kernel_fits`,
    budgets identical to the JAX package's): a call past them takes the
    dense shuffle, as the JAX engine does, and every decision is counted in
    this engine's ``route_log``.

    Inputs given as numpy arrays or tensors elsewhere move to the engine's
    device when they enter a shuffle.
    """

    name = "local"
    batchable = True

    def __init__(self, shuffle_impl: str = "dense", device="cuda",
                 tracer=None):
        super().__init__(tracer=tracer)
        if shuffle_impl not in ("dense", "kernel"):
            raise ValueError(f"shuffle_impl must be 'dense' or 'kernel', "
                             f"got {shuffle_impl!r}")
        self.device = as_device(device, "engine")
        self.shuffle_impl = shuffle_impl
        from .kshuffle import RouteLog
        self.route_log = RouteLog()
        if shuffle_impl == "kernel":
            from .kshuffle import kernel_fits, kernel_shuffle_batch
            self._kernel_fits = kernel_fits
            self._shuffle_fn = kernel_shuffle_batch
            self.name = "kernel"
        else:
            self._shuffle_fn = _dense_shuffle_batch

    def shuffle(self, dests, payload: Payload, n_nodes: int,
                capacity: int) -> Tuple[Mailbox, RoundStats]:
        dests = self._to_device(dests)
        payload = tree_map(self._to_device, payload)
        return unbatch_shuffle(*self.shuffle_batch(
            dests[None], tree_map(lambda l: l[None], payload), n_nodes,
            capacity))

    def shuffle_batch(self, dests, payload: Payload, n_nodes: int,
                      capacity: int) -> Tuple[Mailbox, RoundStats]:
        """B queries' shuffles as one: the kernel route launches one
        ``bincount_tiles`` and one ``bitonic_sort`` for the batch.  The
        route guard reads one query's (n, V), and the decision is counted
        once in ``route_log`` and recorded once as a ``shuffle.route``
        event, whatever B."""
        dests = self._to_device(dests)
        payload = tree_map(self._to_device, payload)
        fn = self._shuffle_fn
        if self.shuffle_impl == "kernel":
            n = dests[0].numel()
            if self._kernel_fits(n, n_nodes):
                impl = "kernel"
                self.route_log.kernel += 1
            else:
                impl = "dense"
                self.route_log.dense += 1
                fn = _dense_shuffle_batch   # per-call guard: oversize -> dense
            tr = self.tracer
            if tr.enabled:
                tr.trace_event("shuffle.route", impl=impl, n=n,
                               n_nodes=int(n_nodes), backend=self.name)
                tr.metrics.counter(f"shuffle.route.{impl}").inc()
        return fn(dests, payload, n_nodes, capacity)


# ---------------------------------------------------------------------------
# ShardedEngine — the Shuffle across the ranks of a process group
# ---------------------------------------------------------------------------

def _check_group(group, device: torch.device) -> Tuple[int, int]:
    """(size, rank) of ``group`` after checking that a process group is up,
    that this rank belongs to ``group``, and that its backend moves tensors
    of ``device``'s type: NCCL for ``cuda``, gloo for ``cpu``."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "ShardedEngine needs a torch.distributed process group: call "
            "torch.distributed.init_process_group first")
    if group is dist.GroupMember.NON_GROUP_MEMBER:
        raise ValueError("ShardedEngine: this rank is not in the group")
    backend = str(dist.get_backend(group))
    want = "nccl" if device.type == "cuda" else "gloo"
    # one backend ("gloo") or one a device type ("cpu:gloo,cuda:nccl")
    names = dict(p.split(":", 1) for p in backend.split(",")) \
        if ":" in backend else {device.type: backend}
    if names.get(device.type) != want:
        raise ValueError(
            f"ShardedEngine on {device.type} needs a {want} process group; "
            f"the group's backend is {backend!r}")
    return dist.get_world_size(group), dist.get_rank(group)


class ShardedEngine(MREngine):
    """The Shuffle across the ranks of a ``torch.distributed`` group: nodes
    are partitioned contiguously (rank s owns nodes [s V/k, (s+1) V/k))
    and each Shuffle runs as two phases:

      1. **hop** — a lossless keyed all-to-all
         (:func:`repro_torch.core.distributed.keyed_hop`, per-pair
         capacity the rank's item count) delivers every item to its owner
         rank in source-rank order;
      2. **scatter** — the per-rank local shuffle (dense or the kernels)
         places the arrivals into the owner's (V/k, capacity) slots, and
         an all-gather of those blocks rebuilds the mailbox.

    Every rank runs the same plan on the same inputs and seeds and holds
    the whole (V, capacity) mailbox between rounds, so round functions and
    stage bodies run unchanged; rank s hops only its contiguous slice of
    sources, ``[s n/k, (s+1) n/k)`` of the flattened leading dim, and
    scatters only the nodes it owns.  Because sources are contiguous and
    the hop keeps source order, the composition is exactly the global FIFO
    and overflow semantics of :class:`LocalEngine` at any group size, and
    every rank returns the same result.

    ``n_shards`` is the group's size and ``shard`` this rank.  Node counts
    and the leading dim of per-node sends must be divisible by
    ``n_shards`` (grow V with :meth:`aligned_nodes`); 1-D sends are padded
    with "no item".  The engine does not start the process group: the
    caller does, with the backend that moves ``device``'s tensors (NCCL
    for ``cuda``, gloo for ``cpu``), and the engine raises otherwise.

    ``shuffle_impl`` selects the scatter: ``"dense"`` or ``"kernel"`` (the
    CUDA kernels of :func:`repro_torch.core.kshuffle.kernel_shuffle`, their
    plain versions on the CPU), guarded per call by
    :func:`~repro_torch.core.kshuffle.kernel_fits` at (n, V/k) and counted
    in the engine's ``route_log``.

    For stages declared ``early_dests`` the overridden :meth:`run_rounds`
    and :meth:`run_stages` issue a window of rounds with no host read
    between them and fold the rounds' stats at the end, in issue order, so
    ``CostAccum`` equals the sequential schedule's bit for bit;
    ``overlap=False`` keeps the sequential schedule (the comparator), and
    a checkpointer forces it.  Rounds issued so count in
    ``route_log.overlapped``.
    """

    name = "sharded"
    batchable = False

    def __init__(self, group=None, shuffle_impl: str = "dense",
                 device="cuda", tracer=None, overlap: bool = True):
        super().__init__(tracer=tracer)
        if shuffle_impl not in ("dense", "kernel"):
            raise ValueError(f"shuffle_impl must be 'dense' or 'kernel', "
                             f"got {shuffle_impl!r}")
        self.device = as_device(device, "engine")
        self.group = group
        self.n_shards, self.shard = _check_group(group, self.device)
        self.shuffle_impl = shuffle_impl
        #: issue early_dests rounds as one window (False = the sequential
        #: per-round schedule, the comparator of the parity tests)
        self.overlap = overlap
        from .kshuffle import RouteLog, kernel_fits, kernel_shuffle
        self.route_log = RouteLog()
        self._kernel_fits = kernel_fits
        self._kernel_shuffle = kernel_shuffle

    def aligned_nodes(self, n_nodes: int) -> int:
        return -(-max(1, int(n_nodes)) // self.n_shards) * self.n_shards

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def shuffle(self, dests, payload: Payload, n_nodes: int,
                capacity: int) -> Tuple[Mailbox, RoundStats]:
        box, stats, _ = self._shuffle_phased(dests, payload, n_nodes,
                                             capacity)
        return box, stats

    def _shuffle_phased(self, dests, payload: Payload, n_nodes: int,
                        capacity: int, measure: bool = False
                        ) -> Tuple[Mailbox, RoundStats, Tuple[float, float]]:
        """The two-phase Shuffle of one query, with no host read.
        ``measure=True`` synchronizes after each phase and returns the
        (hop_s, scatter_s) wall seconds: the calibration probe the
        overlapped schedule runs once a window."""
        import torch.distributed as dist
        from .distributed import all_gather, all_reduce, keyed_hop
        k = self.n_shards
        if n_nodes % k:
            raise ValueError(
                f"n_nodes={n_nodes} must be divisible by the group size {k}; "
                f"use aligned_nodes()")
        dests = self._to_device(dests)
        leaves, structure = tree_flatten(payload)
        leaves = [self._to_device(l) for l in leaves]
        if dests.shape[0] % k:
            if dests.ndim != 1:
                raise ValueError(
                    f"leading dim {dests.shape[0]} must be divisible by the "
                    f"group size {k} for per-node sends")
            # 1-D entry shuffles: pad with "no item", semantics unchanged
            pad = k - dests.shape[0] % k
            dests = torch.cat([dests, dests.new_full((pad,), -1)])
            leaves = [torch.cat([l, l.new_zeros((pad,) + tuple(l.shape[1:]))])
                      for l in leaves]
        # The kernel guard, taken again on every call: the scatter sees k
        # times the rank's item count, into V/k nodes.
        local_v = n_nodes // k
        use_kernel = False
        if self.shuffle_impl == "kernel":
            n = dests.numel()
            use_kernel = self._kernel_fits(n, local_v)
            impl = "kernel" if use_kernel else "dense"
            if use_kernel:
                self.route_log.kernel += 1
            else:
                self.route_log.dense += 1
            tr = self.tracer
            if tr.enabled:
                tr.trace_event("shuffle.route", impl=impl, n=n,
                               n_nodes=int(n_nodes), backend=self.name)
                tr.metrics.counter(f"shuffle.route.{impl}").inc()
        clock = self.tracer.clock
        t0 = clock() if measure else 0.0
        # Phase 1 — the hop of this rank's contiguous sources.
        per = dests.shape[0] // k
        mine = slice(self.shard * per, (self.shard + 1) * per)
        local_dest, recv_flat = keyed_hop(dests[mine],
                                          [l[mine] for l in leaves],
                                          self.group, n_nodes)
        hop_s = 0.0
        if measure:
            self._sync()
            hop_s = clock() - t0
        t1 = clock() if measure else 0.0
        # Phase 2 — the scatter into the owned (V/k, capacity) block, the
        # group's stats, and the all-gather of the blocks.
        scatter = self._kernel_shuffle if use_kernel else _dense_shuffle
        block, st = scatter(local_dest, recv_flat, local_v, capacity)
        sent = dests[mine] >= 0
        if dests.ndim > 1 and sent.numel():
            max_sent = sent.reshape(per, -1).sum(1).max().to(torch.int32)
        else:
            # 1-D sends count as one source; empty (V, M) sends have none
            max_sent = torch.tensor(0 if dests.ndim > 1 else 1,
                                    dtype=torch.int32, device=self.device)
        sums = all_reduce(torch.stack([sent.sum().to(torch.int32),
                                       st.dropped]), group=self.group)
        maxes = all_reduce(torch.stack([max_sent, st.max_received]),
                           dist.ReduceOp.MAX, self.group)
        out_leaves = [all_gather(l, self.group) for l in block.payload]
        valid = all_gather(block.valid, self.group)
        scatter_s = 0.0
        if measure:
            self._sync()
            scatter_s = clock() - t1
        stats = RoundStats(items_sent=sums[0], max_sent=maxes[0],
                           max_received=maxes[1], dropped=sums[1])
        box = Mailbox(payload=tree_unflatten(structure, out_leaves),
                      valid=valid)
        return box, stats, (hop_s, scatter_s)

    def _phased_rows(self, dests, payload: Payload, n_nodes: int,
                     capacity: int, measure: bool = False
                     ) -> Tuple[Mailbox, RoundStats, Tuple[float, float]]:
        """B queries' two-phase shuffles one after another (the engine is
        not batchable): the (B, ...) box and stats, and the first query's
        phase seconds."""
        rows = [self._shuffle_phased(dests[b],
                                     tree_map(lambda l: l[b], payload),
                                     n_nodes, capacity, measure)
                for b in range(len(dests))]
        box, stats = stack_rows([row[:2] for row in rows])
        return box, stats, rows[0][2]

    # -- the overlapped schedule ----------------------------------------------
    def run_rounds(self, f: RoundFn, box: Mailbox, n_rounds: int,
                   capacity: Optional[int] = None,
                   accum: Optional[CostAccum] = None,
                   n_nodes: Optional[int] = None,
                   checkpointer=None, round_offset: int = 0,
                   early_dests: bool = False, *, batched: bool = False
                   ) -> Tuple[Mailbox, CostAccum]:
        if not (early_dests and self.overlap) or checkpointer is not None \
                or n_rounds <= 0:
            # Data-dependent destinations, the sequential comparator, or a
            # checkpointer (round-boundary snapshots need every round's
            # state): the base per-round schedule.
            return super().run_rounds(f, box, n_rounds, capacity, accum,
                                      n_nodes=n_nodes,
                                      checkpointer=checkpointer,
                                      round_offset=round_offset,
                                      batched=batched)
        window = [(f, capacity, n_nodes, r) for r in range(n_rounds)]
        return self._run_overlapped(window, box, accum, batched)

    def run_stages(self, stages, box: Mailbox,
                   accum: Optional[CostAccum] = None,
                   checkpointer=None, round_offset: int = 0
                   ) -> Tuple[Mailbox, CostAccum]:
        if checkpointer is not None or not self.overlap:
            return super().run_stages(stages, box, accum=accum,
                                      checkpointer=checkpointer,
                                      round_offset=round_offset)
        acc = accum if accum is not None else CostAccum.zero(self.device)
        stages = list(stages)
        i = 0
        while i < len(stages):
            if not (len(stages[i]) > 3 and stages[i][3]):
                fn, cap = stages[i][0], stages[i][1]
                V = stages[i][2] if len(stages[i]) > 2 else None
                box, stats = self.run_round(fn, box, i, capacity=cap,
                                            n_nodes=V)
                acc = acc.add_round_stats(stats)
                i += 1
                continue
            # A maximal run of consecutive early_dests rounds is one window
            # (each round keeps its index in the schedule).
            window = []
            while i < len(stages) and len(stages[i]) > 3 and stages[i][3]:
                s = stages[i]
                window.append((s[0], s[1], s[2] if len(s) > 2 else None, i))
                i += 1
            box, acc = self._run_overlapped(window, box, acc, False)
        return box, acc

    def _run_overlapped(self, window, box: Mailbox, accum, batched: bool
                        ) -> Tuple[Mailbox, CostAccum]:
        """Issue a window of ``(fn, capacity, n_nodes, round_idx)`` rounds
        with no host read between them: each round's stats stay on the
        device, in issue order, and fold into the accumulator at the end,
        so the ``CostAccum`` equals the sequential schedule's bit for bit.

        With a live tracer the first round is a calibration probe,
        synchronized after ``fn``, the hop and the scatter to measure the
        phases' own costs; each round records ``pipeline.hop`` (reading no
        device value) and the window one ``pipeline.overlap`` carrying its
        wall time beside the probe's ``hop_s`` and ``compute_s``."""
        acc = accum if accum is not None else CostAccum.zero(
            self.device, tuple(box.valid.shape[:1]) if batched else ())
        tr = self.tracer
        live = tr.enabled
        clock = tr.clock
        t_start = clock() if live else 0.0
        calibrated = not live
        hop_s = compute_s = 0.0
        pending = []
        self.route_log.overlapped += len(window)
        for fn, capacity, n_nodes, r in window:
            cap = capacity if capacity is not None else box.capacity
            V = n_nodes if n_nodes is not None else box.n_nodes
            measure = not calibrated
            t_f = clock() if measure else 0.0
            dests, payload = fn(r, self.node_ids(box.n_nodes), box)
            f_s = 0.0
            if measure:
                self._sync()
                f_s = clock() - t_f
            phased = self._phased_rows if batched else self._shuffle_phased
            box, st, spans = phased(dests, payload, V, cap, measure=measure)
            pending.append(st)
            if measure:
                calibrated = True
                hop_s = spans[0]
                compute_s = f_s + spans[1]
            if live:
                tr.event("pipeline.hop", round=int(r), n_nodes=int(V),
                         capacity=int(cap), backend=self.name)
                tr.count("pipeline.hops")
        for st in pending:
            acc = acc.add_round_stats(st)
        if live:
            self._sync()
            tr.event("pipeline.overlap", _dur=clock() - t_start,
                     rounds=len(window), backend=self.name,
                     hop_s=hop_s, compute_s=compute_s)
            tr.count("pipeline.overlaps")
        return box, acc


@functools.lru_cache(maxsize=1)
def default_engine() -> MREngine:
    """The engine algorithms fall back to when none is passed: a shared
    dense LocalEngine on the card (raises where there is no CUDA)."""
    return LocalEngine()


def get_engine(name: str, **kwargs) -> MREngine:
    """Engine factory.  Registered names:

    - ``"reference"`` — :class:`ReferenceEngine`, numpy per-item host loop;
    - ``"local"`` — :class:`LocalEngine`, dense torch shuffles;
    - ``"kernel"`` — :class:`LocalEngine` with ``shuffle_impl="kernel"``:
      the shuffle runs the hand-written CUDA kernels;
    - ``"pallas"`` — the JAX package's name for ``"kernel"``;
    - ``"sharded"`` — :class:`ShardedEngine`, the Shuffle across the ranks
      of a ``torch.distributed`` group the caller has started.

    >>> get_engine("local", device="cpu").name
    'local'
    >>> get_engine("pallas", device="cpu").shuffle_impl
    'kernel'
    """
    kernel = functools.partial(LocalEngine, shuffle_impl="kernel")
    engines = {"reference": ReferenceEngine, "local": LocalEngine,
               "kernel": kernel, "pallas": kernel, "sharded": ShardedEngine}
    if name not in engines:
        raise ValueError(f"unknown engine {name!r}; pick from {sorted(engines)}")
    return engines[name](**kwargs)
