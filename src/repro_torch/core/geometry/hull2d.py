"""2-D convex hull as a pure engine round program (paper §1.4 + §4.3).

Round structure (all shapes static; runs unchanged on every engine):

  0. pivot stage — x-quantile splitters from a random sample (the §4.3
     pivot construction, shared with ``sort_plan`` via
     :func:`repro_torch.core.sortmr.quantile_splitters`), accounted as its
     O(log_M s) rounds;
  1. entry shuffle — every point routed to the reducer owning its x-bucket
     (disjoint x-ranges, <= M points each w.h.p.; overflow is the reported
     ``stats.dropped`` event);
  2. d-ary merge tree, one engine round per level: every active node
     lex-sorts its padded run, reduces it with the monotone chain
     (:mod:`.chain`, one kernel call over the whole mailbox), and sends its
     partial hull to the leader of its a-block; height ceil(log_a V) with
     a = max(2, M/2), so O(log_M N) rounds total;
  3. finalize round — the root re-sorts, chains, and keeps the hull at
     itself in CCW order (FIFO slots preserve it).

Merge capacities grow as min(n, a^k * cap0) — the worst case when every
point is extreme — so the tree itself can never drop; only the randomized
bucket stage carries the w.h.p. failure event, exactly as in the paper.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..costmodel import CostAccum, MRCost, log_M, tree_height
from ..plan import Plan, account_stage, entry_stage, round_stage
from ..sortmr import batch_splitters, pivot_sample_size
from .chain import hull_of_runs


class EngineHullResult(NamedTuple):
    """Hull output: fixed-shape padded vertices + count."""

    points: torch.Tensor  # (cap, 2) float32; rows [count:] are zero padding
    count: torch.Tensor   # 0-d int32 — number of hull vertices
    stats: CostAccum      # valid iff stats.dropped == 0


def hull2d_plan(n: int, M: int, *, oversample: int = 8, slack: float = 3.0,
                n_nodes: Optional[int] = None, align=None,
                shape: bool = True) -> Plan:
    """2-D convex hull (CCW from the lexicographic minimum) as a plan
    builder — the module-docstring round structure as a static stage table:
    pivot-sort accounting, the x-bucket entry shuffle, one named stage per
    d-ary merge level (capacities growing as min(n, a^k * cap0) — the
    all-points-extreme worst case, so the tree itself can never drop), and
    the finalize round.  Input at execute time: ``(points,)`` of shape
    (n, 2); PRNG slot ``"splitters"`` drives the §4.3 pivot sample and is
    read as :func:`repro_torch.core.sortmr.sample_indices` reads it.

    ``shape=True`` (default) emits the *shape-scheduled* merge tree: level
    k runs in its own physical mailbox of V_k = ceil(V / a^k)
    compactly-numbered nodes, so the footprint shrinks geometrically with
    the live node set.  ``shape=False`` keeps the frozen entry shape
    (V, cap_k) at every level.  The two variants give the same outputs and
    the same per-round stats on every backend.

    ``n_nodes`` overrides the reducer count; ``align`` applies a backend's
    granularity to the default count.
    """
    n, M = int(n), int(M)
    if n == 0:
        return Plan(
            name="hull2d", fingerprint=("hull2d-trivial", 0), n_nodes=1,
            stages=(),
            prologue=lambda inputs, keys, device: {
                "pts": torch.zeros((len(keys), 0, 2), dtype=torch.float32,
                                   device=device)},
            epilogue=lambda st: EngineHullResult(
                points=st.carry["pts"],
                count=torch.zeros(st.carry["pts"].shape[:1],
                                  dtype=torch.int32,
                                  device=st.carry["pts"].device),
                stats=st.accum),
            round_bound=0)      # no input_spec: any empty input is accepted
    M_eff = max(2, M)
    if n_nodes is not None:
        V = int(n_nodes)
    else:
        V = max(1, -(-n // M_eff))
        if align is not None:
            V = int(align(V))
    a = max(2, M_eff // 2)                       # merge-tree arity
    n_levels = tree_height(V, a) if V > 1 else 0
    s = pivot_sample_size(n, V, oversample)      # static, = runtime sample
    piv_rounds = max(1, log_M(max(s, 2), M_eff))
    cap0 = min(n, max(1, int(math.ceil(slack * n / V))))
    fingerprint = ("hull2d", n, M, V, oversample, float(slack), bool(shape))

    def prologue(inputs, keys, device):
        pts = torch.as_tensor(inputs[0], dtype=torch.float32, device=device)
        splitters, _ = batch_splitters(pts[..., 0].contiguous(), V,
                                       oversample,
                                       [k["splitters"] for k in keys])
        return {"pts": pts, "splitters": splitters}

    def emit_entry(carry):
        pts = carry["pts"]
        bucket = torch.searchsorted(carry["splitters"],
                                    pts[..., 0].contiguous(), right=False)
        return bucket.clamp(0, V - 1).to(torch.int32), pts

    def make_chain_and_send(block: int, compact: bool):
        # Every active node reduces its run with the monotone chain and
        # sends its partial hull to its a-block's leader.  Frozen numbering:
        # the leader keeps its original id (ids // block) * block; compact
        # (shape-scheduled) numbering: level k+1's node j' receives from
        # level k's nodes [j'*a, (j'+1)*a) — same groups, same stats, the
        # mailbox just has no dead rows.
        def make_fn(carry):
            def fn(r, ids, b):
                hulls, h = hull_of_runs(b.payload, b.valid)
                leader = ids // a if compact else (ids // block) * block
                slot = torch.arange(hulls.shape[-2], dtype=torch.int32,
                                    device=hulls.device)
                dests = torch.where(slot < h[..., None], leader[:, None], -1)
                return dests.to(torch.int32), hulls
            return fn
        return make_fn

    def make_finalize(carry):
        def finalize(r, ids, b):
            hulls, h = hull_of_runs(b.payload, b.valid)
            slot = torch.arange(hulls.shape[-2], dtype=torch.int32,
                                device=hulls.device)
            dests = torch.where(slot < h[..., None], ids[:, None], -1)
            return dests.to(torch.int32), hulls
        return finalize

    stages = [account_stage("pivot-sort",
                            ((s, min(s, M_eff)),) * piv_rounds),
              entry_stage("entry", V, cap0, emit_entry)]
    cap = cap0
    v_level = V                                  # live nodes entering level k
    for k in range(n_levels):
        cap = min(n, a * cap)
        v_level = -(-v_level // a)               # live nodes after the merge
        # early_dests: merge-tree leaders are functions of node id and the
        # level's static block size alone.
        stages.append(round_stage(f"merge-{k}",
                                  make_chain_and_send(a ** (k + 1), shape), 1,
                                  capacity=cap,
                                  n_nodes=v_level if shape else None,
                                  early_dests=True))
    stages.append(round_stage("finalize", make_finalize, 1, capacity=cap,
                              n_nodes=v_level if shape else None,
                              early_dests=True))

    def epilogue(state):
        box = state.box
        count = box.valid[:, 0].sum(-1).to(torch.int32)
        return EngineHullResult(points=box.payload[:, 0], count=count,
                                stats=state.accum)

    return Plan(name="hull2d", fingerprint=fingerprint, n_nodes=V,
                stages=tuple(stages), prologue=prologue, epilogue=epilogue,
                round_bound=piv_rounds + 1 + n_levels + 1,
                prng_slots=("splitters",), default_seed=7,
                input_spec=(((n, 2), None),))


def _engine_or_default(engine):
    if engine is None:
        from ..engine import default_engine
        engine = default_engine()
    return engine


def convex_hull_2d_mr(points, M: int, *, engine=None, key=None,
                      n_nodes: Optional[int] = None,
                      slack: float = 3.0, oversample: int = 8
                      ) -> EngineHullResult:
    """Deprecated wrapper over :func:`hull2d_plan`: builds the plan,
    compiles it on ``engine`` (cached per fingerprint; default: the shared
    engine on the card) and runs it on ``points`` (n, 2).  Prefer the plan
    API (repro_torch.core.api)."""
    from ..api import deprecated_entry
    deprecated_entry("convex_hull_2d_mr", "hull2d_plan")
    engine = _engine_or_default(engine)
    pts = torch.as_tensor(points, dtype=torch.float32)
    plan = hull2d_plan(pts.shape[0], M, oversample=oversample, slack=slack,
                       n_nodes=n_nodes, align=engine.aligned_nodes)
    return engine.compile(plan)(pts, key=key)


def convex_hull_2d(points, M: int, *, engine=None, key=None,
                   cost: Optional[MRCost] = None,
                   slack: float = 3.0) -> np.ndarray:
    """Host wrapper: trimmed (h, 2) float64 hull, CCW from the lex-min.

    Enforces the strict model (raises on mailbox overflow — raise ``slack``
    if the randomized bucket stage fires) and feeds the ``cost`` adapter.
    Runs on ``engine`` (default: the shared engine on the card).
    """
    engine = _engine_or_default(engine)
    pts = torch.as_tensor(points, dtype=torch.float32)
    plan = hull2d_plan(pts.shape[0], M, slack=slack,
                       align=engine.aligned_nodes)
    res = engine.compile(plan)(pts, key=key)
    engine.require_no_drops(res.stats, what="2-D convex hull")
    if cost is not None:
        cost.absorb(res.stats)
    h = int(res.count)
    return res.points[:h].cpu().numpy().astype(np.float64)


def hull_round_bound(n: int, M: int, oversample: int = 8,
                     n_nodes: Optional[int] = None) -> int:
    """Concrete ceiling for the engine hull's round count: pivot-sort rounds
    + entry shuffle + merge-tree height + finalize (the paper's O(log_M N)).

    The default reducer count matches ``convex_hull_2d_mr`` on backends
    whose ``aligned_nodes`` is the identity (every engine of the port)."""
    M_eff = max(2, int(M))
    V = int(n_nodes) if n_nodes is not None else max(1, -(-n // M_eff))
    s = min(n, max(2, V * oversample))
    a = max(2, M_eff // 2)
    return (max(1, log_M(max(s, 2), M_eff)) + 1
            + (tree_height(V, a) if V > 1 else 0) + 1)
