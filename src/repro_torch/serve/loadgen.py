"""Closed- and open-loop load generation for :class:`QueryService`.

The port of the JAX package's ``repro.serve.loadgen``: a deterministic,
config-driven traffic mix, a sequential one-query-per-call baseline, and
an offered-load driver.

Three drivers over one seeded workload:

- :func:`run_sequential` — the baseline: every query is one
  ``exe(*inputs, key=...)`` call on a compiled executable, in arrival
  order.  What a caller without the service pays.
- :func:`run_closed_loop` — a backlogged closed loop: up to
  ``concurrency`` queries are outstanding at once; on :class:`QueueFull`
  the client dispatches the oldest queue and resubmits.  Measures
  coalesced throughput.
- :func:`run_open_loop` — arrivals at a fixed offered rate on a
  :class:`VirtualClock`; batch execution is instantaneous in virtual time,
  so the measured latencies isolate the *queueing* behavior of the
  batching window and are deterministic across machines.

The workload draws the same families and inputs as the JAX package's for
the same :class:`TrafficConfig` (one numpy generator, the same draws in the
same order).  Its keys differ: the JAX package splits a PRNG key per
query, the port draws one int seed per query from the same generator after
the inputs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._tree import tree_leaves
from .mr import QueryService, QueueFull, VirtualClock, _synchronize


@dataclasses.dataclass
class Query:
    """One generated request: which plan family, its inputs, its key."""

    uid: int
    family: str
    plan: Any
    inputs: Tuple
    key: Any


@dataclasses.dataclass
class TrafficConfig:
    """The deterministic workload knobs (the JAX package's defaults).

    The default sizes sit in the dispatch-bound regime (small per-query
    programs, many of them) — the regime a query service exists for."""

    families: Tuple[str, ...] = ("sort", "multisearch", "hull2d", "lp")
    n_queries: int = 192
    seed: int = 0
    sort_n: int = 128
    sort_M: int = 64
    ms_queries: int = 32
    ms_pivots: int = 8
    ms_M: int = 8
    hull_n: int = 32
    hull_M: int = 8
    lp_n: int = 8
    lp_d: int = 2
    lp_M: int = 16


def make_suite(engine, cfg: TrafficConfig) -> Dict[str, Tuple[Any, Callable]]:
    """Build one plan per family plus its seeded input sampler.

    Returns ``{family: (plan, sample(rng) -> inputs)}``; the plan is built
    once (static parameters only), the sampler draws fresh query data per
    request from a numpy generator, as the JAX package's does, and hands
    it over as tensors on the engine's device."""
    from ..core.api import (hull2d_plan, lp_plan, multisearch_plan,
                            sort_plan)
    dev = engine.device

    def on_device(*arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    suite: Dict[str, Tuple[Any, Callable]] = {}
    if "sort" in cfg.families:
        plan = sort_plan(cfg.sort_n, cfg.sort_M, align=engine.aligned_nodes)
        suite["sort"] = (plan, lambda rng: on_device(
            rng.normal(size=cfg.sort_n).astype(np.float32)))
    if "multisearch" in cfg.families:
        plan = multisearch_plan(cfg.ms_queries, cfg.ms_pivots, cfg.ms_M,
                                align=engine.aligned_nodes)
        suite["multisearch"] = (plan, lambda rng: on_device(
            rng.normal(size=cfg.ms_queries).astype(np.float32),
            np.sort(rng.normal(size=cfg.ms_pivots).astype(np.float32))))
    if "hull2d" in cfg.families:
        plan = hull2d_plan(cfg.hull_n, cfg.hull_M, align=engine.aligned_nodes)
        suite["hull2d"] = (plan, lambda rng: on_device(
            rng.normal(size=(cfg.hull_n, 2)).astype(np.float32)))
    if "lp" in cfg.families:
        plan = lp_plan(cfg.lp_n, cfg.lp_d, cfg.lp_M)
        suite["lp"] = (plan, lambda rng: on_device(
            np.arange(1, cfg.lp_d + 1, dtype=np.float32),
            rng.normal(size=(cfg.lp_n, cfg.lp_d)).astype(np.float32),
            rng.uniform(1.0, 2.0, cfg.lp_n).astype(np.float32)))
    missing = set(cfg.families) - set(suite)
    if missing:
        raise ValueError(f"unknown traffic families: {sorted(missing)}")
    return suite


def make_workload(suite: Dict[str, Tuple[Any, Callable]],
                  cfg: TrafficConfig) -> List[Query]:
    """The seeded request stream: families interleaved by a seeded draw
    (every run of the same config replays the identical arrival mix), then
    one int seed per query from the same generator."""
    rng = np.random.default_rng(cfg.seed)
    fams = sorted(suite)
    drawn = []
    for _ in range(cfg.n_queries):
        fam = fams[int(rng.integers(0, len(fams)))]
        drawn.append((fam, suite[fam][1](rng)))
    seeds = rng.integers(0, 2**31 - 1, size=cfg.n_queries)
    return [Query(uid=i, family=fam, plan=suite[fam][0], inputs=inputs,
                  key=int(seeds[i]))
            for i, (fam, inputs) in enumerate(drawn)]


def _flatten(result) -> List[np.ndarray]:
    return [leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tree_leaves(result)]


def assert_results_equal(a: Dict[int, Any], b: Dict[int, Any],
                         what: str) -> None:
    """Bit-identity check between two uid -> result maps."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: uid sets differ")
    for uid in a:
        la, lb = _flatten(a[uid]), _flatten(b[uid])
        if len(la) != len(lb):
            raise AssertionError(f"{what}: query {uid} has another "
                                 f"structure than the baseline")
        for x, y in zip(la, lb):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(
                    f"{what}: query {uid} diverged from the baseline")


def run_sequential(engine, workload: Sequence[Query],
                   timer: Callable[[], float] = time.perf_counter):
    """The one-query-per-call baseline: compiled executables, no batching.

    Returns ``(results, wall_s, latencies_s)`` — results keyed by query
    uid, per-query wall latencies in submission order, each ending in a
    device synchronize.  Each family's executable runs twice before the
    clock starts, as a warmed service's would have."""
    exes = {fam: engine.compile(plan)
            for fam, (plan, _) in _suite_of(workload).items()}
    for q in workload[:len(exes) * 2]:
        exes[q.family](*q.inputs, key=q.key)
    _synchronize(engine.device)
    results, lat = {}, []
    t0 = timer()
    for q in workload:
        t1 = timer()
        results[q.uid] = exes[q.family](*q.inputs, key=q.key)
        _synchronize(engine.device)
        lat.append(timer() - t1)
    return results, timer() - t0, lat


def run_closed_loop(service: QueryService, workload: Sequence[Query],
                    concurrency: int = 64,
                    timer: Callable[[], float] = time.perf_counter):
    """Backlogged closed loop: keep up to ``concurrency`` queries
    outstanding; recover from :class:`QueueFull` by dispatching the oldest
    queue (then retrying the submit).  Returns ``(results, wall_s)``, the
    wall time ending in a device synchronize."""
    tickets = []
    t0 = timer()
    for q in workload:
        while service.pending >= concurrency:
            service.dispatch_oldest()
        while True:
            try:
                tickets.append(service.submit(q.plan, *q.inputs, key=q.key))
                break
            except QueueFull:
                if service.dispatch_oldest() == 0:
                    raise          # nothing to free: a config error
    service.drain()
    _synchronize(service.engine.device)
    wall = timer() - t0
    results = {q.uid: t.value for q, t in zip(workload, tickets)}
    return results, wall


def arrival_times(n: int, offered_qps: float, process: str = "deterministic",
                  seed: int = 0) -> np.ndarray:
    """Arrival schedule (seconds) for ``n`` open-loop requests.

    ``"deterministic"`` spaces arrivals exactly ``1/offered_qps`` apart;
    ``"poisson"`` draws i.i.d. exponential inter-arrival gaps of mean
    ``1/offered_qps`` from ``default_rng(seed)``.  Both are deterministic
    functions of ``(n, offered_qps, process, seed)`` and equal the JAX
    package's."""
    if process == "deterministic":
        return np.arange(n, dtype=np.float64) / float(offered_qps)
    if process == "poisson":
        gaps = np.random.default_rng(seed).exponential(
            1.0 / float(offered_qps), size=n)
        return np.cumsum(gaps)
    raise ValueError(f"unknown arrival process {process!r} "
                     f"(want 'deterministic' or 'poisson')")


def run_open_loop(service: QueryService, workload: Sequence[Query],
                  offered_qps: float, clock: VirtualClock, *,
                  process: str = "deterministic",
                  seed: int = 0) -> Dict[str, Any]:
    """Open-loop arrivals at ``offered_qps`` on the service's virtual
    clock; rejected arrivals are dropped (counted), not retried.

    Execution is instantaneous in virtual time, so per-query latency is
    pure batching-window queueing delay.  Returns the row dict; when the
    service carries a live tracer, the row includes its metrics snapshot
    under ``"metrics"``."""
    if service.clock is not clock:
        raise ValueError("run_open_loop needs the service to run on the "
                         "given VirtualClock")
    arrivals = arrival_times(len(workload), offered_qps, process, seed)
    accepted, rejected = [], 0
    for q, t_arr in zip(workload, arrivals):
        if t_arr > clock():
            clock.advance(t_arr - clock())
        service.step()
        try:
            accepted.append(service.submit(q.plan, *q.inputs, key=q.key))
        except QueueFull:
            rejected += 1
    # Let the last deadlines expire, then flush.
    clock.advance(service.max_wait_ms / 1e3)
    service.step()
    service.drain()
    lat_ms = np.asarray([t.latency for t in accepted], np.float64) * 1e3
    occ = [t.batch_occupancy for t in accepted]
    row = {
        "offered_qps": float(offered_qps),
        "process": process,
        "accepted": len(accepted), "rejected": rejected,
        "p50_wait_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms)
        else None,
        "p99_wait_ms": float(np.percentile(lat_ms, 99)) if len(lat_ms)
        else None,
        "mean_occupancy": float(np.mean(occ)) if occ else None,
    }
    if service.tracer.enabled:
        row["metrics"] = service.tracer.metrics.snapshot()
    return row


def _suite_of(workload: Sequence[Query]) -> Dict[str, Tuple[Any, Callable]]:
    """Recover {family: (plan, None)} from a workload (plans are shared
    per family by construction)."""
    suite: Dict[str, Tuple[Any, Callable]] = {}
    for q in workload:
        suite.setdefault(q.family, (q.plan, None))
    return suite


__all__ = ["Query", "TrafficConfig", "make_suite", "make_workload",
           "arrival_times", "run_sequential", "run_closed_loop",
           "run_open_loop", "assert_results_equal"]
