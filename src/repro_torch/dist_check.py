"""Multi-rank checks of the sharded round machine on CPU ranks over gloo.

    python -m repro_torch.dist_check --world 4 --out DIR [--keys KEYS.npz]
        [--cases shuffle,rounds,...] [--timeout SECONDS] [--check]

starts ``--world`` processes, one a rank, over a ``file://`` store in DIR.
Each rank runs the named cases (all by default) on
``ShardedEngine(device="cpu")`` and writes what it computed to
``DIR/rank<r>.npz``, one entry a tensor under ``<case>/<variant>/<leaf>``
(an output or ``CostAccum`` leaf) or ``<case>/<variant>/#<name>`` (a count
or flag).  Rank 0 also runs each case on ``LocalEngine(device="cpu")``, the
variant ``local``.  The launcher exits 0 when every rank did and 1 with the
ranks' errors otherwise; a rank that fails ends the others at once, and
``--timeout`` bounds the whole run.  With ``--check`` it then holds every
rank's entries equal to rank 0's and every sharded variant equal, bit for
bit, to ``local``.  It prints one JSON line.  Case ``moe`` runs the MoE
layer's ``shuffle`` dispatch with the experts sharded over the ranks
(variant ``shuffle``) and, on rank 0, the ``einsum`` dispatch (variant
``einsum``), at each of ``MOE_CFS``.

The training cases run the mesh ``Trainer`` (:mod:`repro_torch.train.zero`)
on ``DeviceMesh``es over the ranks.  ``train``: every layout of
``TRAIN_MESHES[world]`` for each of ``TRAIN_ARCHS``, the MoE configs'
layouts of ``MOE_TRAIN`` and the other families' of ``FAMILY_TRAIN``,
three steps in ``"auto"`` mode, the ``"compressed"`` pod hop where the
layout has two pods, and AdamW / Adafactor ZeRO state where a layout
shards it; rank 0 also trains without a mesh (variant ``single``) and
holds every mesh run to it within ``TRAIN_TOL`` (``GRAD_HELD`` configs
also on their first step's gradient).  Every rank holds its resident
parameter and moment bytes to the whole tree's over each leaf's shard
count, and records (``LayerHook``) the query heads and MLP widths its
layers saw and each MoE layer's first-step aux loss and dropped
fraction.  ``elastic-train``: three steps on every rank with a
checkpoint, a resume on half the ranks through ``plan_mesh`` and
three more steps, against an uninterrupted run on that half.
``pipeline``: ``run_pipeline`` with one stage a rank against the
sequential chain, forward and gradients.  ``moe-grad``: the gradients of
the ``shuffle`` dispatch (every rank on the same tokens, at a capacity
where nothing drops) against the ``einsum`` dispatch's.  These cases
check themselves on every rank (``check``), ``--check`` or not.
``train-sp`` (4 ranks): each of ``SP_ARCHS`` with ``seq_shard_activations``
(Megatron sequence parallelism) on each of ``SP_MESHES``, held to the same
layout without the flag and to one device (``_sp_held``; the MoE layers'
aux and drops equal), then ``SP_MUTANTS``, planted faults whose runs
must miss one device (``#held`` False).
``train-drift`` holds nothing: it writes where a mesh run's params end
furthest from one device's, and that element's gradients.
``mesh-serve``: the sharded prefill and one decode step
(:class:`repro_torch.serve.mesh.MeshServe`) of each of ``SERVE_CASES``, in
each of the decode state's three layouts, and of ``SP_SERVE_CASES`` with
the prompt's sequence split over "model" (``serve-sp-*``), from the
``--keys`` params (``serve/<arch>/<leaf index>``, the JAX init) on
``serve_tokens``; each rank writes its rows of the logits (variant
``per-rank``).
``mesh-count``: the dry run's counter
(:class:`repro_torch.launch.dryrun.Counter`) over each of ``COUNT_CASES``'
steps run for real on the rank (:func:`repro_torch.launch.dryrun.
mesh_cell_inputs`), written as JSON (``#record``, variant ``per-rank``),
for the tests to hold against the per-rank dry run of that layout.

Nothing here imports JAX.  The plan families are written once for either
package's ``core`` module (``m``) and array module (``xp``), so the tests
run the same cases on the JAX package as the oracle.  Draws: ``--keys``
gives each family's sample indices and the training cases' initial params
(the tests hand over the JAX package's own draws and init, under
``train/<arch>/<leaf index>``); without it each family takes an int seed
and each model the port's seeded init.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import core
from ._tree import tree_leaves
from .core import (CostAccum, LocalEngine, ShardedEngine, execute_plan,
                   sort_plan)
from .core import distributed as D
from .core.recovery import (Checkpointer, FaultConfig, ShardFailure,
                            elastic_engine, resume_plan,
                            run_plan_with_recovery)
from .obs import Tracer

CASES = ("shuffle", "rounds", "plans", "collectives", "elastic", "tracer",
         "errors", "moe", "train", "elastic-train", "pipeline", "moe-grad",
         "train-drift", "mesh-serve", "mesh-count", "train-sp")
#: the plan families run on the kernel scatter as well
KERNEL_FAMILIES = ("sort", "hull2d")
SEED = 5


def aligned(v: int, k: int) -> int:
    return -(-max(1, int(v)) // k) * k


# ---------------------------------------------------------------------------
# Inputs, shared with the tests (numpy, seeded)
# ---------------------------------------------------------------------------

def shuffle_inputs(k: int):
    """Direct shuffles: ``(dests, payload leaves, n_nodes, capacity)``, a
    (V, 4) send with drops, a 1-D send the group size does not divide, and
    a two-leaf payload."""
    rng = np.random.default_rng(100)
    V = aligned(12, k)
    return [
        (rng.integers(-1, V, (V, 4)).astype(np.int32),
         [rng.normal(size=(V, 4)).astype(np.float32)], V, 2),
        (rng.integers(-1, V, 13).astype(np.int32),
         [rng.normal(size=13).astype(np.float32)], V, 3),
        (rng.integers(-1, V, (V, 3)).astype(np.int32),
         [rng.normal(size=(V, 3)).astype(np.float32),
          rng.integers(0, 99, (V, 3, 2)).astype(np.int32)], V, 3),
    ]


def round_program(seed: int, k: int, n_rounds: int = 4):
    """tests/test_conformance.py's random round program at a node count the
    group size divides: ``(V, cap, entry dests, payload, tables)``."""
    rng = np.random.default_rng(seed)
    V = aligned(int(rng.integers(4, 10)), k)
    cap = int(rng.integers(2, 5))
    entry = rng.integers(-1, V, size=(V, cap)).astype(np.int32)
    payload = rng.normal(size=(V, cap)).astype(np.float32)
    tables = rng.integers(-1, V, size=(n_rounds, V, cap)).astype(np.int32)
    return V, cap, entry, payload, tables


#: the rounds of run_stages: (table, early_dests), mixed windows
STAGE_FLAGS = (True, True, False, True)


def family_inputs():
    """Each plan family's numpy inputs."""
    rng = np.random.default_rng(SEED)
    return {
        "sort": (rng.normal(size=96).astype(np.float32),),
        "sort2": (rng.normal(size=96).astype(np.float32),),
        "multisearch": (rng.normal(size=64).astype(np.float32),
                        np.sort(rng.normal(size=16).astype(np.float32))),
        "prefix": (rng.integers(0, 9, 64).astype(np.int32),),
        "prefix-exclusive": (rng.integers(-9, 9, 64).astype(np.int32),),
        "funnel": (rng.integers(-1, 8, 64).astype(np.int32),
                   rng.integers(-100, 100, 64).astype(np.int32),
                   rng.integers(-50, 50, 8).astype(np.int32)),
        "crcw": (rng.integers(0, 10, 64).astype(np.int32),
                 np.zeros(10, np.float32)),
        "bsp": (rng.normal(size=16).astype(np.float32),),
        "hull2d": (rng.normal(size=(64, 2)).astype(np.float32),),
        "hull3d": (rng.normal(size=(8, 3)).astype(np.float32),),
        "lp": (np.array([1.0, 2.0], np.float32),
               rng.normal(size=(8, 2)).astype(np.float32),
               rng.uniform(1.0, 2.0, 8).astype(np.float32)),
    }


#: each family's PRNG draw: (kind, size) — a permutation of ``size`` or
#: ``size`` random-indexing slots; None for the families that draw nothing
FAMILY_DRAWS = {"sort": ("perm", 96), "sort2": ("perm", 96),
                "multisearch": ("slots", 64), "hull2d": ("perm", 64)}


def _allreduce_superstep(xp):
    """tests/test_paper_algorithms.py's tree all-reduce (BSP)."""
    def superstep(t, ids, state, inbox, inbox_valid):
        state = state + xp.where(inbox_valid, inbox, 0.0).sum(-1)
        stride = 2 ** t
        sender = (ids % (2 * stride)) == stride
        return state, xp.where(sender, ids - stride, -1)[..., None], \
            state[..., None]
    return superstep


def run_family(name: str, m, xp, engine, align, inputs, key, asarray):
    """One family's query on ``engine``: ``m`` is either package's ``core``
    module, ``xp`` its array module (``torch`` or ``jax.numpy``) and
    ``asarray`` its array constructor.  Returns the outputs."""
    plans = {
        "sort": lambda: m.sort_plan(96, 8, align=align),
        "sort2": lambda: m.sort_plan(96, 8, levels=2, align=align),
        "multisearch": lambda: m.multisearch_plan(64, 16, 8, align=align),
        "prefix": lambda: m.prefix_plan(64, 8, physical=True),
        "prefix-exclusive": lambda: m.prefix_plan(64, 8, physical=True,
                                                  inclusive=False),
        "funnel": lambda: m.funnel_write_plan(64, 8, 8, xp.add, identity=0,
                                              dtype="int32"),
        "bsp": lambda: m.bsp_plan(m.BSPProgram(_allreduce_superstep(xp)), 5,
                                  8, 16, asarray(np.float32(0))),
        "hull2d": lambda: m.hull2d_plan(64, 16, align=align),
        "hull3d": lambda: m.hull3d_plan(8, 8),
        "lp": lambda: m.lp_plan(8, 2, 8),
    }
    if name == "crcw":
        # the sum-CRCW histogram: every processor adds 1 to cell state
        prog = m.PRAMProgram(read_addr=lambda s, t: s,
                             compute=lambda s, v, t: (s, s, (s == s) * 1.0))
        _, memory, acc = m.simulate_crcw(
            prog, asarray(inputs[0]), asarray(inputs[1]), 1, 8, xp.add,
            identity=0.0, engine=engine, with_accum=True)
        return memory, acc
    exe = engine.compile(plans[name]())
    return exe(*inputs) if key is None else exe(*inputs, key=key)


# ---------------------------------------------------------------------------
# The cases, run on every rank
# ---------------------------------------------------------------------------

class Results(dict):
    """name -> numpy array; ``put`` flattens a result's tensor leaves."""

    def put(self, case: str, variant: str, tree) -> None:
        for j, leaf in enumerate(tree_leaves(tree)):
            self[f"{case}/{variant}/{j}"] = _np(leaf)

    def meta(self, case: str, variant: str, **values) -> None:
        for k, v in values.items():
            self[f"{case}/{variant}/#{k}"] = np.asarray(v)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def case_shuffle(res: Results, rank: int, keys) -> None:
    engines = {"dense": ShardedEngine(device="cpu"),
               "kernel": ShardedEngine(shuffle_impl="kernel", device="cpu")}
    if rank == 0:
        engines["local"] = LocalEngine(device="cpu")
    k = engines["dense"].n_shards
    for i, (dests, leaves, V, cap) in enumerate(shuffle_inputs(k)):
        payload = leaves[0] if len(leaves) == 1 else tuple(leaves)
        for variant, eng in engines.items():
            box, st = eng.shuffle(dests, payload, V, cap)
            res.put(f"shuffle-{i}", variant, (box, st))
            check(all(s.dtype == torch.int32 for s in st),
                  f"shuffle-{i} {variant}: RoundStats dtypes")
    res.meta("shuffle", "kernel",
             routes=np.array(engines["kernel"].route_log.snapshot()))


def _port_fn(tables):
    t = torch.from_numpy(tables)
    return lambda r, ids, box: (torch.where(box.valid, t[r], -1), box.payload)


def case_rounds(res: Results, rank: int, keys) -> None:
    variants = {"seq": (False, False), "seq-early": (False, True),
                "overlap": (True, True), "overlap-late": (True, False)}
    k = ShardedEngine(device="cpu").n_shards
    for seed in range(3):
        V, cap, entry, payload, tables = round_program(seed, k)
        fn = _port_fn(tables)
        runs = {v: (ShardedEngine(device="cpu", overlap=o), early)
                for v, (o, early) in variants.items()}
        if rank == 0:
            runs["local"] = (LocalEngine(device="cpu"), True)
        for variant, (eng, early) in runs.items():
            box, st = eng.shuffle(entry, payload, V, cap)
            box, acc = eng.run_rounds(fn, box, len(tables),
                                      accum=CostAccum.zero().add_round_stats(
                                          st),
                                      early_dests=early)
            res.put(f"rounds-{seed}", variant, (box, acc))
            if variant != "local":
                res.meta(f"rounds-{seed}", variant,
                         overlapped=eng.route_log.overlapped)
        # run_stages with windows of early rounds between sequential ones
        stage_runs = {"stages": ShardedEngine(device="cpu"),
                      "stages-seq": ShardedEngine(device="cpu",
                                                  overlap=False)}
        if rank == 0:
            stage_runs["local"] = LocalEngine(device="cpu")
        for variant, eng in stage_runs.items():
            box, st = eng.shuffle(entry, payload, V, cap)
            stages = [(fn, cap, None, early) for early in STAGE_FLAGS]
            box, acc = eng.run_stages(stages, box,
                                      accum=CostAccum.zero().add_round_stats(
                                          st))
            res.put(f"stages-{seed}", variant, (box, acc))
            if variant != "local":
                res.meta(f"stages-{seed}", variant,
                         overlapped=eng.route_log.overlapped)


def family_key(name: str, keys):
    """The family's draw: the ``--keys`` entry, else an int seed."""
    if name not in FAMILY_DRAWS:
        return None
    if keys is not None and name in keys:
        return keys[name]
    return SEED


def case_plans(res: Results, rank: int, keys) -> None:
    inputs = family_inputs()
    for name in inputs:
        engines = {"overlap": ShardedEngine(device="cpu"),
                   "seq": ShardedEngine(device="cpu", overlap=False)}
        if name in KERNEL_FAMILIES:
            engines["kernel"] = ShardedEngine(shuffle_impl="kernel",
                                              device="cpu")
        if rank == 0:
            engines["local"] = LocalEngine(device="cpu")
        align = engines["overlap"].aligned_nodes
        for variant, eng in engines.items():
            out = run_family(name, core, torch, eng, align, inputs[name],
                             family_key(name, keys), torch.as_tensor)
            res.put(name, variant, out)
            if variant != "local":
                res.meta(name, variant, overlapped=eng.route_log.overlapped,
                         routes=np.array(eng.route_log.snapshot()))


def collective_inputs(k: int):
    rng = np.random.default_rng(200)
    n_local = 16
    return {
        "a2a_dests": rng.integers(0, k, (k, n_local)).astype(np.int32),
        "a2a_vals": np.arange(k * n_local, dtype=np.float32).reshape(
            k, n_local),
        "funnel": rng.normal(size=(k, 8, 16)).astype(np.float32),
        "funnel_odd": rng.normal(size=(k, 3, 5)).astype(np.float32),
        "q": rng.normal(size=16).astype(np.float32),
        "kv_k": rng.normal(size=(64, 16)).astype(np.float32),
        "kv_v": rng.normal(size=(64, 16)).astype(np.float32),
        "sort_x": rng.normal(size=k * 64).astype(np.float32),
    }


def case_collectives(res: Results, rank: int, keys) -> None:
    k = dist.get_world_size()
    x = collective_inputs(k)
    # shuffle_alltoall: lossless, then at a per-pair capacity of 3
    for cap, tag in ((16, "c-alltoall"), (3, "c-alltoall-cap3")):
        out = D.shuffle_alltoall(torch.from_numpy(x["a2a_dests"][rank]),
                                 torch.from_numpy(x["a2a_vals"][rank]),
                                 None, capacity=cap)
        res.put(tag, "per-rank", out)
    # funnel_allreduce: inner groups of two ranks and an outer group across
    # them at four ranks, one inner group otherwise; and a leading dim the
    # inner group does not divide (the flat sums)
    if k == 4:
        inner = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
        outer = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
    else:
        inner, outer = None, None
    for tag in ("funnel", "funnel_odd"):
        y = D.funnel_allreduce(torch.from_numpy(x[tag][rank]), inner, outer)
        res.put(f"c-{tag}", "sharded", y)
    y = D.funnel_allreduce(torch.from_numpy(x["funnel"][rank]), inner, outer,
                           scatter_dim=1)
    res.put("c-funnel-dim1", "sharded", y)
    # softmax_merge_axis over a sequence-sharded KV
    T = x["kv_k"].shape[0] // k
    ks = torch.from_numpy(x["kv_k"][rank * T:(rank + 1) * T])
    vs = torch.from_numpy(x["kv_v"][rank * T:(rank + 1) * T])
    s = ks @ torch.from_numpy(x["q"])
    m = s.max()
    p = torch.exp(s - m)
    res.put("c-softmax", "sharded", D.softmax_merge_axis(
        D.AttnPartial(m=m, l=p.sum(), o=p @ vs), None))
    # sharded_sample_sort of every rank's 64 keys
    n = x["sort_x"].shape[0] // k
    out = D.sharded_sample_sort(
        torch.from_numpy(x["sort_x"][rank * n:(rank + 1) * n]), None)
    res.put("c-sample-sort", "per-rank", out)


def case_elastic(res: Results, rank: int, keys, out_dir: Path) -> None:
    """A sort checkpointed every stage on all ranks, killed at shuffle
    attempt 1, resumed from the newest checkpoint on the first half of the
    ranks; and the refusals."""
    world = dist.get_world_size()
    half = max(1, world // 2)
    big, small = elastic_engine(world, device="cpu"), \
        elastic_engine(half, device="cpu")
    plan = sort_plan(64, 8, align=big.aligned_nodes)
    x = np.random.default_rng(3).permutation(64).astype(np.float32)
    key = keys["elastic"] if keys is not None and "elastic" in keys else SEED
    res.put("elastic", "fault-free", execute_plan(plan, big, (x,), key=key))
    ck_dir = out_dir / f"ckpt-rank{rank}"
    ck = Checkpointer(ck_dir, plan=plan, every=1)
    fired = False
    try:
        run_plan_with_recovery(plan, big, (x,), key=key,
                               faults=FaultConfig(fail_at=(1,)),
                               checkpointer=ck, max_restarts=0)
    except ShardFailure:
        fired = True
    last = ck.latest()
    res.meta("elastic", "fault-free", fired=fired, latest=-1 if last is None
             else last, n_shards=big.n_shards)
    if small is not None:
        out, rep = resume_plan(plan, small, (x,), key=key,
                               checkpointer=Checkpointer(ck_dir, plan=plan))
        res.put("elastic", "resumed", out)
        res.meta("elastic", "resumed", at=rep.resumed_at_round,
                 n_shards=small.n_shards)
    if rank == 0:
        res.put("elastic", "local",
                execute_plan(plan, LocalEngine(device="cpu"), (x,), key=key))
    refused = []
    for n in (world + 1, 0):
        try:
            elastic_engine(n, device="cpu")
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    res.meta("elastic", "refusals", over="healthy" in refused[0],
             zero=bool(refused[1]))
    dist.barrier()


def tracer_program(k: int):
    """tests/test_conformance.py's pipeline-event program, V = 6 rounded up
    to the group size."""
    rng = np.random.default_rng(3)
    V, cap, R = aligned(6, k), 3, 4
    entry = rng.integers(-1, V, size=(V, cap)).astype(np.int32)
    payload = rng.normal(size=(V, cap)).astype(np.float32)
    return V, cap, R, entry, payload


def case_tracer(res: Results, rank: int, keys) -> None:
    V, cap, R, entry, payload = tracer_program(dist.get_world_size())
    node = torch.arange(V, dtype=torch.int32)[:, None]

    def fn(r, ids, box):
        return torch.where(box.valid, (node + 1 + r) % V, -1), box.payload

    runs = {"traced": ShardedEngine(device="cpu", tracer=Tracer()),
            "untraced": ShardedEngine(device="cpu"),
            "seq": ShardedEngine(device="cpu", overlap=False,
                                 tracer=Tracer())}
    for variant, eng in runs.items():
        box, st = eng.shuffle(entry, payload, V, cap)
        box, acc = eng.run_rounds(fn, box, R,
                                  accum=CostAccum.zero().add_round_stats(st),
                                  early_dests=True)
        res.put("tracer", variant, (box, acc))
        if eng.tracer.enabled:
            kinds = [e.kind for e in eng.tracer.events()]
            res.meta("tracer", variant, hops=kinds.count("pipeline.hop"),
                     overlaps=kinds.count("pipeline.overlap"),
                     pipeline=sum(k.startswith("pipeline.") for k in kinds))


#: the MoE scenario: reduced kimi-k2 without its shared expert, so that
#: the outputs are the dispatch's alone, at a capacity factor that drops
#: choices and one that drops none
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_OVERRIDES = dict(shared_expert=False, moe_dispatch="shuffle")
MOE_CFS = (1.0, 8.0)


def moe_inputs(d: int = 64, f: int = 96, e: int = 8, shape=(4, 16)):
    """One MoE layer's params (numpy, float32, the names and scales of
    ``init_moe`` at reduced kimi-k2's widths) and its input x."""
    rng = np.random.default_rng(300)
    params = {"router": rng.normal(size=(d, e)) * 0.02,
              "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(e),
              "w_up": rng.normal(size=(e, d, f)) / np.sqrt(e),
              "w_down": rng.normal(size=(e, f, d)) / np.sqrt(e)}
    x = rng.normal(size=shape + (d,)) * 0.3
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def case_moe(res: Results, rank: int, keys) -> None:
    """``_moe_shuffle`` with the experts sharded over the group, every rank
    on the same tokens (the JAX package's (1, k) mesh); rank 0 also runs
    ``_moe_einsum`` (variant ``einsum``: y, aux, dropped_frac).  Variant
    ``shuffle`` holds (aux, dropped_frac), which every rank shares, and
    ``per-rank`` the rank's y: where choices drop, each receiver admits
    its senders' copies of a token in rank order, so the ranks' outputs
    differ, as the shards' do in the JAX package."""
    from .configs import get_config
    from .interop import tree_from_numpy
    from .models import moe
    from .models.sharding import use_expert_group
    params, x = moe_inputs()
    p, xt = tree_from_numpy(params), torch.from_numpy(x)
    for cf in MOE_CFS:
        cfg = get_config(MOE_ARCH, reduced=True, capacity_factor=cf,
                         **MOE_OVERRIDES)
        with use_expert_group(dist.group.WORLD):
            out = moe._moe_shuffle(p, cfg, xt)
        res.put(f"moe-{cf}", "shuffle", (out.aux_loss, out.dropped_frac))
        res.put(f"moe-{cf}", "per-rank", out.y)
        if rank == 0:
            res.put(f"moe-{cf}", "einsum", moe._moe_einsum(p, cfg, xt))


# ---------------------------------------------------------------------------
# The parallel-training cases
# ---------------------------------------------------------------------------

#: the configs the mesh trainer runs on every layout: a dense and a hybrid
#: one
TRAIN_ARCHS = ("qwen1.5-0.5b", "zamba2-1.2b")
#: (pod, data, model) layouts a world runs
TRAIN_MESHES = {1: ((1, 1, 1),), 2: ((1, 2, 1), (2, 1, 1)),
                4: ((1, 4, 1), (2, 2, 1), (1, 1, 4), (1, 2, 2)),
                8: ((2, 2, 2),)}
#: the MoE configs: arch -> (config overrides, {world: layouts}).  kimi-k2
#: (einsum dispatch, capacity 1.25: choices drop) on every layout;
#: llama4-scout (shuffle dispatch over "model", a shared expert) where
#: "model" has two ranks, at a capacity where nothing drops, as the
#: one-device run it is held to takes the einsum dispatch
MOE_TRAIN = {
    "kimi-k2-1t-a32b": ({}, TRAIN_MESHES),
    "llama4-scout-17b-a16e": (dict(moe_dispatch="shuffle",
                                   capacity_factor=8.0),
                              {4: ((1, 2, 2),), 8: ((2, 2, 2),)}),
}
#: the other families on a mesh: arch -> (config overrides, {world:
#: layouts}).  rwkv6 at model = 2 runs time mixing on the rank's heads and
#: at model = 4 (d / model not a multiple of the head size) on every head
#: from its four matrices gathered; whisper's encoder, decoder and cross
#: attention and internvl2's two KV heads (cut mid-head at model = 4),
#: under FSDP over "data" at (1, 2, 2)
FAMILY_TRAIN = {arch: ({}, {4: ((1, 2, 2), (1, 1, 4))})
                for arch in ("rwkv6-1.6b", "whisper-base", "internvl2-2b")}
#: configs whose training amplifies a reordered sum too much for
#: ``_held`` after TRAIN_STEPS steps: rwkv6's bonus ``u`` (``--cases
#: train-drift``: from the port's seeded init on (1, 2, 2) the largest
#: gradient difference grows from 5.6e-5 of a leaf's largest element at
#: step 1 to 7.0e-2 at step 4, and under pure data parallelism from 3.9e-7
#: to 2.1e-3).  The train case holds their first step: its loss within
#: ``TRAIN_TOL`` and its gradient, each leaf within ``GRAD_TOL`` of its
#: largest element on one device; the tests (the JAX init) also hold
#: every loss and the whole tree to the JAX trainer
GRAD_HELD = ("rwkv6-1.6b",)
GRAD_TOL = 2e-4
TRAIN_STEPS = 3
#: mesh against single-device runs: losses and params, relative to each
#: leaf's largest magnitude (the sums are taken in another order)
TRAIN_TOL = 1e-5
#: the compressed hop against the exact one after TRAIN_STEPS: the JAX
#: package's own bound
COMPRESSED_TOL = 0.05
#: the layout whose per-layer shapes the train case records (model = 2)
SHAPE_MESH = (1, 2, 2)
#: Megatron sequence parallelism (``seq_shard_activations``): the configs
#: the ``train-sp`` case trains with the flag, every family (llama4-scout
#: for the shuffle dispatch), on the layouts of ``SP_MESHES`` (4 ranks)
SP_ARCHS = ("qwen1.5-0.5b", "zamba2-1.2b", "rwkv6-1.6b", "kimi-k2-1t-a32b",
            "llama4-scout-17b-a16e", "whisper-base", "internvl2-2b")
SP_MESHES = ((1, 1, 4), (1, 2, 2))
#: each rank's one-device and mesh runs of the train case: (arch,
#: variant) -> (losses, whole params, first-step gradient or None, the MoE
#: layers' first-step (aux, dropped)), for the train-sp case to reuse
_RUNS: dict = {}


def _listed(arch: str):
    """(config overrides, {world: layouts}) of ``arch``."""
    return {**MOE_TRAIN, **FAMILY_TRAIN}.get(arch, ({}, TRAIN_MESHES))


def train_layouts(arch: str, world: int):
    """The layouts ``arch`` trains on at ``world`` ranks."""
    return _listed(arch)[1].get(world, ())


def train_config(arch: str, steps: int = TRAIN_STEPS, **kw):
    from .configs import get_config
    from .train import TrainConfig
    over = dict(_listed(arch)[0])
    over.update({k: kw.pop(k) for k in ("optimizer",) if k in kw})
    cfg = get_config(arch, reduced=True, **over)
    return TrainConfig(**{**dict(arch=cfg, global_batch=8, seq_len=16,
                                 steps=steps, warmup_steps=2, log_every=1,
                                 seed=5), **kw})


def _init_params(arch: str, keys):
    """The training case's initial params: the ``--keys`` leaves (the JAX
    init) on the port's nest, else None (the port's seeded init)."""
    if keys is None or f"train/{arch}/0" not in keys:
        return None
    from ._tree import tree_flatten, tree_unflatten
    from .models import build_model
    struct = tree_flatten(build_model(train_config(arch).arch,
                                      device="cpu").param_tree())[1]
    n = sum(1 for k in keys if k.startswith(f"train/{arch}/"))
    return tree_unflatten(struct, [keys[f"train/{arch}/{i}"]
                                   for i in range(n)])


def _train(tc, params, mesh, grads: bool = False):
    """(trainer, losses, the final params as whole tensors), and with
    ``grads`` each step's gradient as whole tensors (on a mesh the mean
    over the batch ranks the update reads)."""
    from .train import Trainer, build_train_step
    t = Trainer(tc, device="cpu", params=params, mesh=mesh)
    seen = []
    if grads:
        step = t._mesh_step
        opt = t.opt if step is None else step.opt

        def update(g, *a, **kw):
            leaves = tree_leaves(g)
            if step is not None:
                leaves = [step._gathered(x.contiguous(), lay)
                          for x, lay in zip(leaves, step.layouts)]
            seen.append([x.detach().clone() for x in leaves])
            return opt.update(g, *a, **kw)
        if step is None:
            t._step_fn = build_train_step(tc, t.model,
                                          opt._replace(update=update))
        else:
            step.opt = opt._replace(update=update)
    r = t.train()
    out = (t, np.array([l for _, l in r["history"]], np.float64),
           t.state_tree()["params"])
    return out + (seen,) if grads else out


class LayerHook:
    """Records what a rank's layers compute with: the query heads each
    attention call sees, the width of each ``silu`` input (an MLP's gate
    activation), and each MoE layer's (aux loss, dropped fraction) in
    call order (the first step's forward first)."""

    def __init__(self):
        self.heads, self.widths, self.moe = set(), set(), []

    def __enter__(self):
        import torch.nn.functional as F
        from .models import layers, moe
        self._saved = layers.sdpa, F.silu, moe.apply_moe

        def sdpa(cfg, q, *a, **kw):
            self.heads.add(q.shape[2])
            return self._saved[0](cfg, q, *a, **kw)

        def silu(x, *a, **kw):
            self.widths.add(x.shape[-1])
            return self._saved[1](x, *a, **kw)

        def apply_moe(*a, **kw):
            out = self._saved[2](*a, **kw)
            self.moe.append((float(out.aux_loss), float(out.dropped_frac)))
            return out
        layers.sdpa, F.silu, moe.apply_moe = sdpa, silu, apply_moe
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        from .models import layers, moe
        layers.sdpa, F.silu, moe.apply_moe = self._saved


def _held(got_losses, got_params, want_losses, want_params, tol, what,
          per_leaf: bool = True):
    """Losses within ``tol`` relative; params within ``tol`` in the
    relative L2 norm of the whole tree and (``per_leaf``) ``10 tol`` of
    each leaf (AdamW turns a gradient near its eps, or one that is
    rounding noise, such as a key bias's, into a step that differs with
    the summation order)."""
    check(np.all(np.abs(got_losses - want_losses)
                 <= tol * np.abs(want_losses)), f"{what}: losses "
          f"{got_losses} against {want_losses}")
    sq_err = sq_ref = 0.0
    for i, (g, w) in enumerate(zip(got_params, want_params)):
        g, w = _np(g).astype(np.float64), _np(w).astype(np.float64)
        e, n = float(np.sum((g - w) ** 2)), float(np.sum(w ** 2))
        check(not per_leaf or e <= (10 * tol) ** 2 * n, f"{what}: param "
              f"leaf {i} off by {np.sqrt(e / max(n, 1e-300))} relative")
        sq_err, sq_ref = sq_err + e, sq_ref + n
    check(sq_err <= tol ** 2 * sq_ref, f"{what}: params off by "
          f"{np.sqrt(sq_err / sq_ref)} relative")


def grad_errors(got, want) -> np.ndarray:
    """Each leaf's largest gradient difference over its largest element
    in ``want``."""
    out = []
    for g, w in zip(got, want):
        g, w = _np(g).astype(np.float64), _np(w).astype(np.float64)
        out.append(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
    return np.array(out)


def case_train(res: Results, rank: int, keys) -> None:
    from .launch.mesh import make_host_mesh
    world = dist.get_world_size()
    for arch in TRAIN_ARCHS + tuple(MOE_TRAIN) + tuple(FAMILY_TRAIN):
        layouts = train_layouts(arch, world)
        if not layouts:
            continue
        params = _init_params(arch, keys)
        n_moe = train_config(arch).arch.n_layers if arch in MOE_TRAIN else 0
        by_grad = arch in GRAD_HELD
        # the train-sp case reads the first-step gradients of its configs'
        # runs at 4 ranks
        grads = by_grad or (arch in SP_ARCHS and world == 4)
        single = None
        if rank == 0:
            with LayerHook() as hook:
                _, losses, whole, *g1 = _train(train_config(arch), params,
                                               None, grads=grads)
            single = (losses, [p.detach().clone()
                               for p in tree_leaves(whole)])
            _RUNS[arch, None] = single + (g1[0][0] if g1 else None,
                                          np.array(hook.moe[:n_moe]))
            res.put(f"train-{arch}", "single", (losses, whole))
            if n_moe:
                res.put(f"train-{arch}", "moe", np.array(hook.moe[:n_moe]))
        for shape in layouts:
            tag = f"train-{arch}-{'x'.join(map(str, shape))}"
            mesh = make_host_mesh(shape, ("pod", "data", "model"))
            with LayerHook() as hook:
                t, losses, whole, *gm = _train(train_config(arch), params,
                                               mesh, grads=grads)
            res.put(tag, "mesh", (losses, whole))
            _RUNS[arch, shape] = (losses, [p.detach().clone() for p in
                                           tree_leaves(whole)],
                                  gm[0][0] if gm else None,
                                  np.array(hook.moe[:n_moe]))
            if n_moe:
                # the first step's (aux, dropped) of each MoE layer
                res.put(tag, "moe", np.array(hook.moe[:n_moe]))
            step = t._mesh_step
            local, whole_b = step.moment_bytes(t.opt_state)
            plocal, pwhole = step.param_bytes(t.params)
            # AdamW's two float32 moments and the params, each leaf's whole
            # bytes over the shard count its spec implies
            want = sum(2 * 4 * int(np.prod(lay.shape)) // lay.n_shards
                       for lay in step.layouts)
            pwant = sum(p.element_size() * int(np.prod(lay.shape))
                        // lay.n_shards for p, lay in
                        zip(tree_leaves(t.params), step.layouts))
            res.meta(tag, "per-rank", moment_bytes=local,
                     whole_bytes=whole_b, implied_bytes=want,
                     param_bytes=plocal, param_whole_bytes=pwhole,
                     param_implied_bytes=pwant,
                     heads=sorted(hook.heads), widths=sorted(hook.widths))
            check(local == want, f"{tag}: moment bytes {local} != {want}")
            check(plocal == pwant, f"{tag}: param bytes {plocal} != {pwant}")
            if single is not None and by_grad:
                err = grad_errors(gm[0][0], g1[0][0])
                res.meta(tag, "grad", errors=err)
                check(abs(losses[0] - single[0][0]) <= TRAIN_TOL
                      * abs(single[0][0]) and np.all(np.isfinite(losses)),
                      f"{tag}: losses {losses} against {single[0]}")
                check(err.max() <= GRAD_TOL, f"{tag}: first-step "
                      f"gradient off by {err.max()} of a leaf's max")
            elif single is not None:
                _held(losses, tree_leaves(whole), *single, TRAIN_TOL, tag)
            if shape[0] == 2 and arch == TRAIN_ARCHS[0]:
                tc = train_config(arch, pod_grad_mode="compressed")
                tcomp, closs, cwhole = _train(tc, params, mesh)
                res.put(tag, "compressed", (closs, cwhole))
                check(tcomp.ef_state is not None, f"{tag}: no EF state")
                check(abs(closs[-1] - losses[-1]) <= COMPRESSED_TOL
                      * abs(losses[-1]), f"{tag}: compressed final loss "
                      f"{closs[-1]} against exact {losses[-1]}")
    # Adafactor's factored statistics over a layout that splits both
    # dimensions of a matrix, against one device
    shape = TRAIN_MESHES[world][-1]
    tc = train_config(TRAIN_ARCHS[0], optimizer="adafactor")
    want = None
    if rank == 0:
        _, losses, whole = _train(tc, None, None)
        want = (losses, [p.detach().clone() for p in tree_leaves(whole)])
    _, losses, whole = _train(tc, None, make_host_mesh(
        shape, ("pod", "data", "model")))
    res.put("train-adafactor", "mesh", (losses, whole))
    if want is not None:
        _held(losses, tree_leaves(whole), *want, TRAIN_TOL,
              "train-adafactor")


def _run_of(arch: str, shape, params, steps: int = TRAIN_STEPS, **over):
    """(losses, whole params, first-step gradient, the MoE layers'
    first-step (aux, dropped)) of ``arch`` trained ``steps`` steps on the
    layout ``shape`` (None: one device), with config overrides ``over``;
    the train case's run where it made it."""
    from .launch.mesh import make_host_mesh
    if not over and steps == TRAIN_STEPS and (arch, shape) in _RUNS:
        return _RUNS[arch, shape]
    tc = train_config(arch, steps=steps)
    tc.arch = dataclasses.replace(tc.arch, **over)
    mesh = None if shape is None else make_host_mesh(
        shape, ("pod", "data", "model"))
    n_moe = tc.arch.n_layers if arch in MOE_TRAIN else 0
    with LayerHook() as hook:
        _, losses, whole, g = _train(tc, params, mesh, grads=True)
    return (losses, [p.detach().clone() for p in tree_leaves(whole)],
            g[0], np.array(hook.moe[:n_moe]))


def _sp_held(got, want, what: str, whole: bool = True) -> None:
    """A run held to another (:func:`_run_of`'s tuples): the first loss
    within ``TRAIN_TOL`` and each leaf's first-step gradient within
    ``GRAD_TOL`` of its largest element, which is what a split sequence
    changes; with ``whole`` also every loss and the whole tree of params
    within ``TRAIN_TOL`` (``_held`` without its per-leaf rule: AdamW
    turns the rounding noise that is the whole gradient of a leaf such
    as qwen's key bias into steps that differ with the summation order,
    by about 1e-4 of that leaf)."""
    check(abs(got[0][0] - want[0][0]) <= TRAIN_TOL * abs(want[0][0])
          and np.all(np.isfinite(got[0])),
          f"{what}: losses {got[0]} against {want[0]}")
    err = grad_errors(got[2], want[2])
    check(err.max() <= GRAD_TOL, f"{what}: first-step gradient off by "
          f"{err.max()} of a leaf's max")
    if whole:
        _held(got[0], got[1], want[0], want[1], TRAIN_TOL, what,
              per_leaf=False)


#: the two planted faults the train-sp case runs (one step each), each of
#: which its hold of the first step must catch: the "model" sum of the
#: gradients of the leaves used on the slice dropped (arch, layout), and
#: RWKV's channel mix shifting the rank's slice rather than the gathered
#: sequence
SP_MUTANTS = {"norm-sum": ("qwen1.5-0.5b", (1, 1, 4)),
              "rwkv-shift": ("rwkv6-1.6b", (1, 1, 4))}


@contextlib.contextmanager
def sp_mutant(name: str):
    """One of ``SP_MUTANTS`` planted for the block."""
    from .models import rwkv
    from .train.zero import MeshStep
    if name == "norm-sum":
        saved = MeshStep._model_summed
        MeshStep._model_summed = lambda self, i, lay: False
        try:
            yield
        finally:
            MeshStep._model_summed = saved
        return
    src = textwrap.dedent(inspect.getsource(rwkv._channel_region))
    good = "torch.sigmoid(tp.own(xr) @ wr.to(dt_c)) * kv"
    check(good in src, "rwkv-shift: the gate's line is not in the source")
    scope = dict(vars(rwkv))
    exec(src.replace(good, "torch.sigmoid(_mixes(x, shift(x), mu)[1] @ "
                           "wr.to(dt_c)) * kv"), scope)
    saved = rwkv._channel_region
    rwkv._channel_region = scope["_channel_region"]
    try:
        yield
    finally:
        rwkv._channel_region = saved


def case_train_sp(res: Results, rank: int, keys) -> None:
    """Each of ``SP_ARCHS`` trained with ``seq_shard_activations`` on each
    of ``SP_MESHES``: held (``_sp_held``) to one device (rank 0) and to
    the same layout without the flag, its MoE layers' first-step aux and
    drops to the run without the flag; then each of ``SP_MUTANTS`` held
    to one device on rank 0, which must fail (``#held`` False)."""
    world = dist.get_world_size()
    if world != 4:
        return
    for arch in SP_ARCHS:
        params = _init_params(arch, keys)
        single = _run_of(arch, None, params) if rank == 0 else None
        for shape in SP_MESHES:
            tag = f"train-sp-{arch}-{'x'.join(map(str, shape))}"
            got = _run_of(arch, shape, params, seq_shard_activations=True)
            res.put(tag, "mesh", (got[0], got[1]))
            plain = _run_of(arch, shape, params)
            res.put(tag, "plain", (plain[0],))
            whole = arch not in GRAD_HELD
            _sp_held(got, plain, f"{tag} against no flag", whole)
            if len(got[3]):
                res.put(tag, "moe", got[3])
                check(np.allclose(got[3][:, 0], plain[3][:, 0], rtol=1e-5,
                                  atol=0) and np.array_equal(
                          got[3][:, 1], plain[3][:, 1]),
                      f"{tag}: MoE aux/drops {got[3]} against {plain[3]}")
            if single is not None:
                _sp_held(got, single, f"{tag} against one device", whole)
    for name, (arch, shape) in SP_MUTANTS.items():
        params = _init_params(arch, keys)
        with sp_mutant(name):
            got = _run_of(arch, shape, params, steps=1,
                          seq_shard_activations=True)
        if rank == 0:
            try:
                _sp_held(got, _run_of(arch, None, params), name,
                         whole=False)
                held = True
            except AssertionError:
                held = False
            res.meta(f"train-sp-mutant-{name}", "per-rank", held=held)


def case_train_drift(res: Results, rank: int, keys, out_dir: Path) -> None:
    """Where a mesh run leaves the one-device run: for each of
    ``TRAIN_ARCHS`` and ``GRAD_HELD`` on the world's last layout, each
    step's loss difference (relative) and largest gradient difference
    (``grad_errors``, and its leaf); the leaf furthest off after
    ``TRAIN_STEPS`` steps (relative to its norm), its element furthest
    off, and at each step that element's gradient on the mesh and on one
    device beside the leaf's largest gradient difference (the summation
    order's noise) and largest gradient.  Rank 0 writes
    ``train-drift.json`` to the output directory; nothing is held."""
    from .launch.mesh import make_host_mesh
    from .models import build_model
    from .models.sharding import tree_paths
    world = dist.get_world_size()
    shape = TRAIN_MESHES[world][-1]
    mesh = make_host_mesh(shape, ("pod", "data", "model"))
    report = {"layout": list(shape), "steps": TRAIN_STEPS}
    for arch in TRAIN_ARCHS + GRAD_HELD:
        tc, params = train_config(arch), _init_params(arch, keys)
        one = _train(tc, params, None, grads=True) if rank == 0 else None
        _, losses, whole, gm = _train(tc, params, mesh, grads=True)
        if one is None:
            continue
        _, losses1, whole1, g1 = one
        paths = tree_leaves(tree_paths(build_model(
            tc.arch, device="cpu").param_tree()))
        got = [_np(x).astype(np.float64) for x in tree_leaves(whole)]
        want = [_np(x).astype(np.float64) for x in tree_leaves(whole1)]
        rel = [float(np.sqrt(np.sum((a - b) ** 2)
                             / max(np.sum(b ** 2), 1e-300)))
               for a, b in zip(got, want)]
        i = int(np.argmax(rel))
        at = np.unravel_index(np.argmax(np.abs(got[i] - want[i])),
                              got[i].shape)
        steps = []
        for a, b in zip(gm, g1):
            ga, gb = _np(a[i]).astype(np.float64), _np(b[i]).astype(
                np.float64)
            steps.append({"mesh": float(ga[at]), "one_device": float(gb[at]),
                          "leaf_max_abs_diff": float(np.abs(ga - gb).max()),
                          "leaf_max_abs": float(np.abs(gb).max())})
        errs = [grad_errors(a, b) for a, b in zip(gm, g1)]
        report[arch] = {
            "loss_rel_by_step": (np.abs(losses - losses1)
                                 / np.abs(losses1)).tolist(),
            "grad_err_by_step": [float(e.max()) for e in errs],
            "grad_err_leaf_by_step": [paths[int(e.argmax())] for e in errs],
            "leaf": paths[i], "leaf_rel": rel[i], "element": list(map(
                int, at)), "final": {"mesh": float(got[i][at]),
                                     "one_device": float(want[i][at])},
            "grads_by_step": steps}
    if rank == 0:
        (out_dir / "train-drift.json").write_text(json.dumps(report,
                                                             indent=1))


def case_elastic_train(res: Results, rank: int, keys, out_dir: Path) -> None:
    """Train 3 steps on every rank with a checkpoint at step 3; resume on
    half the ranks (``plan_mesh``) and train to step 6; against an
    uninterrupted run on that half."""
    from .launch.mesh import make_host_mesh
    from .train import Trainer
    from .train.elastic import plan_mesh
    world = dist.get_world_size()
    half = max(1, world // 2)
    arch = "tinyllama-1.1b"
    ck = out_dir / "elastic-train"
    tc = lambda d: train_config(arch, steps=6, ckpt_dir=str(d), ckpt_every=3)
    t1 = Trainer(tc(ck), device="cpu", mesh=make_host_mesh())
    t1.train(steps=3)
    state = t1.state_tree()
    if rank == 0:
        res.put("elastic-train", "step3", state)
    small = plan_mesh(half)
    res.meta("elastic-train", "plan", shape=np.array(tuple(small.shape)))
    res.meta("elastic-train", "per-rank",
             member=small.get_coordinate() is not None)
    if small.get_coordinate() is not None:
        t2 = Trainer(tc(ck), device="cpu", mesh=small)
        check(t2.maybe_resume() and t2.step == 3, "elastic-train: resume")
        r2 = t2.train()
        t3 = Trainer(tc(out_dir / f"elastic-train-ref{rank}"), device="cpu",
                     mesh=small)
        r3 = t3.train()
        got = np.array([l for _, l in r2["history"]])
        want = np.array([l for _, l in r3["history"]])[-len(got):]
        p2, p3 = t2.state_tree()["params"], t3.state_tree()["params"]
        _held(got, tree_leaves(p2), want, tree_leaves(p3), TRAIN_TOL,
              "elastic-train")
        if rank == 0:
            res.put("elastic-train", "resumed", (got, p2))
            res.put("elastic-train", "uninterrupted", (want, p3))
    dist.barrier()


def pipeline_inputs(n_stages: int):
    """tests/test_distributed.py's pipeline: (ws (S, d, d), xs (6, 8, d))."""
    rng = np.random.default_rng(0)
    ws = rng.normal(size=(n_stages, 16, 16)).astype(np.float32) * \
        np.float32(0.3)
    xs = rng.normal(size=(6, 8, 16)).astype(np.float32)
    return ws, xs


PIPE_FWD_TOL, PIPE_GRAD_TOL = 2e-5, 1e-5


def case_pipeline(res: Results, rank: int, keys) -> None:
    from .train.pipeline import run_pipeline
    world = dist.get_world_size()
    ws_np, xs_np = pipeline_inputs(world)
    stage_fn = lambda w, x: torch.tanh(x @ w)
    ws = torch.from_numpy(ws_np).requires_grad_()
    xs = torch.from_numpy(xs_np).requires_grad_()
    out = run_pipeline(stage_fn, ws, xs)
    (out ** 2).sum().backward()
    res.put("pipeline", "pipelined", out)
    res.put("pipeline", "per-rank", (ws.grad[rank], xs.grad))
    # the sequential chain
    ws2 = torch.from_numpy(ws_np).requires_grad_()
    xs2 = torch.from_numpy(xs_np).requires_grad_()
    want = xs2
    for s in range(world):
        want = stage_fn(ws2[s], want)
    (want ** 2).sum().backward()
    res.put("pipeline", "sequential", want)
    check(torch.allclose(out, want, rtol=PIPE_FWD_TOL, atol=PIPE_FWD_TOL),
          "pipeline: outputs differ from the sequential chain")
    check(torch.allclose(ws.grad[rank], ws2.grad[rank], rtol=PIPE_GRAD_TOL,
                         atol=PIPE_GRAD_TOL),
          f"pipeline: stage {rank}'s gradient differs")
    if rank == 0:
        check(torch.allclose(xs.grad, xs2.grad, rtol=PIPE_GRAD_TOL,
                             atol=PIPE_GRAD_TOL),
              "pipeline: the input's gradient differs")
    else:
        check(float(xs.grad.abs().max()) == 0,
              "pipeline: the input's gradient reached a later stage")
    others = [s for s in range(world) if s != rank]
    check(all(float(ws.grad[s].abs().max()) == 0 for s in others),
          "pipeline: a stage's gradient reached another rank")


#: the shuffle dispatch's gradients against the einsum one's (float32)
MOE_GRAD_TOL = 1e-4


def moe_grads(p, cfg, x, dispatch):
    """(y, {name: grad}, x.grad) of ``dispatch(p, cfg, x).y.sum()``."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    x = x.detach().clone().requires_grad_()
    y = dispatch(p, cfg, x).y
    y.sum().backward()
    return y.detach(), {k: (torch.zeros_like(v) if v.grad is None
                            else v.grad) for k, v in p.items()}, x.grad


def case_moe_grad(res: Results, rank: int, keys) -> None:
    """Every rank holds every token (the (1, k) mesh), so each rank's
    expert slice gathers every rank's copy: the group's summed expert
    gradient over k is the einsum dispatch's."""
    from .configs import get_config
    from .interop import tree_from_numpy
    from .models import moe
    from .models.sharding import use_expert_group
    world = dist.get_world_size()
    params, x = moe_inputs()
    cfg = get_config(MOE_ARCH, reduced=True, capacity_factor=MOE_CFS[-1],
                     **MOE_OVERRIDES)
    p, xt = tree_from_numpy(params), torch.from_numpy(x)
    with use_expert_group(dist.group.WORLD):
        y, grads, gx = moe_grads(p, cfg, xt, moe._moe_shuffle)
    experts = {k: D.all_reduce(v, group=None) / world
               for k, v in grads.items() if k != "router"}
    res.put("moe-grad", "per-rank", (y, grads, gx))
    res.put("moe-grad", "group", experts)
    ye, ge, gxe = moe_grads(p, cfg, xt, moe._moe_einsum)
    close = lambda a, b: torch.allclose(a, b, rtol=MOE_GRAD_TOL,
                                        atol=MOE_GRAD_TOL)
    check(close(y, ye), "moe-grad: outputs differ")
    check(close(gx, gxe), "moe-grad: x's gradient differs")
    check(close(grads["router"], ge["router"]),
          "moe-grad: the router's gradient differs")
    for k, v in experts.items():
        check(close(v, ge[k]), f"moe-grad: {k}'s gradient differs")


def case_errors(res: Results, rank: int, keys) -> None:
    eng = ShardedEngine(device="cpu")
    k = eng.n_shards
    raised = {}
    for tag, (dests, V) in {
            "nodes": (np.zeros((k, 2), np.int32), k + 1),
            "lead": (np.zeros((k + 1, 2), np.int32), 2 * k)}.items():
        try:
            eng.shuffle(dests, dests.astype(np.float32), V, 2)
            raised[tag] = False
        except ValueError:
            raised[tag] = True
    res.meta("errors", "sharded", **raised)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Ranks and the launcher
# ---------------------------------------------------------------------------

#: (arch, mesh shape, batch): the sharded serving cases, one a layout of
#: the decode state: KV heads over "model", the head dimension over
#: "model" (one KV head), the sequence over "data" (B = 1)
SERVE_CASES = (("qwen1.5-0.5b", (1, 1, 4), 4),
               ("tinyllama-1.1b", (1, 1, 4), 4),
               ("zamba2-1.2b", (1, 4, 1), 1))
SERVE_PROMPT, SERVE_MAX_LEN = 8, 16
#: the serving cases whose prefill splits the prompt's sequence over
#: "model" (``seq_shard_activations``; the decode step, one position, does
#: not split)
SP_SERVE_CASES = (("qwen1.5-0.5b", (1, 1, 4), 4),
                  ("tinyllama-1.1b", (1, 1, 4), 4))
#: (arch, config overrides, shape (name, seq, batch, kind), mesh shape):
#: the counted steps, a training step of two microbatches (also with the
#: sequence split over "model"), a prefill and a decode step over both
#: "data" and "model"
COUNT_CASES = (
    ("qwen1.5-0.5b", {"grad_accum": 2}, ("train", 16, 8, "train"),
     (1, 2, 2)),
    ("qwen1.5-0.5b", {"grad_accum": 2, "seq_shard_activations": True},
     ("train-sp", 16, 8, "train"), (1, 2, 2)),
    ("qwen1.5-0.5b", {}, ("prefill", 16, 4, "prefill"), (1, 2, 2)),
    ("zamba2-1.2b", {}, ("decode", 32, 1, "decode"), (1, 2, 2)))


def serve_tokens(arch: str, batch: int) -> np.ndarray:
    """The serving cases' prompt (batch, SERVE_PROMPT) int32."""
    from .configs import get_config
    vocab = get_config(arch, reduced=True).vocab_size
    return np.random.default_rng(7).integers(
        0, vocab, (batch, SERVE_PROMPT)).astype(np.int32)


def case_mesh_serve(res: Results, rank: int, keys) -> None:
    from ._tree import tree_flatten, tree_unflatten
    from .configs import get_config
    from .launch.mesh import make_host_mesh
    from .models import build_model, model_class
    from .serve.mesh import MeshServe
    for (arch, shape, batch), sp in ([(c, False) for c in SERVE_CASES]
                                     + [(c, True) for c in SP_SERVE_CASES]):
        cfg = get_config(arch, reduced=True, seq_shard_activations=sp)
        struct = tree_flatten(build_model(cfg, device="meta")
                              .param_tree())[1]
        n = sum(1 for k in keys if k.startswith(f"serve/{arch}/"))
        params = tree_unflatten(struct, [torch.from_numpy(
            keys[f"serve/{arch}/{i}"]) for i in range(n)])
        model = model_class(cfg)(cfg, params)
        serve = MeshServe(model, make_host_mesh(shape, ("pod", "data",
                                                        "model")),
                          batch, SERVE_MAX_LEN)
        tokens = serve.rows(torch.from_numpy(serve_tokens(arch, batch)))
        logits, state = serve.prefill(tokens, SERVE_MAX_LEN)
        tok = torch.argmax(logits, -1).to(torch.int32)
        step, _ = serve.decode_step(tok, state)
        tag = (f"serve{'-sp' if sp else ''}-{arch}-"
               f"{'x'.join(map(str, shape))}")
        res.put(tag, "per-rank", (logits, step))


def case_mesh_count(res: Results, rank: int, keys) -> None:
    import json
    from .configs import ShapeConfig, get_config
    from .launch import dryrun
    from .launch.mesh import make_host_mesh
    from .models.sharding import config_rules
    for arch, over, shape, mesh_shape in COUNT_CASES:
        cfg = get_config(arch, reduced=True, **over)
        shape = ShapeConfig(*shape)
        mesh = make_host_mesh(mesh_shape, ("pod", "data", "model"))
        with config_rules(cfg):
            model, step, args = dryrun.mesh_cell_inputs(cfg, shape, mesh,
                                                        "cpu", seed=3)
            rec = dryrun.record(cfg, shape, dryrun.count(model, step, args))
        tag = f"count-{arch}-{shape.name}"
        res.meta(tag, "per-rank", record=json.dumps(
            {k: rec[k] for k in ("cost", "kernels", "collectives")}))


def run_rank(rank: int, world: int, out_dir: Path, cases, keys) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    try:
        res = Results()
        t0 = time.perf_counter()
        for case in cases:
            if case in ("elastic", "elastic-train", "train-drift"):
                globals()[f"case_{case.replace('-', '_')}"](res, rank, keys,
                                                             out_dir)
            else:
                globals()[f"case_{case.replace('-', '_')}"](res, rank,
                                                             keys)
        res["#seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(out_dir / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def load_ranks(out_dir: Path, world: int):
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def check_results(ranks) -> int:
    """Every rank's entries equal rank 0's (but the ``per-rank`` variant,
    which holds a collective's rank-local result); every sharded variant's
    leaves equal the ``local`` variant's; returns how many entries were
    held."""
    ref = ranks[0]
    held = 0
    for r, got in enumerate(ranks[1:], 1):
        for name, v in got.items():
            if name in ref and not name.startswith("#") \
                    and "/per-rank/" not in name:
                check(v.dtype == ref[name].dtype
                      and np.array_equal(v, ref[name], equal_nan=True),
                      f"rank {r} differs from rank 0 at {name}")
                held += 1
    for name, v in ref.items():
        parts = name.split("/")
        if len(parts) != 3 or parts[2].startswith("#") or parts[1] == "local":
            continue
        want = ref.get(f"{parts[0]}/local/{parts[2]}")
        if want is None:
            continue
        check(v.dtype == want.dtype and np.array_equal(v, want,
                                                        equal_nan=True),
              f"{name} differs from the local engine's")
        held += 1
    return held


def launch(world: int, out_dir: Path, cases, keys_path, timeout: float,
           do_check: bool) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    for pattern in ("ckpt-rank*", "elastic-train*"):
        for stale in out_dir.glob(pattern):
            shutil.rmtree(stale)
    for stale in out_dir.glob("rank*"):
        stale.unlink()
    (out_dir / "store").unlink(missing_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.dist_check", "--world",
           str(world), "--out", str(out_dir), "--cases", ",".join(cases)]
    if keys_path:
        cmd += ["--keys", str(keys_path)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.perf_counter() - t0 > timeout:
            failed = (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                      if bad else f"timed out after {timeout} s")
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] for p in procs]
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode]
        failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" \
            if bad else None
    summary = {"world": world, "cases": list(cases),
               "seconds": time.perf_counter() - t0, "ok": failed is None}
    if failed is None and do_check:
        try:
            summary["entries_held"] = check_results(load_ranks(out_dir,
                                                               world))
        except AssertionError as e:
            failed = str(e)
            summary["ok"] = False
    if failed is not None:
        summary["error"] = failed
        for r, log in enumerate(logs):
            if log.strip():
                print(f"--- rank {r} ---\n{log[-4000:]}", file=sys.stderr)
    print(json.dumps(summary), flush=True)
    return 0 if failed is None else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--keys", type=Path, default=None)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--timeout", type=float, default=150.0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; pick from {CASES}")
    if args.rank is None:
        return launch(args.world, args.out, cases, args.keys, args.timeout,
                      args.check)
    keys = dict(np.load(args.keys)) if args.keys else None
    run_rank(args.rank, args.world, args.out, cases, keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
