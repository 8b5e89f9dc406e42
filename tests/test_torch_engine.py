"""Port engines vs the JAX package's LocalEngine on round programs.

Seeded random round programs — including drops, "no item" holes and
shape-change rounds — run on the JAX ``LocalEngine`` and on the port's dense
and kernel ``LocalEngine`` (``device="cpu"``) and ``ReferenceEngine``; the
final mailbox and every ``CostAccum`` field must agree exactly.  One test
carries a JAX mailbox and accumulator partway through a program into the
port and finishes there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import CostAccum as JaxCostAccum
from repro.core import LocalEngine as JaxLocalEngine
from repro_torch.core import (CostAccum, LocalEngine, MRCost,
                              ReferenceEngine, RoundProgram, get_engine,
                              run_rounds)
from repro_torch.interop import (accum_from_numpy, mailbox_from_numpy,
                                 to_numpy)
from repro_torch.testing import assert_same_accum, assert_same_box


def port_engines():
    return [LocalEngine(device="cpu"),
            LocalEngine(shuffle_impl="kernel", device="cpu"),
            ReferenceEngine()]


def _program(seed, n_rounds=3):
    rng = np.random.default_rng(seed)
    V = int(rng.integers(4, 10))
    cap = int(rng.integers(2, 5))
    entry = rng.integers(-1, V, size=(V, cap)).astype(np.int32)
    payload = rng.normal(size=(V, cap)).astype(np.float32)
    tables = rng.integers(-1, V, size=(n_rounds, V, cap)).astype(np.int32)
    return V, cap, entry, payload, tables


def _jax_fn(tables):
    t = jnp.asarray(tables)
    return lambda r, ids, box: (jnp.where(box.valid, t[r], -1), box.payload)


def _port_fn(tables):
    t = torch.from_numpy(tables)
    return lambda r, ids, box: (torch.where(box.valid, t[r], -1), box.payload)


@pytest.mark.parametrize("seed", range(4))
def test_random_program_matches_jax(seed):
    V, cap, entry, payload, tables = _program(seed)
    jeng = JaxLocalEngine()
    jbox, jst = jeng.shuffle(entry, payload, V, cap)
    jbox, jacc = jeng.run_rounds(_jax_fn(tables), jbox, len(tables),
                                 accum=JaxCostAccum.zero().add_round_stats(jst))
    for eng in port_engines():
        box, st = eng.shuffle(entry, payload, V, cap)
        box, acc = eng.run_rounds(_port_fn(tables), box, len(tables),
                                  accum=CostAccum.zero().add_round_stats(st))
        assert_same_box(jbox, box, ctx=eng.name)
        assert_same_accum(jacc, acc, ctx=eng.name)


@pytest.mark.parametrize("seed", range(2))
def test_shape_change_rounds_match_jax(seed):
    """A program whose first round reshapes the mailbox to (V2, cap2),
    then rounds at that shape, and a staged schedule of changing shapes."""
    rng = np.random.default_rng(50 + seed)
    V, cap = 6, 3
    V2, cap2 = 3, 5
    entry = rng.integers(-1, V, size=(V, cap)).astype(np.int32)
    payload = rng.normal(size=(V, cap)).astype(np.float32)
    first = rng.integers(-1, V2, size=(V, cap)).astype(np.int32)
    rest = rng.integers(-1, V2, size=(2, V2, cap2)).astype(np.int32)

    def make(lib, where):
        t0, t1 = lib(first), lib(rest)

        def fn(r, ids, box):
            table = t0 if box.valid.shape == (V, cap) else t1[r - 1]
            return where(box.valid, table, -1), box.payload
        return fn

    jeng = JaxLocalEngine()
    jbox, _ = jeng.shuffle(entry, payload, V, cap)
    jout, jacc = jeng.run_rounds(make(jnp.asarray, jnp.where), jbox, 3,
                                 capacity=cap2, n_nodes=V2)
    stages = [(make(jnp.asarray, jnp.where), cap2, V2),
              (lambda r, ids, b: (jnp.where(b.valid, ids[:, None] % 2, -1),
                                  b.payload), 4, 2)]
    jsbox, jsacc = jeng.run_stages(stages, jbox)
    for eng in port_engines():
        box, _ = eng.shuffle(entry, payload, V, cap)
        out, acc = eng.run_program(
            RoundProgram(make(torch.from_numpy, torch.where), 3,
                         capacity=cap2, n_nodes=V2), box)
        assert tuple(out.valid.shape) == (V2, cap2)
        assert_same_box(jout, out, ctx=eng.name)
        assert_same_accum(jacc, acc, ctx=eng.name)
        pstages = [(make(torch.from_numpy, torch.where), cap2, V2),
                   (lambda r, ids, b: (torch.where(b.valid,
                                                   ids[:, None] % 2, -1),
                                       b.payload), 4, 2)]
        sbox, sacc = eng.run_stages(pstages, box)
        assert_same_box(jsbox, sbox, ctx=f"{eng.name} stages")
        assert_same_accum(jsacc, sacc, ctx=f"{eng.name} stages")


def test_carry_jax_state_into_port_midway():
    """Run two rounds in the JAX package, carry the mailbox and CostAccum
    across through numpy, finish the last two rounds in the port: the
    result is what the JAX package gets running all four."""
    V, cap, entry, payload, tables = _program(7, n_rounds=4)
    payload = {"v": payload, "tag": np.arange(V * cap, dtype=np.int32)
               .reshape(V, cap)}

    def jfn(r, ids, box):
        return jnp.where(box.valid, jnp.asarray(tables)[r], -1), box.payload

    jeng = JaxLocalEngine()
    jbox, jst = jeng.shuffle(entry, payload, V, cap)
    jacc0 = JaxCostAccum.zero().add_round_stats(jst)
    jfull, jacc = jeng.run_rounds(jfn, jbox, 4, accum=jacc0)
    jhalf, jacc_half = jeng.run_rounds(jfn, jbox, 2, accum=jacc0)

    box = mailbox_from_numpy({k: np.asarray(v) for k, v in
                              jhalf.payload.items()}, np.asarray(jhalf.valid))
    acc = accum_from_numpy([np.asarray(f) for f in jacc_half])
    assert acc.rounds.dtype == torch.int32
    assert acc.communication.dtype == torch.float32
    t = torch.from_numpy(tables)
    for eng in port_engines():
        out, out_acc = eng.run_rounds(
            lambda r, ids, b: (torch.where(b.valid, t[r + 2], -1), b.payload),
            box, 2, accum=acc)
        assert_same_box(jfull, out, ctx=eng.name)
        assert_same_accum(jacc, out_acc, ctx=eng.name)
        back = to_numpy(out)
        np.testing.assert_array_equal(back.payload["tag"],
                                      np.asarray(jfull.payload["tag"]))


def test_accum_rounds_in_float32_like_jax():
    """communication accumulates in float32 in the JAX package's order, so
    sums past 2^24 round identically."""
    jacc, acc = JaxCostAccum.zero(), CostAccum.zero()
    for items, io in [((1 << 24) + 1, 5), (3, 7), ((1 << 25) + 3, 2), (1, 1)]:
        jacc = jacc.add_round(items_sent=items, max_io=io)
        acc = acc.add_round(items_sent=items, max_io=io)
    assert_same_accum(jacc, acc)
    assert [f.dtype for f in acc] == [torch.int32, torch.float32,
                                     torch.float32, torch.int32, torch.int32]


def test_run_rounds_wrapper_raises_on_drops_and_feeds_cost():
    eng = LocalEngine(device="cpu")
    box, _ = eng.shuffle(np.zeros((4,), np.int32), np.arange(4.0), 2, 4)
    keep = lambda r, ids, b: (torch.where(b.valid, ids[:, None], -1),  # noqa
                              b.payload)
    cost = MRCost()
    run_rounds(keep, box, 2, cost=cost, engine=eng)
    assert (cost.rounds, cost.communication) == (2, 8)
    to_one = lambda r, ids, b: (torch.where(b.valid, 0, -1), b.payload)  # noqa
    with pytest.raises(RuntimeError, match="exceeded mailbox capacity"):
        run_rounds(to_one, box, 1, capacity=2, engine=eng)


def test_engine_registry_and_device_rules():
    assert get_engine("local", device="cpu").shuffle_impl == "dense"
    for name in ("kernel", "pallas"):
        eng = get_engine(name, device="cpu")
        assert eng.shuffle_impl == "kernel" and eng.name == "kernel"
    assert get_engine("reference").device == torch.device("cpu")
    with pytest.raises(ValueError, match="shuffle_impl"):
        LocalEngine(shuffle_impl="fused", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("mesh")
    # "sharded" is registered; it needs a process group the caller starts
    with pytest.raises(RuntimeError, match="init_process_group"):
        get_engine("sharded", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalEngine()
