"""The simulation half of the paper in the port — Theorem 3.2 invisible
funnels and the CRCW PRAM simulation, Theorem 3.1 BSP — against the JAX
package on the same numpy inputs.

Every user function (semigroup, PRAM program, BSP superstep) is written
once in jnp for the JAX package and once in torch for the port.  The
oracles are the JAX ``ReferenceEngine`` and dense ``LocalEngine``.  The
engine funnel folds each mailbox row slot by slot in both packages, so it
is bit-identical for every semigroup, a float32 sum included; the dense
funnel combines segments in a different tree order than JAX's
``associative_scan``, so there a float32 sum holds within a stated
tolerance and the exact semigroups hold exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
from repro_torch.core import (BSPProgram, LocalEngine, MRCost, PRAMProgram,
                              ReferenceEngine, bsp_plan, funnel_read,
                              funnel_read_accum, funnel_write,
                              funnel_write_plan, get_engine, run_bsp,
                              scatter_combine_opt, simulate_crcw)
from repro_torch.core import engine as port_engine
from repro_torch.testing import assert_same_accum

# The dense float32 funnel sum: the packages combine a cell's writes in
# different association orders (Hillis-Steele doubling here, XLA's
# associative_scan there).  Sums of at most a few hundred standard normals
# differ by a few float32 ulps; 1e-5 absolute plus relative bounds that.
F32_SUM_TOL = 1e-5

OPS = {  # name: (jax op, torch op, dtype, identity)
    "add-int32": (jnp.add, torch.add, "int32", 0),
    "max-float32": (jnp.maximum, torch.maximum, "float32", None),
    "add-float32": (jnp.add, torch.add, "float32", 0.0),
    "min-int32": (jnp.minimum, torch.minimum, "int32", None),
}


def _jax_engine(name):
    return {"reference": J.ReferenceEngine, "local": J.LocalEngine}[name]()


def _port_engines():
    return [ReferenceEngine(), LocalEngine(device="cpu"),
            get_engine("kernel", device="cpu")]


def _writes(seed, P, N, dtype):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(-1, N, P).astype(np.int32)        # -1: no write
    if dtype == "int32":
        vals = rng.integers(-100, 100, P).astype(np.int32)
        memory = rng.integers(-50, 50, N).astype(np.int32)
    else:
        vals = rng.normal(size=P).astype(np.float32)
        memory = rng.normal(size=N).astype(np.float32)
    return addrs, vals, memory


@pytest.fixture
def cpu_default_engine(monkeypatch):
    """The deprecated wrappers run on the default engine: a CPU one here."""
    eng = LocalEngine(device="cpu")
    monkeypatch.setattr(port_engine, "default_engine", lambda: eng)
    return eng


# ------------------------------------------------------------- Thm 3.2
@pytest.mark.parametrize("P,N,M,op,oracle", [
    (50, 7, 4, "add-int32", "reference"),
    (500, 37, 8, "max-float32", "local"),
    (1000, 3, 64, "add-float32", "local"),
    (128, 128, 16, "add-float32", "reference"),
    (300, 11, 8, "min-int32", "local"),
])
def test_funnel_write_plan_matches_jax(P, N, M, op, oracle):
    jop, top, dtype, identity = OPS[op]
    addrs, vals, memory = _writes(P + N, P, N, dtype)
    plans = {shape: funnel_write_plan(P, N, M, top, identity=identity,
                                      dtype=dtype, shape=shape)
             for shape in (True, False)}
    for shape, tplan in plans.items():
        plan = J.funnel_write_plan(P, N, M, jop, identity=identity,
                                   dtype=dtype, shape=shape)
        assert tplan.schedule() == plan.schedule()
        assert tplan.round_bound == plan.round_bound
        assert tplan.n_nodes == plan.n_nodes
    jeng = _jax_engine(oracle)
    want = jeng.compile(J.funnel_write_plan(P, N, M, jop, identity=identity,
                                            dtype=dtype))(
        jnp.asarray(addrs), jnp.asarray(vals), jnp.asarray(memory))
    outs = []
    for eng in _port_engines():
        for shape, tplan in plans.items():
            got = eng.compile(tplan)(addrs, vals, memory)
            ctx = f"shape={shape} {jeng.name}/{eng.name}"
            np.testing.assert_array_equal(got.memory.numpy(),
                                          np.asarray(want.memory),
                                          err_msg=ctx)
            assert got.memory.dtype == torch.from_numpy(memory).dtype
            assert int(got.max_fan_in) == int(want.max_fan_in), ctx
            assert_same_accum(want.stats, got.stats, ctx=ctx)
            outs.append(got)
        if eng.name == "kernel":
            assert eng.route_log.dense == 0
    for other in outs[1:]:                    # shape=True == shape=False
        assert torch.equal(outs[0].memory, other.memory)


@pytest.mark.parametrize("P,N,M,op", [
    (500, 37, 8, "max-float32"), (1000, 3, 64, "add-float32"),
    (300, 11, 8, "min-int32"), (2000, 5, 8, "add-int32"),
])
def test_dense_funnel_write_matches_jax(P, N, M, op):
    jop, top, dtype, identity = OPS[op]
    addrs, vals, memory = _writes(P, P, N, dtype)
    jcost, cost = J.MRCost(), MRCost()
    # jitted: the stats are functional (what ``cost=`` absorbs), and the
    # eager dense funnel compiles op by op, ~10 s a case
    want = jax.jit(lambda a, v, m: J.funnel_write(a, v, m, jop, M,
                                                  identity=identity))(
        jnp.asarray(addrs), jnp.asarray(vals), jnp.asarray(memory))
    jcost.absorb(want.stats)
    got = funnel_write(torch.from_numpy(addrs), torch.from_numpy(vals),
                       torch.from_numpy(memory), top, M, cost=cost,
                       identity=identity)
    if op == "add-float32":
        np.testing.assert_allclose(got.memory.numpy(),
                                   np.asarray(want.memory),
                                   rtol=F32_SUM_TOL, atol=F32_SUM_TOL)
    else:
        np.testing.assert_array_equal(got.memory.numpy(),
                                      np.asarray(want.memory))
    assert int(got.max_fan_in) == int(want.max_fan_in)
    assert_same_accum(want.stats, got.stats)
    assert vars(cost) == vars(jcost)


def test_funnel_write_engine_wrapper_and_opt():
    P, N, M = 400, 13, 8
    addrs, vals, memory = _writes(3, P, N, "float32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.funnel_write(jnp.asarray(addrs), jnp.asarray(vals),
                              jnp.asarray(memory), jnp.maximum, M,
                              engine=J.LocalEngine())
    with pytest.deprecated_call():
        got = funnel_write(torch.from_numpy(addrs), torch.from_numpy(vals),
                           torch.from_numpy(memory), torch.maximum, M,
                           engine=LocalEngine(device="cpu"))
    np.testing.assert_array_equal(got.memory.numpy(), np.asarray(want.memory))
    assert_same_accum(want.stats, got.stats)
    for name, dtype in (("sum", "int32"), ("sum", "float32"),
                        ("max", "float32"), ("min", "int32")):
        a, v, mem = _writes(4, P, N, dtype)
        w = J.scatter_combine_opt(jnp.asarray(a), jnp.asarray(v),
                                  jnp.asarray(mem), name)
        g = scatter_combine_opt(torch.from_numpy(a), torch.from_numpy(v),
                                torch.from_numpy(mem), name)
        if name == "sum" and dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=F32_SUM_TOL, atol=F32_SUM_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="semigroup"):
        scatter_combine_opt(torch.from_numpy(a), torch.from_numpy(v),
                            torch.from_numpy(mem), "mul")


@pytest.mark.parametrize("P,N,M", [(400, 13, 8), (64, 64, 4)])
def test_funnel_read_matches_jax(P, N, M):
    rng = np.random.default_rng(P)
    mem = rng.normal(size=N).astype(np.float32)
    addrs = rng.integers(0, N, P).astype(np.int32)
    jcost, cost = J.MRCost(), MRCost()
    want = J.funnel_read(jnp.asarray(addrs), jnp.asarray(mem), M, cost=jcost)
    got = funnel_read(torch.from_numpy(addrs), torch.from_numpy(mem), M,
                      cost=cost)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert vars(cost) == vars(jcost)
    _, jacc = J.funnel_read_accum(jnp.asarray(addrs), jnp.asarray(mem), M)
    vals, acc = funnel_read_accum(torch.from_numpy(addrs),
                                  torch.from_numpy(mem), M)
    assert_same_accum(jacc, acc)
    np.testing.assert_array_equal(
        funnel_read(torch.from_numpy(addrs), torch.from_numpy(mem),
                    M).numpy(), mem[addrs])


def _histogram_programs(data):
    """tests/test_paper_algorithms.py's sum-CRCW histogram, in both
    libraries."""
    jprog = J.PRAMProgram(
        read_addr=lambda s, t: s,
        compute=lambda s, v, t: (s, s, jnp.ones_like(s, jnp.float32)))
    prog = PRAMProgram(
        read_addr=lambda s, t: s,
        compute=lambda s, v, t: (s, s, torch.ones_like(s,
                                                       dtype=torch.float32)))
    return jprog, prog


def _two_step_max_programs(P):
    """The max-CRCW parallel max of tests/test_paper_algorithms.py, run for
    two steps: in step 1 every processor writes its value to cell 0; in
    step 2 every processor reads the max there and writes max - value, so
    cell 0 ends at max(max, max - min)."""
    def jcompute(s, v, t):
        return s, jnp.zeros((P,), jnp.int32), s if t == 0 else v - s

    def compute(s, v, t):
        return s, torch.zeros((P,), dtype=torch.int32), s if t == 0 else v - s

    jprog = J.PRAMProgram(read_addr=lambda s, t: jnp.zeros((P,), jnp.int32),
                          compute=jcompute)
    prog = PRAMProgram(read_addr=lambda s, t: torch.zeros((P,),
                                                          dtype=torch.int32),
                       compute=compute)
    return jprog, prog


@pytest.mark.parametrize("program,engine", [
    ("histogram", None), ("histogram", "local"), ("max", None),
    ("max", "reference"),
])
def test_simulate_crcw_matches_jax(program, engine):
    rng = np.random.default_rng(21)
    if program == "histogram":
        P, M, steps = 256, 8, 1
        state = rng.integers(0, 10, P).astype(np.int32)
        memory = np.zeros(10, np.float32)
        jprog, prog = _histogram_programs(state)
        jop, top, identity = jnp.add, torch.add, 0.0
    else:
        P, M, steps = 500, 16, 2
        state = rng.normal(size=P).astype(np.float32)
        memory = np.full(1, -1e30, np.float32)
        jprog, prog = _two_step_max_programs(P)
        jop, top, identity = jnp.maximum, torch.maximum, None
    jeng = None if engine is None else _jax_engine(engine)
    teng = {None: None, "local": LocalEngine(device="cpu"),
            "reference": ReferenceEngine()}[engine]
    jcost, cost = J.MRCost(), MRCost()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if jeng is None:
            # the dense path jitted: its accounting is functional (what
            # ``cost=`` absorbs); eager, it compiles op by op
            _, jmem, jacc = jax.jit(lambda s, m: J.simulate_crcw(
                jprog, s, m, steps, M, jop, identity=identity,
                with_accum=True))(jnp.asarray(state), jnp.asarray(memory))
            jcost.absorb(jacc)
        else:
            _, jmem, jacc = J.simulate_crcw(
                jprog, jnp.asarray(state), jnp.asarray(memory), steps, M,
                jop, cost=jcost, identity=identity, engine=jeng,
                with_accum=True)
        _, mem, acc = simulate_crcw(prog, torch.from_numpy(state),
                                    torch.from_numpy(memory), steps, M, top,
                                    cost=cost, identity=identity,
                                    engine=teng, with_accum=True)
    np.testing.assert_array_equal(mem.numpy(), np.asarray(jmem))
    assert_same_accum(jacc, acc)
    assert vars(cost) == vars(jcost)
    if program == "histogram":
        np.testing.assert_array_equal(
            mem.numpy(), np.bincount(state, minlength=10).astype(np.float32))
    else:
        top = np.max(state)
        assert float(mem[0]) == float(max(top, top - np.min(state)))


# ------------------------------------------------------------- Thm 3.1
def _odd_even_programs(P):
    """tests/test_paper_algorithms.py's odd-even transposition sort."""
    def partner(ids, t, xp):
        left = (ids % 2 == 0) if t % 2 == 0 else (ids % 2 == 1)
        p = xp.where(left, ids + 1, ids - 1)
        ok = (p >= 0) & (p < P)
        return xp.where(ok, p, -1), left & ok

    def make(xp):
        def superstep(t, ids, state, inbox, inbox_valid):
            if t > 0:
                _, prev_left = partner(ids, t - 1, xp)
                pv = inbox[:, 0]
                lo, hi = xp.minimum(state, pv), xp.maximum(state, pv)
                state = xp.where(inbox_valid[:, 0],
                                 xp.where(prev_left, lo, hi), state)
            p, _ = partner(ids, t, xp)
            return state, p[:, None], state[:, None]
        return superstep
    return BSPProgramPair(make(jnp), make(torch))


def _allreduce_programs():
    """tests/test_paper_algorithms.py's tree all-reduce."""
    def make(xp, sum_rows):
        def superstep(t, ids, state, inbox, inbox_valid):
            state = state + sum_rows(xp.where(inbox_valid, inbox, 0.0))
            stride = 2 ** t
            sender = (ids % (2 * stride)) == stride
            return state, xp.where(sender, ids - stride, -1)[:, None], \
                state[:, None]
        return superstep
    return BSPProgramPair(make(jnp, lambda x: jnp.sum(x, axis=1)),
                          make(torch, lambda x: torch.sum(x, dim=1)))


class BSPProgramPair:
    def __init__(self, jfn, tfn):
        self.jax = J.BSPProgram(superstep=jfn)
        self.torch = BSPProgram(superstep=tfn)


@pytest.mark.parametrize("program,P,M,steps,oracle", [
    ("odd-even", 16, 2, 17, "local"), ("odd-even", 9, 2, 10, "reference"),
    ("allreduce", 16, 8, 5, "reference"), ("allreduce", 32, 8, 6, "local"),
    ("odd-even", 16, 1, 17, "local"),
])
def test_bsp_plan_matches_jax(program, P, M, steps, oracle):
    rng = np.random.default_rng(P + M)
    state = rng.normal(size=P).astype(np.float32)
    progs = (_odd_even_programs(P) if program == "odd-even"
             else _allreduce_programs())
    plan = J.bsp_plan(progs.jax, steps, M, P, jnp.float32(0))
    tplan = bsp_plan(progs.torch, steps, M, P, torch.tensor(0.0))
    assert tplan.schedule() == plan.schedule()
    assert tplan.round_bound == plan.round_bound
    assert tplan.n_nodes == plan.n_nodes
    want = _jax_engine(oracle).compile(plan)(jnp.asarray(state))
    for eng in _port_engines():
        got = eng.compile(tplan)(state)
        np.testing.assert_array_equal(got.proc_state.numpy(),
                                      np.asarray(want.proc_state),
                                      err_msg=eng.name)
        np.testing.assert_array_equal(got.dropped_per_step.numpy(),
                                      np.asarray(want.dropped_per_step))
        assert_same_accum(want.stats, got.stats, ctx=eng.name)
    # one message a processor each way: M = 1 fits too
    assert not got.dropped_per_step.any()
    if program == "odd-even":
        assert torch.equal(got.proc_state,
                           torch.sort(torch.from_numpy(state)).values)


def test_bsp_drops_are_reported_and_run_bsp_raises(cpu_default_engine):
    """Every processor messages processor 0 at M = 2: the plan reports the
    drops per superstep like the JAX plan, and run_bsp raises."""
    P, M = 8, 2

    def jstep(t, ids, state, inbox, valid):
        return state, jnp.zeros((P, 1), jnp.int32), state[:, None]

    def step(t, ids, state, inbox, valid):
        return state, torch.zeros((P, 1), dtype=torch.int32), state[:, None]

    state = np.arange(P, dtype=np.float32)
    want = J.LocalEngine().compile(J.bsp_plan(
        J.BSPProgram(jstep), 2, M, P, jnp.float32(0)))(jnp.asarray(state))
    got = LocalEngine(device="cpu").compile(bsp_plan(
        BSPProgram(step), 2, M, P, torch.tensor(0.0)))(state)
    np.testing.assert_array_equal(got.dropped_per_step.numpy(),
                                  np.asarray(want.dropped_per_step))
    assert got.dropped_per_step.tolist() == [P - M, P - M]
    assert_same_accum(want.stats, got.stats)
    with pytest.deprecated_call(), \
            pytest.raises(RuntimeError, match="superstep 0"):
        run_bsp(BSPProgram(step), state, 2, M, P, torch.tensor(0.0))
    # and a valid program through the wrapper feeds the cost adapter
    progs = _odd_even_programs(P)
    cost, jcost = MRCost(), J.MRCost()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout = J.run_bsp(progs.jax, jnp.asarray(state[::-1].copy()), P + 1,
                         2, P, jnp.float32(0), cost=jcost)
        out = run_bsp(progs.torch, state[::-1].copy(), P + 1, 2, P,
                      torch.tensor(0.0), cost=cost)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert vars(cost) == vars(jcost)


def test_bsp_nested_messages_and_fingerprint():
    """A message nest of two leaves routes both; the fingerprint tells
    nests apart by structure, dtype and shape, as a JAX treedef does."""
    P, M = 6, 2

    def step(t, ids, state, inbox, valid):
        got = torch.where(valid[:, 0], inbox["v"][:, 0], state)
        dests = ((ids + 1) % P)[:, None]
        return got, dests, {"v": got[:, None],
                            "w": torch.stack([ids, -ids], 1)[:, None, :]}

    tmpl = {"v": torch.tensor(0.0), "w": torch.zeros(2, dtype=torch.int32)}
    plan = bsp_plan(BSPProgram(step), 3, M, P, tmpl)
    res = LocalEngine(device="cpu").compile(plan)(np.arange(P,
                                                            dtype=np.float32))
    assert res.proc_state.tolist() == [4.0, 5.0, 0.0, 1.0, 2.0, 3.0]
    other = bsp_plan(BSPProgram(step), 3, M, P,
                     {"v": torch.tensor(0.0), "w": torch.zeros(3)})
    assert other.fingerprint != plan.fingerprint
    assert bsp_plan(BSPProgram(step), 3, M, P, tmpl).fingerprint == \
        plan.fingerprint
