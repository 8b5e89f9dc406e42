"""The port's ServeEngine against the JAX package's, on the CPU.

Both engines get the same params (the JAX ``model.init``, carried over by
``repro_torch.interop``), the same requests and each its own counter clock,
and are stepped in lockstep.  They must give the same per-request token
lists, ``rounds``, ``stats()`` and ``MRCost`` fields.  Greedy argmax may
flip between the frameworks on a near-tie: a token list may differ only
where the JAX logits' top-2 gap at that step is under 1e-4.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import KVDecodeState as JState
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import _zero_slot as jax_zero_slot
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, to_numpy
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import KVDecodeState, build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import _zero_slot

NEAR_TIE = 1e-4


def _counter():
    c = itertools.count()
    return lambda: float(next(c))


def _requests(seed, n, vocab, plen, new):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(*plen)))
        out.append((i, prompt.astype(np.int32), int(rng.integers(*new))))
    return out


def _top2_gap(row):
    top = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("arch,max_batch,max_len,n,plen,new,truncates", [
    # the serve_batch example: 12 requests, 3x over M = 4
    ("tinyllama-1.1b", 4, 96, 12, (4, 16), (8, 24), False),
    # slots that fill to max_len - 1 and finish there
    ("tinyllama-1.1b", 3, 24, 7, (10, 20), (6, 12), True),
    # tied embeddings and QKV biases
    ("qwen1.5-0.5b", 2, 40, 5, (2, 9), (3, 10), False),
    # the hybrid (Mamba2 state, shared attention K/V) and RWKV6 states
    ("zamba2-1.2b", 3, 40, 7, (4, 14), (5, 12), False),
    ("rwkv6-1.6b", 3, 24, 7, (10, 20), (6, 12), True),
])
def test_serve_engine_matches_jax(arch, max_batch, max_len, n, plen, new,
                                  truncates):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 cfg, device="cpu")
    jeng = JServeEngine(jcfg, jparams, JServeConfig(max_batch=max_batch,
                                                    max_len=max_len),
                        clock=_counter())
    teng = ServeEngine(model, ServeConfig(max_batch=max_batch,
                                          max_len=max_len), clock=_counter())
    last = {}

    def recording(fn, key):
        def call(*args):
            logits, state = fn(*args)
            last[key] = np.asarray(logits, np.float32)
            return logits, state
        return call

    jeng._jit_decode = recording(jeng._jit_decode, "jax")
    jreqs, treqs = {}, {}
    for uid, prompt, m in _requests(7, n, cfg.vocab_size, plen, new):
        jreqs[uid] = JRequest(uid=uid, prompt=prompt, max_new_tokens=m)
        treqs[uid] = Request(uid=uid, prompt=prompt, max_new_tokens=m)
        jeng.submit(jreqs[uid])
        teng.submit(treqs[uid])

    admitted, diverged = [], set()
    while jeng.queue or any(r is not None for r in jeng.active):
        # admit first, so the slots of this round are known; step() then
        # admits nothing more
        for eng in (jeng, teng):
            eng._admit()
        slots = {r.uid: i for i, r in enumerate(jeng.active) if r is not None}
        assert slots == {r.uid: i for i, r in enumerate(teng.active)
                         if r is not None}
        admitted += [u for u in slots if u not in admitted]
        assert jeng.step() == teng.step()
        for uid, slot in slots.items():
            jo, to = jreqs[uid].output, treqs[uid].output
            if uid in diverged or jo == to:
                continue
            assert len(jo) == len(to) and jo[:-1] == to[:-1], uid
            gap = _top2_gap(last["jax"][slot])
            assert gap < NEAR_TIE, (
                f"request {uid} token {len(jo) - 1}: {jo[-1]} vs {to[-1]} "
                f"with a top-2 logit gap of {gap}")
            diverged.add(uid)
        assert jeng.rounds < 10_000

    assert not teng.queue and all(r is None for r in teng.active)
    assert admitted == sorted(admitted)               # FIFO admission
    assert teng.rounds == jeng.rounds
    assert teng.stats() == jeng.stats()
    assert vars(teng.cost) == vars(jeng.cost)
    assert teng.cost.max_reducer_io <= max_batch
    assert [r.uid for r in teng.finished] == [r.uid for r in jeng.finished]
    for uid in jreqs:
        j, t = jreqs[uid], treqs[uid]
        assert (t.submitted_at, t.first_token_at, t.finished_at) == \
            (j.submitted_at, j.first_token_at, j.finished_at)
        if uid not in diverged:
            assert t.output == j.output, uid
    assert len(diverged) <= 1
    short = [u for u, r in jreqs.items() if len(r.output) < r.max_new_tokens]
    assert bool(short) == truncates, short


def test_zero_slot_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 3, 5, 1, 4)).astype(np.float32)
    v = rng.normal(size=(2, 3, 5, 1, 4)).astype(np.float32)
    pos = np.array([4, 2, 5], np.int32)
    want = jax_zero_slot(JState(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos)), 1)
    got = _zero_slot(KVDecodeState(torch.from_numpy(k.copy()),
                                   torch.from_numpy(v.copy()),
                                   torch.from_numpy(pos.copy())), 1)
    for w, g in zip(want, to_numpy(got)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_serve_cli_runs_on_cpu(capsys):
    serve_main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                "--requests", "5", "--max-batch", "2", "--new-tokens", "4"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 5 and stats["tokens"] == 20


def test_engine_on_a_built_model_drains():
    model = build_model(get_config("olmo-1b", reduced=True), device="cpu",
                        seed=5)
    eng = ServeEngine(model, ServeConfig(max_batch=3, max_len=32))
    for uid, prompt, m in _requests(1, 6, 256, (2, 6), (2, 5)):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == list(range(6))
    assert all(len(r.output) == r.max_new_tokens for r in done)
    assert eng.cost.max_reducer_io <= 3
