"""The port stands alone: it imports no JAX and nothing of ``repro``, and
its entry points run on the card unless asked for the CPU."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import)\b)",
    re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_sorts_on_cpu_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, the port imports and sorts on the CPU through the kernel engine,
    runs a multisearch, a physical prefix, a write funnel, a BSP plan, a
    2-D hull, a 3-D hull and an LP there, prefills and serves a reduced
    TinyLlama, prefills and decodes a reduced zamba2 and RWKV6, trains
    a reduced zamba2 for 2 steps, recovers a sort from an injected fault,
    traces a sort, and drains a ``QueryService``."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np, torch
        import repro_torch, repro_torch.core, repro_torch.kernels.ops
        import repro_torch.interop, repro_torch.testing
        import repro_torch.launch.serve
        from repro_torch.core import get_engine, sort_plan
        eng = get_engine("kernel", device="cpu")
        x = np.random.default_rng(0).normal(size=500).astype(np.float32)
        res = eng.compile(sort_plan(500, 16, levels=2))(x, key=1)
        assert torch.equal(res.values, torch.sort(torch.from_numpy(x)).values)
        assert int(res.stats.dropped) == 0
        assert eng.route_log.snapshot() == (3, 0)
        from repro_torch.core import (BSPProgram, bsp_plan, funnel_write_plan,
                                      multisearch_plan, prefix_plan)
        eng.route_log.reset()
        q = np.random.default_rng(1).normal(size=300).astype(np.float32)
        piv = np.sort(q[:40])
        res = eng.compile(multisearch_plan(300, 40, 8))(q, piv, key=2)
        assert res.buckets.tolist() == np.searchsorted(piv, q).tolist()
        v = np.arange(-50, 450, dtype=np.int32)
        res = eng.compile(prefix_plan(500, 8, physical=True))(v)
        assert res.values.tolist() == np.cumsum(v).tolist()
        addrs = np.arange(400, dtype=np.int32) % 7 - 1
        res = eng.compile(funnel_write_plan(400, 6, 8, torch.add,
                                            identity=0, dtype="int32"))(
            addrs, np.ones(400, np.int32), np.zeros(6, np.int32))
        assert res.memory.tolist() == np.bincount(addrs[addrs >= 0]).tolist()
        step = lambda t, ids, s, box, ok: (s, ((ids + 1) % 8)[:, None],
                                           s[:, None])
        res = eng.compile(bsp_plan(BSPProgram(step), 2, 2, 8,
                                   torch.tensor(0.0)))(np.zeros(8, np.float32))
        assert res.dropped_per_step.tolist() == [0, 0]
        from repro_torch.core import (convex_hull_3d_oracle,
                                      convex_hull_oracle, hull2d_plan,
                                      hull3d_plan, linear_program_oracle,
                                      lp_plan)
        p2 = np.random.default_rng(3).normal(size=(200, 2)).astype(np.float32)
        res = eng.compile(hull2d_plan(200, 16))(p2, key=4)
        h = int(res.count)
        assert int(res.stats.dropped) == 0
        assert np.array_equal(res.points[:h].numpy(), convex_hull_oracle(p2))
        p3 = np.random.default_rng(5).normal(size=(9, 3)).astype(np.float32)
        res = eng.compile(hull3d_plan(9, 8))(p3)
        assert np.flatnonzero(res.mask.numpy()).tolist() == \
            convex_hull_3d_oracle(p3).tolist()
        rng = np.random.default_rng(6)
        A = rng.normal(size=(9, 3)).astype(np.float32)
        b = rng.uniform(1, 2, 9).astype(np.float32)
        c = np.array([1.0, -0.5, 0.25], np.float32)
        res = eng.compile(lp_plan(9, 3, 16))(c, A, b)
        assert abs(float(res.objective)
                   - linear_program_oracle(c, A, b)[1]) < 1e-4
        assert eng.route_log.dense == 0 and eng.route_log.kernel > 0
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.serve import Request, ServeConfig, ServeEngine
        cfg = get_config("tinyllama-1.1b", reduced=True, attn_impl="flash")
        model = build_model(cfg, device="cpu", seed=0)
        logits, state = model.prefill(torch.zeros((2, 5), dtype=torch.int32),
                                      max_len=8)
        assert logits.shape == (2, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        assert state.pos.tolist() == [5, 5]
        serve = ServeEngine(model, ServeConfig(max_batch=2, max_len=16))
        for i in range(3):
            serve.submit(Request(uid=i, prompt=np.arange(1, 4 + i,
                                                         dtype=np.int32),
                                 max_new_tokens=3))
        assert len(serve.run_until_drained()) == 3
        for arch in ("zamba2-1.2b", "rwkv6-1.6b"):
            m = build_model(get_config(arch, reduced=True), device="cpu")
            logits, state = m.prefill(torch.zeros((2, 5), dtype=torch.int32),
                                      max_len=8)
            logits, state = m.decode_step(torch.zeros(2, dtype=torch.int32),
                                          state)
            assert bool(torch.isfinite(logits).all())
            assert state.pos.tolist() == [6, 6]
        from repro_torch.train import Trainer, TrainConfig
        import repro_torch.launch.train
        tr = Trainer(TrainConfig(arch=get_config("zamba2-1.2b", reduced=True),
                                 global_batch=2, seq_len=16, steps=2,
                                 log_every=1, warmup_steps=1), device="cpu")
        hist = tr.train()["history"]
        assert [s for s, _ in hist] == [1, 2]
        assert all(np.isfinite(l) for _, l in hist)
        assert int(tr.opt_state.step) == 2
        import tempfile
        from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                               run_plan_with_recovery)
        from repro_torch.obs import Tracer, summarize, write_jsonl
        plan = sort_plan(500, 16)
        with tempfile.TemporaryDirectory() as d:
            res, rep = run_plan_with_recovery(
                plan, eng, (x,), key=1, faults=FaultConfig(fail_at=(1,)),
                checkpointer=Checkpointer(d, plan=plan, every=1,
                                          async_save=True))
            assert rep.restarts == 1 and rep.checkpoints_written > 0
            assert torch.equal(res.values,
                               torch.sort(torch.from_numpy(x)).values)
            tr = Tracer()
            traced = get_engine("kernel", device="cpu", tracer=tr).compile(
                plan)(x, key=1)
            assert torch.equal(traced.values, res.values)
            assert summarize(tr)["schedule_ok"]
            assert write_jsonl(tr, d + "/t.jsonl") == len(tr)
        from repro_torch.serve import QueryService, VirtualClock
        from repro_torch.serve.loadgen import (TrafficConfig, make_suite,
                                               make_workload, run_sequential,
                                               assert_results_equal)
        svc = QueryService(eng, max_batch=4, clock=VirtualClock())
        wl = make_workload(make_suite(eng, TrafficConfig(n_queries=12)),
                           TrafficConfig(n_queries=12))
        tickets = [svc.submit(q.plan, *q.inputs, key=q.key) for q in wl]
        svc.drain()
        assert all(t.done and not t.failed for t in tickets)
        assert_results_equal({q.uid: t.value for q, t in zip(wl, tickets)},
                             run_sequential(eng, wl)[0], "service")
        assert not [m for m, mod in sys.modules.items() if mod is not None
                    and (m in ("jax", "repro")
                         or m.startswith(("jax.", "repro.")))]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sharded_engine_and_gloo_helper_with_jax_blocked(tmp_path):
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, ``repro_torch.core.distributed`` and the multi-rank helper
    ``repro_torch.dist_check`` import, and one gloo rank runs the helper's
    shuffle, round and plan cases and its own check against the port's
    LocalEngine."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from pathlib import Path
        import repro_torch.core.distributed
        from repro_torch import dist_check
        out = Path({str(tmp_path)!r})
        dist_check.run_rank(0, 1, out, ["shuffle", "rounds", "plans",
                                        "collectives", "errors"], None)
        assert dist_check.check_results(dist_check.load_ranks(out, 1)) > 50
        assert not [m for m, mod in sys.modules.items() if mod is not None
                    and (m in ("jax", "repro")
                         or m.startswith(("jax.", "repro.")))]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    from repro_torch.core import LocalEngine, compile_plan, sort_plan
    from repro_torch.core.engine import default_engine
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy, to_numpy
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainConfig
    if torch.cuda.is_available():
        assert LocalEngine().device.type == "cuda"
        from repro_torch.core import make_queues, random_indexing
        assert make_queues(4, 8, torch.tensor(0.0)).head.device.type == "cuda"
        assert random_indexing(16, 0, 8).device.type == "cuda"
        cfg = get_config("tinyllama-1.1b", reduced=True)
        assert build_model(cfg).device.type == "cuda"
        assert lm_params_from_numpy(to_numpy(build_model(cfg).param_tree()),
                                    cfg).device.type == "cuda"
        assert Trainer(TrainConfig(arch=cfg)).model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalEngine(shuffle_impl="kernel", device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(sort_plan(64, 8))
    default_engine.cache_clear()
    from repro_torch.core import make_queues, random_indexing
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_queues(4, 8, torch.tensor(0.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_indexing(16, 0, 8)
    cfg = get_config("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--arch", "tinyllama-1.1b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(arch=cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--arch", "zamba2-1.2b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_numpy(to_numpy(build_model(cfg, device="cpu")
                                      .param_tree()), cfg)


@pytest.mark.parametrize("name", ["quickstart", "mr_algorithms",
                                  "serve_queries", "serve_batch",
                                  "obs_demo", "train_lm"])
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for the card; where there is
    no CUDA its ``main`` raises rather than running on the CPU."""
    import importlib
    from repro_torch.examples._common import parser
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if torch.cuda.is_available():
        assert parser(mod.__doc__).parse_args([]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.mark.parametrize("arch,module,init", [
    ("zamba2-1.2b", "ssm", "init_mamba_state"),
    ("rwkv6-1.6b", "rwkv", "init_rwkv_state"),
])
def test_decode_state_inits_default_to_the_card(arch, module, init):
    import importlib
    from repro_torch.configs import get_config
    fn = getattr(importlib.import_module(f"repro_torch.models.{module}"), init)
    cfg = get_config(arch, reduced=True)
    assert all(t.device.type == "cpu" for t in fn(cfg, 2, device="cpu"))
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in fn(cfg, 2))
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(cfg, 2)
