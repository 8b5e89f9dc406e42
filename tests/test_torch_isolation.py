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
    prefills and serves a reduced TinyLlama, and prefills and decodes a
    reduced zamba2 and RWKV6."""
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
    from repro_torch.models import build_model
    if torch.cuda.is_available():
        assert LocalEngine().device.type == "cuda"
        cfg = get_config("tinyllama-1.1b", reduced=True)
        assert build_model(cfg).device.type == "cuda"
        assert lm_params_from_numpy(to_numpy(build_model(cfg).param_tree()),
                                    cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalEngine(shuffle_impl="kernel", device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(sort_plan(64, 8))
    default_engine.cache_clear()
    cfg = get_config("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--arch", "tinyllama-1.1b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_numpy(to_numpy(build_model(cfg, device="cpu")
                                      .param_tree()), cfg)


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
