"""The port's ``train_lm`` example against the JAX package's: its
``hundred_m_config`` equals the JAX example's for every family, with the
parameter count of ``jax.eval_shape(model.init)``, and the example resumes
from its own checkpoint at a reduced width."""
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.examples import train_lm
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


FAMILY_ARCHS = ("qwen1.5-0.5b", "kimi-k2-1t-a32b", "internvl2-2b",
                "zamba2-1.2b", "rwkv6-1.6b", "whisper-base")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_hundred_m_config_matches_jax(arch):
    """The config equals the JAX example's, field by field, and the model
    on meta has the parameter count of ``jax.eval_shape(model.init)``.
    The JAX example raises for the encoder-decoder family (``n_layers``
    passed twice); there the port's equals the config it names."""
    jax_example = _jax_train_lm()
    got = train_lm.hundred_m_config(arch)
    if arch == "whisper-base":
        with pytest.raises(TypeError, match="n_layers"):
            jax_example.hundred_m_config(arch)
        want = dataclasses.replace(
            jax_get_config(arch), n_layers=8, enc_layers=4, d_model=640,
            n_heads=10, n_kv_heads=min(jax_get_config(arch).n_kv_heads, 10),
            d_ff=2560, vocab_size=32768, head_dim=64, param_dtype="float32",
            compute_dtype="float32")
    else:
        want = jax_example.hundred_m_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    model = build_model(got, device="meta")
    shapes = jax.eval_shape(jax_build_model(want).init,
                            jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def _jax_train_lm():
    """The JAX example module, loaded from examples/train_lm.py."""
    name = "_jax_example_train_lm"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / "train_lm.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def test_train_lm_resumes_from_its_checkpoint(tmp_path, capsys):
    """At a reduced width: two steps with a checkpoint at step 2, then a
    run to step 3 that resumes there and ends where one run of 3 steps
    does."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    first = train_lm.run(cfg, CPU, 2, 2, 16, tmp_path / "a", ckpt_every=2)
    assert first["resumed_at"] is None
    again = train_lm.run(cfg, CPU, 3, 2, 16, tmp_path / "a", ckpt_every=2)
    assert again["resumed_at"] == 2
    assert "resumed at step 2" in capsys.readouterr().out
    whole = train_lm.run(cfg, CPU, 3, 2, 16, tmp_path / "b", ckpt_every=2)
    assert abs(again["final_loss"] - whole["final_loss"]) <= 1e-5 * abs(
        whole["final_loss"])
