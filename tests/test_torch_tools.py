"""The port's tools (``repro_torch.tools``) against the JAX package's
``tools/*.py``.

``trace_summary``: on the same JSON-lines file both tools print the same
table, the same ``--json`` and the same ``--diff``, and exit with the same
code — on a trace written by ``repro.obs.write_jsonl`` and on one written by
``repro_torch.obs.write_jsonl``, on a drifted pair and on a broken
schedule; and on the trace the port's ``obs_demo`` example writes.
``check_api_surface``: the port's passes, pins each JAX set as a subset of
its own, and flags drift.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
import repro.obs as JO
from repro_torch.core import LocalEngine, sort_plan
from repro_torch.examples import obs_demo
from repro_torch.obs import Tracer, write_jsonl
from repro_torch.tools import check_api_surface, trace_summary

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool(name):
    """A JAX package tool, loaded from tools/<name>.py."""
    mod_name = f"_jax_tool_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod_name, ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return sys.modules[mod_name]


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """JSON-lines traces of a 2-level sort of 96 keys (and of 160 keys, the
    drifted one): by the JAX package, by the port, and the port's with one
    stage's measured rounds broken."""
    tmp = tmp_path_factory.mktemp("traces")
    x = np.random.default_rng(3).normal(size=160).astype(np.float32)
    key = jax.random.PRNGKey(3)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            from jax._src import core as jax_src_core
            mp.setattr(jax.core, "trace_state_clean",
                       jax_src_core.trace_state_clean, raising=False)
        # eager, so that the JAX tracer records each stage (a jitted
        # executable records the call only)
        tr = JO.Tracer()
        J.execute_plan(J.sort_plan(96, 8, levels=2), J.LocalEngine(tracer=tr),
                       (jnp.asarray(x[:96]),), key=key)
        JO.write_jsonl(tr, tmp / "jax.jsonl")
    out["jax"] = tmp / "jax.jsonl"
    for name, n in (("port", 96), ("drift", 160)):
        tr = Tracer()
        LocalEngine(device="cpu", tracer=tr).compile(
            sort_plan(n, 8, levels=2))(
                x[:n], key=np.asarray(jax.random.permutation(key, n)))
        write_jsonl(tr, tmp / f"{name}.jsonl")
        out[name] = tmp / f"{name}.jsonl"
    lines = [json.loads(s) for s in out["port"].read_text().splitlines()]
    stage = next(e for e in lines if e["kind"] == "plan.stage")
    stage["attrs"]["measured_rounds"] += 1
    out["broken"] = tmp / "broken.jsonl"
    out["broken"].write_text("".join(json.dumps(e) + "\n" for e in lines))
    return out


def _both(capsys, argv):
    """(stdout, exit code) of the JAX tool and of the port's on argv."""
    rc_jax = _jax_tool("trace_summary").main(argv)
    out_jax = capsys.readouterr().out
    rc_port = trace_summary.main(argv)
    out_port = capsys.readouterr().out
    return (out_jax, rc_jax), (out_port, rc_port)


@pytest.mark.parametrize("which", ["jax", "port", "broken"])
@pytest.mark.parametrize("mode", ["table", "json"])
def test_trace_summary_prints_what_the_jax_tool_prints(traces, capsys,
                                                       which, mode):
    argv = [str(traces[which])] + (["--json"] if mode == "json" else [])
    want, got = _both(capsys, argv)
    assert got == want
    assert got[1] == (1 if which == "broken" else 0)
    if mode == "table":
        assert ("MISMATCH" in got[0]) == (which == "broken")


@pytest.mark.parametrize("pair", [("jax", "port"), ("port", "port"),
                                  ("port", "drift"), ("jax", "drift")])
@pytest.mark.parametrize("mode", ["table", "json"])
def test_trace_summary_diff_matches_the_jax_tool(traces, capsys, pair,
                                                 mode):
    """Both packages' traces of the same query diff clean against each
    other (exit 0); a trace of another size drifts (exit 1)."""
    a, b = pair
    argv = [str(traces[a]), "--diff", str(traces[b])] + (
        ["--json"] if mode == "json" else [])
    want, got = _both(capsys, argv)
    assert got == want
    assert got[1] == (1 if b == "drift" else 0)


def test_trace_summary_exits_0_on_a_closed_pipe(traces):
    """``... | head`` closes the pipe: the port's tool exits 0.  (The JAX
    tool catches the BrokenPipeError too, but exits 120 when what is left
    in stdout's buffer fails again at the interpreter's exit, as it does
    on this trace.)"""
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tools.trace_summary",
         str(traces["port"]), "--json"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    p.stdout.close()
    err = p.stderr.read()
    assert p.wait(timeout=120) == 0, err


def test_check_api_surface_passes(capsys):
    assert check_api_surface.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(line.startswith("check_api_surface: ")
                                   and line.endswith(", OK")
                                   for line in lines)


@pytest.mark.parametrize("name", ["EXPECTED", "EXPECTED_PLAN",
                                  "EXPECTED_RECOVERY", "EXPECTED_OBS",
                                  "EXPECTED_SERVE"])
def test_jax_surfaces_are_subsets_of_the_ports(name):
    assert getattr(_jax_tool("check_api_surface"), name) <= getattr(
        check_api_surface, name)


def test_check_api_surface_flags_drift(monkeypatch, capsys):
    import repro_torch.obs as obs
    monkeypatch.setattr(obs, "__all__", [n for n in obs.__all__
                                         if n != "Tracer"] + ["Nothing"])
    assert check_api_surface.main() == 1
    cap = capsys.readouterr()
    assert "repro_torch.obs 19 names, DRIFT DETECTED" in cap.out
    assert "repro_torch.obs.__all__ lost: Tracer" in cap.err
    assert "gained" in cap.err and "unresolvable name: Nothing" in cap.err


def test_obs_demo_writes_a_trace_the_tool_reads(tmp_path, capsys):
    """The demo on the CPU: the trace files, the schedule, both failures,
    and the open-loop row of the JAX demo's traffic; the port's
    trace_summary reads the trace back (exit 0) and finds no drift
    against itself."""
    got = obs_demo.run(torch.device("cpu"), tmp_path)
    out = capsys.readouterr().out
    assert "schedule: measured == declared for every stage" in out
    assert got["queries"] == 48 and got["row"]["accepted"] == 48
    assert got["summary"]["recovery"]["failures"] == 2
    assert got["jsonl"].exists() and got["chrome"].exists()
    assert trace_summary.main([str(got["jsonl"])]) == 0
    assert trace_summary.main([str(got["jsonl"]), "--diff",
                               str(got["jsonl"])]) == 0
