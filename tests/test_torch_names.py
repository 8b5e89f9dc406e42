"""Every public name of ``repro`` has a counterpart in ``repro_torch`` or a
stated omission; the kernel modules' JAX names are ``ops``' dispatch; the
family builders build their family and refuse the others.

The diff reads each ``repro`` module's own names (functions and classes by
``__module__``, and module-level upper-case constants), so a name added to
the JAX package later fails here until the port has it or ``OMITTED`` says
why not.
"""
import importlib
import os
import pathlib
import types

import pytest
import torch

import repro.kernels as J_kernels
from repro_torch import kernels as K
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import (DecoderLM, EncDecLM, HybridLM, RWKVLM,
                                build_decoder_lm, build_encdec,
                                build_hybrid_lm, build_model, build_rwkv_lm)
from repro_torch.models import transformer as port_transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: whole JAX modules the port has no counterpart of, with the reason
OMITTED_MODULES = {
    "repro.core.applications":
        "a deprecation shim over repro.core.geometry",
    "repro.launch.inspect_hlo": "it reads XLA's compiled HLO text",
}

#: (JAX module, name) -> why the port has no counterpart
OMITTED = {
    ("repro.launch.mesh", "make_production_mesh"):
        "its shapes name TPU v5e pod slices; the port's dry run takes a "
        "mesh shape (launch.mesh.stand_in_mesh)",
    ("repro.models.sharding", "shard"): "a GSPMD placement hint",
    ("repro.models.sharding", "tree_shardings"): "GSPMD placement hints",
    ("repro.optim.compress", "compressed_psum"):
        "the port's counterpart is compressed_allreduce",
    ("repro.optim.compress", "tree_compressed_psum"):
        "the port's counterpart is compressed_allreduce",
    ("repro.launch.roofline", "extrapolate"):
        "it corrects XLA's once-counted lax.scan body from two shallow "
        "compiles; the port's counter runs eagerly and sees every layer",
    ("repro.launch.roofline", "proxy_depths"): "as extrapolate",
    ("repro.launch.roofline", "HBM_GB"):
        "a TPU v5e figure; the H100's are in core.costmodel",
    ("repro.launch.roofline", "ICI_BW"): "a TPU v5e figure",
    ("repro.launch.roofline", "PEAK_FLOPS"): "a TPU v5e figure",
    ("repro.launch.dryrun", "collective_bytes"):
        "it parses XLA's HLO text; the port counts every collective at "
        "core.distributed's door",
    ("repro.launch.dryrun", "collective_op_table"): "as collective_bytes",
    ("repro.core.costmodel", "ICI_BW"):
        "a TPU interconnect figure; the port's HardwareModel holds the "
        "H100's",
    ("repro.core.costmodel", "COLLECTIVE_LAUNCH_LATENCY"):
        "a TPU figure, as ICI_BW",
    ("repro.core.kshuffle", "route_log"):
        "the port keeps no module-global route log: each engine has its "
        "own (engine.route_log)",
    ("repro.models.layers", "residual_shard"):
        "the port's counterpart is seq_shard_activations "
        "(models.sharding.sequence)",
    ("repro.models.transformer", "Model"):
        "a NamedTuple of pure functions; its counterpart is the family's "
        "nn.Module, which holds the params and has those methods",
}

#: kernel-package names that are the ops functions in JAX and the kernel
#: modules in the port (whose functions are ops.<name> and <module>.<name>)
KERNEL_MODULE_NAMES = ("bincount", "bitonic_sort", "flash_attention",
                       "prefix_scan", "ssm_scan")


def _jax_modules():
    names = []
    for f in sorted((ROOT / "src" / "repro").rglob("*.py")):
        parts = f.relative_to(ROOT / "src").with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


JAX_MODULES = _jax_modules()


def _import_jax(name):
    """Import a JAX module; ``repro.launch.dryrun`` and ``inspect_hlo`` set
    XLA_FLAGS when imported, which is put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _defined(mod):
    """The public names ``mod`` defines: functions and classes whose
    ``__module__`` is ``mod``, and module-level upper-case constants."""
    out = set()
    for name, val in vars(mod).items():
        if name.startswith("_") or isinstance(val, types.ModuleType):
            continue
        if isinstance(val, (type, types.FunctionType)):
            if val.__module__ == mod.__name__:
                out.add(name)
        elif name.isupper():
            out.add(name)
    return out


@pytest.mark.parametrize("name", JAX_MODULES)
def test_every_public_name_has_a_counterpart(name):
    jmod = _import_jax(name)
    if name in OMITTED_MODULES:
        return
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = sorted(n for n in _defined(jmod)
                     if not hasattr(port, n) and (name, n) not in OMITTED)
    assert not missing, f"{port.__name__} lacks {missing}"


def test_omissions_are_real_and_name_jax_names():
    """Each stated omission names a module or a name the JAX package has
    and the port does not, so the lists cannot go stale."""
    for name in OMITTED_MODULES:
        assert name in JAX_MODULES
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module("repro_torch" + name[len("repro"):])
    for (name, n), why in OMITTED.items():
        assert why and name in JAX_MODULES
        assert hasattr(_import_jax(name), n), (name, n)
        port = importlib.import_module("repro_torch" + name[len("repro"):])
        assert not hasattr(port, n), (name, n)


def test_kernel_package_names():
    """The JAX package's kernel names exist; the five shadowed by ``ops``
    functions in JAX stay the port's modules, ``bincount_tiles`` is the
    function."""
    assert set(J_kernels.__all__) <= set(K.__all__)
    for name in KERNEL_MODULE_NAMES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert getattr(K, name) is mod
        assert callable(getattr(mod, name))
    assert K.bincount_tiles is ops.bincount_tiles
    assert K.ops is ops and isinstance(K.ref, types.ModuleType)


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-2, 40, (500,), dtype=torch.int32, generator=g)
    tiles = torch.randint(-1, 20, (3, 5, 16), dtype=torch.int32, generator=g)
    keys = torch.randn(4, 33, generator=g)
    vals = torch.arange(4 * 33, dtype=torch.int32).reshape(4, 33)
    q = torch.randn(2, 4, 9, 16, generator=g)
    k, v = torch.randn(2, 2, 9, 16, generator=g), torch.randn(2, 2, 9, 16,
                                                              generator=g)
    x = torch.randint(-9, 9, (3, 70), dtype=torch.int32, generator=g)
    a, h = torch.rand(2, 11, 6, generator=g), torch.randn(2, 11, 6,
                                                          generator=g)
    return {
        "bincount": (K.bincount.bincount, ops.bincount, (ids, 40), {}),
        "bincount_tiles": (K.bincount.bincount_tiles, ops.bincount_tiles,
                           (tiles, 20), {}),
        "bitonic_sort": (K.bitonic_sort.bitonic_sort, ops.bitonic_sort,
                         (keys, vals), {}),
        "flash_attention": (K.flash_attention.flash_attention,
                            ops.flash_attention, (q, k, v),
                            {"causal": False}),
        "prefix_scan": (K.prefix_scan.prefix_scan, ops.prefix_scan, (x,),
                        {"exclusive": True}),
        "ssm_scan": (K.ssm_scan.ssm_scan, ops.ssm_scan, (a, h), {}),
    }


@pytest.mark.parametrize("name", ["bincount", "bincount_tiles",
                                  "bitonic_sort", "flash_attention",
                                  "prefix_scan", "ssm_scan"])
def test_kernel_module_names_equal_ops_on_cpu(name):
    fn, want_fn, args, kw = _kernel_cases()[name]
    got, want = fn(*args, **kw), want_fn(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


def test_ssm_scan_module_name_is_differentiable():
    a = torch.rand(1, 7, 3, requires_grad=True)
    x = torch.randn(1, 7, 3, requires_grad=True)
    K.ssm_scan.ssm_scan(a, x).sum().backward()
    ga, gx = a.grad.clone(), x.grad.clone()
    a.grad = x.grad = None
    ops.ssm_scan(a, x).sum().backward()
    assert torch.equal(ga, a.grad) and torch.equal(gx, x.grad)


BUILDERS = {"tinyllama-1.1b": (build_decoder_lm, DecoderLM),
            "kimi-k2-1t-a32b": (build_decoder_lm, DecoderLM),
            "internvl2-2b": (build_decoder_lm, DecoderLM),
            "zamba2-1.2b": (build_hybrid_lm, HybridLM),
            "rwkv6-1.6b": (build_rwkv_lm, RWKVLM),
            "whisper-base": (build_encdec, EncDecLM)}


@pytest.mark.parametrize("arch", sorted(BUILDERS))
def test_family_builders(arch, monkeypatch):
    """Each builder builds its family (and build_model goes through it)
    and refuses the other families' configs with ValueError."""
    cfg = get_config(arch, reduced=True)
    build, cls = BUILDERS[arch]
    model = build(cfg, device="meta")
    assert type(model) is cls
    assert type(build(cfg, device="cpu", seed=3)) is cls
    calls = []

    def spy(*args):
        calls.append(args)
        return build(*args)
    target = (port_transformer if build is not build_encdec
              else importlib.import_module("repro_torch.models.encdec"))
    monkeypatch.setattr(target, build.__name__, spy)
    assert type(build_model(cfg, device="meta")) is cls and len(calls) == 1
    for other, (other_build, other_cls) in BUILDERS.items():
        if other_cls is not cls:
            with pytest.raises(ValueError, match="serves family"):
                other_build(cfg, device="meta")


def test_build_model_draws_the_same_params_as_its_builder():
    cfg = get_config("zamba2-1.2b", reduced=True)
    a = build_model(cfg, device="cpu", seed=5).param_tree()
    b = build_hybrid_lm(cfg, device="cpu", seed=5).param_tree()
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_jax_model_has_no_port_class_of_its_own():
    """``repro.models.Model`` is a NamedTuple of functions; the port's
    builders return modules that carry those functions as methods."""
    from repro.models import Model
    model = build_decoder_lm(get_config("tinyllama-1.1b", reduced=True),
                             device="meta")
    for field in Model._fields:
        if field != "cfg":
            assert callable(getattr(model, field)), field
    assert model.cfg.name == "tinyllama-1.1b"
