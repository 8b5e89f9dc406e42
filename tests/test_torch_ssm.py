"""The port's ssm_scan, prefix_scan and bincount, and its Mamba2 and RWKV6
blocks, against the JAX package on the CPU.

The same seeded numpy inputs go through each JAX function (its Pallas
kernels in interpret mode, through ``repro.kernels.ops``) and through the
port, whose wrappers take each kernel's plain PyTorch version on CPU
tensors.  Tolerances are those of ``tests/test_kernels.py``: 2e-4 for
ssm_scan, 2e-5 for float32 prefix sums, exact for integers; 2e-4 for the
blocks, in float32.  Block tests run with more than one head and with a
sequence length that is not a multiple of the chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.interop import tree_from_numpy
from repro_torch.kernels import bincount, ops, prefix_scan, ref, ssm_scan
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

RNG = np.random.default_rng(2025)
TOL = 2e-4


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------------ ssm_scan
@pytest.mark.parametrize("b,t,d,block_t", [
    (2, 100, 16, 64), (1, 513, 8, 128), (3, 64, 32, 16), (1, 16, 4, 16),
])
def test_ssm_scan_matches_jax(b, t, d, block_t):
    a = RNG.uniform(0.8, 1.0, size=(b, t, d)).astype(np.float32)
    x = _normal(b, t, d)
    want = jax_ops.ssm_scan(jnp.asarray(a), jnp.asarray(x), block_t=block_t)
    got = ops.ssm_scan(_t(a), _t(x))
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    _close(got, want)
    _close(ref.ssm_scan_ref(_t(a), _t(x)), want)


def test_ssm_scan_keeps_x_dtype_like_jax():
    a = RNG.uniform(0.5, 1.0, size=(2, 40, 8)).astype(np.float32)
    x = _normal(2, 40, 8)
    want = jax_ops.ssm_scan(jnp.asarray(a), jnp.asarray(x, jnp.bfloat16),
                            block_t=16)
    got = ops.ssm_scan(_t(a), _t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)


def test_ssm_scan_gradient_matches_jax_custom_vjp():
    """On the CPU the plain version is differentiable by autograd and
    agrees with the JAX entry point's custom VJP (the reversed scan)."""
    a = RNG.uniform(0.7, 1.0, size=(2, 37, 6)).astype(np.float32)
    x, w = _normal(2, 37, 6), _normal(2, 37, 6)
    ga, gx = jax.grad(lambda a_, x_: jnp.sum(
        jax_ops.ssm_scan(a_, x_, block_t=16) * w), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(x))
    ta, tx = _t(a).requires_grad_(), _t(x).requires_grad_()
    (ops.ssm_scan(ta, tx) * _t(w)).sum().backward()
    _close(ta.grad, ga, what="da")
    _close(tx.grad, gx, what="dx")


def test_ssm_scan_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="batch, seq, d"):
        ssm_scan.ssm_scan_plain(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))


# --------------------------------------------------------------- prefix_scan
def _scan_input(rows, n, dtype):
    if dtype == np.int32:
        return RNG.integers(-5, 50, (rows, n)).astype(dtype)
    return _normal(rows, n)


@pytest.mark.parametrize("rows,n,block_n", [
    (1, 16, 8), (4, 1000, 256), (8, 2048, 512), (2, 17, 8), (16, 128, 128),
    (2, 0, 8),           # empty scan axis: the input comes back
    (1, 1, 8),           # single element
    (3, 13, 8),          # non-block-multiple
    (2, 700, 512),       # non-power-of-two tail block
])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_matches_jax(rows, n, block_n, dtype, exclusive):
    x = _scan_input(rows, n, dtype)
    want = jax_ops.prefix_scan(jnp.asarray(x), exclusive=exclusive,
                               block_n=block_n)
    got = ops.prefix_scan(_t(x), exclusive=exclusive)
    oracle = ref.prefix_scan_ref(_t(x), exclusive=exclusive)
    assert got.dtype == _t(x).dtype and got.shape == (rows, n)
    if dtype == np.int32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(oracle.numpy(), np.asarray(want))
    else:
        _close(got, want, 2e-5)
        _close(oracle, want, 2e-5)


@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_int32_wraps_like_jax(exclusive):
    """torch.cumsum of int32 would return int64 without dtype=; JAX keeps
    int32 and wraps modulo 2^32."""
    x = RNG.integers(2 ** 29, 2 ** 31 - 1, (3, 40)).astype(np.int32)
    want = np.asarray(jax_ops.prefix_scan(jnp.asarray(x), exclusive=exclusive,
                                          block_n=16))
    got = ops.prefix_scan(_t(x), exclusive=exclusive)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.prefix_scan_ref(_t(x), exclusive=exclusive).numpy(), want)
    assert (want < 0).any()                         # it did wrap


def test_prefix_scan_rejects_other_ranks():
    with pytest.raises(ValueError, match="rows, n"):
        prefix_scan.prefix_scan_plain(torch.zeros(3))


# ------------------------------------------------------------------ bincount
@pytest.mark.parametrize("n,n_buckets,block_t", [
    (100, 8, 32), (5000, 50, 1024), (1024, 384, 256), (7, 3, 8),
    (0, 8, 32),          # empty input
    (13, 64, 8),         # n_buckets > n, non-block-multiple
    (31, 5, 16),         # non-power-of-two, non-block-multiple
    (6, 100, 1024),      # block_t > n
])
def test_bincount_matches_jax(n, n_buckets, block_t):
    # ids from -3 to n_buckets + 2: negative and too-large ones are ignored
    ids = RNG.integers(-3, n_buckets + 3, n).astype(np.int32)
    want = np.asarray(jax_ops.bincount(jnp.asarray(ids), n_buckets,
                                       block_t=block_t))
    got = ops.bincount(_t(ids), n_buckets)
    assert got.dtype == torch.int32 and got.shape == (n_buckets,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.bincount_ref(_t(ids), n_buckets)
                                  .numpy(), want)


@pytest.mark.parametrize("case", ["offset-1", "offset-2", "offset-3",
                                  "one-bucket"])
def test_bincount_matches_jax_on_offset_views_and_one_bucket(case):
    """ids a view 1-3 elements into a longer vector (the card kernel's
    scalar head and tail), and every id in one bucket."""
    if case == "one-bucket":
        ids = np.full(1000, 37, np.int32)
        got = ops.bincount(_t(ids), 64)
    else:
        off = int(case[-1])
        base = RNG.integers(-3, 67, 1003 + off).astype(np.int32)
        ids = base[off:off + 1003]
        view = _t(base)[off:off + 1003]
        assert view.storage_offset() == off
        got = ops.bincount(view, 64)
    want = np.asarray(jax_ops.bincount(jnp.asarray(ids), 64, block_t=256))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bincount_all_dropped_like_jax():
    ids = np.array([-1] * 20 + [7] * 20, np.int32)
    want = np.asarray(jax_ops.bincount(jnp.asarray(ids), 7, block_t=16))
    np.testing.assert_array_equal(ops.bincount(_t(ids), 7).numpy(), want)
    assert not want.any()


def test_bincount_rejects_other_ranks():
    with pytest.raises(ValueError, match=r"\(n,\)"):
        bincount.bincount_plain(torch.zeros((2, 2), dtype=torch.int32), 4)


# ------------------------------------------------------------------- Mamba2
def _cfgs(arch, **kw):
    return (jax_get_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


def _mamba_params(cfg):
    """Random values in every leaf, so a leaf read wrongly shows."""
    d = cfg.d_model
    d_in, h, n = tssm.ssm_dims(cfg)
    return {"in_proj": _normal(d, 2 * d_in + 2 * n + h, scale=d ** -0.5),
            "conv_w": _normal(tssm.D_CONV, d_in + 2 * n, scale=0.5),
            "A_log": _normal(h, scale=0.5),
            "D": _normal(h) + 1.0,
            "dt_bias": _normal(h, scale=0.5),
            "out_proj": _normal(d_in, d, scale=d_in ** -0.5),
            "norm_scale": _normal(d_in, scale=0.2) + 1.0}


def test_mamba_init_matches_jax_names_shapes_and_dtypes():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    want = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    got = tssm.init_mamba(gen, tcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("s", [13, 16, 3])
def test_apply_mamba_matches_jax(s):
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    assert tssm.ssm_dims(tcfg)[1] > 1 and tcfg.ssm_chunk == 8
    p = _mamba_params(tcfg)
    x = _normal(2, s, tcfg.d_model)
    # jitted: eager, the chunked scan compiles op by op
    jy, jst = jax.jit(lambda p_, x_: jssm.apply_mamba(
        p_, jcfg, x_, return_state=True))(_jax(p), jnp.asarray(x))
    ty, tst = tssm.apply_mamba(tree_from_numpy(p), tcfg, _t(x),
                               return_state=True)
    _close(ty, jy, what="y")
    _close(tst.h, jst.h, what="h")
    _close(tst.conv, jst.conv, what="conv")
    assert tst.h.dtype == tst.conv.dtype == torch.float32
    _close(tssm.apply_mamba(tree_from_numpy(p), tcfg, _t(x)), jy, what="y")


def test_mamba_decode_step_matches_jax():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    p = _mamba_params(tcfg)
    d_in, h, n = tssm.ssm_dims(tcfg)
    h0 = _normal(3, h, n, tssm.SSM_HEAD)
    conv0 = _normal(3, tssm.D_CONV - 1, d_in + 2 * n)
    x = _normal(3, 1, tcfg.d_model)
    jy, jst = jssm.mamba_decode_step(
        _jax(p), jcfg, jnp.asarray(x),
        jssm.MambaState(h=jnp.asarray(h0), conv=jnp.asarray(conv0)))
    ty, tst = tssm.mamba_decode_step(
        tree_from_numpy(p), tcfg, _t(x),
        tssm.MambaState(h=_t(h0), conv=_t(conv0)))
    _close(ty, jy, what="y")
    _close(tst.h, jst.h, what="h")
    _close(tst.conv, jst.conv, what="conv")


def test_mamba_state_and_init_state_match_jax():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    want = jssm.init_mamba_state(jcfg, 3)
    got = tssm.init_mamba_state(tcfg, 3, device="cpu")
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w = _normal(2, 5, 6), _normal(tssm.D_CONV, 6)
    st = _normal(2, tssm.D_CONV - 1, 6) if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    _close(ty, jy)
    _close(tst, jst)


# -------------------------------------------------------------------- RWKV6
def _rwkv_time_params(cfg):
    d = cfg.d_model
    h, hd = trwkv.rwkv_dims(cfg)
    p = {"mu": RNG.uniform(0, 1, (5, d)).astype(np.float32),
         "w0": _normal(d, scale=0.5) - 2.0,
         "w_lora_a": _normal(d, trwkv.DECAY_LORA, scale=d ** -0.5),
         "w_lora_b": _normal(trwkv.DECAY_LORA, d, scale=0.3),
         "u": _normal(h, hd, scale=0.5),
         "ln_x_scale": _normal(d, scale=0.2) + 1.0}
    for k in ("receptance", "key", "value", "gate", "output"):
        p[k] = _normal(d, d, scale=d ** -0.5)
    return p


def _rwkv_chan_params(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": RNG.uniform(0, 1, (2, d)).astype(np.float32),
            "wk": _normal(d, f, scale=d ** -0.5),
            "wv": _normal(f, d, scale=f ** -0.5),
            "wr": _normal(d, d, scale=d ** -0.5)}


@pytest.mark.parametrize("which", ["time", "channel"])
def test_rwkv_init_matches_jax_names_shapes_and_dtypes(which):
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    jfn, tfn = ((jrwkv.init_rwkv_time, trwkv.init_rwkv_time)
                if which == "time" else
                (jrwkv.init_rwkv_channel, trwkv.init_rwkv_channel))
    want = jfn(jax.random.PRNGKey(0), jcfg)
    got = tfn(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
    for k in set(want) & {"mu", "w0", "u", "ln_x_scale"}:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("s,chunk", [(13, 8), (16, 8), (21, 64)])
def test_apply_rwkv_time_matches_jax(s, chunk):
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    assert trwkv.rwkv_dims(tcfg)[0] > 1
    p = _rwkv_time_params(tcfg)
    x = _normal(2, s, tcfg.d_model)
    # jitted: eager, the chunk loop compiles op by op
    jy, (jS, jx) = jax.jit(lambda p_, x_: jrwkv.apply_rwkv_time(
        p_, jcfg, x_, chunk=chunk, return_state=True))(_jax(p),
                                                       jnp.asarray(x))
    ty, (tS, tx) = trwkv.apply_rwkv_time(tree_from_numpy(p), tcfg, _t(x),
                                         chunk=chunk, return_state=True)
    _close(ty, jy, what="y")
    _close(tS, jS, what="S")
    _close(tx, jx, what="x_last")
    _close(trwkv.apply_rwkv_time(tree_from_numpy(p), tcfg, _t(x),
                                 chunk=chunk), jy, what="y")


@pytest.mark.parametrize("with_prev", [False, True])
def test_apply_rwkv_channel_matches_jax(with_prev):
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    p = _rwkv_chan_params(tcfg)
    x = _normal(2, 7, tcfg.d_model)
    prev = _normal(2, tcfg.d_model) if with_prev else None
    want = jrwkv.apply_rwkv_channel(_jax(p), jcfg, jnp.asarray(x),
                                    None if prev is None else
                                    jnp.asarray(prev))
    got = trwkv.apply_rwkv_channel(tree_from_numpy(p), tcfg, _t(x),
                                   None if prev is None else _t(prev))
    _close(got, want)


def test_rwkv_decode_steps_match_jax():
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    pt, pc = _rwkv_time_params(tcfg), _rwkv_chan_params(tcfg)
    h, hd = trwkv.rwkv_dims(tcfg)
    d = tcfg.d_model
    st = (_normal(3, h, hd, hd), _normal(3, d), _normal(3, d))
    x = _normal(3, 1, d)
    jst = jrwkv.RWKVState(*map(jnp.asarray, st))
    tst = trwkv.RWKVState(*map(_t, st))
    jy, jst = jrwkv.rwkv_time_decode(_jax(pt), jcfg, jnp.asarray(x), jst)
    ty, tst = trwkv.rwkv_time_decode(tree_from_numpy(pt), tcfg, _t(x), tst)
    _close(ty, jy, what="time y")
    jy, jst = jrwkv.rwkv_channel_decode(_jax(pc), jcfg, jy, jst)
    ty, tst = trwkv.rwkv_channel_decode(tree_from_numpy(pc), tcfg, ty, tst)
    _close(ty, jy, what="channel y")
    for name, g, w in zip(tst._fields, tst, jst):
        _close(g, w, what=name)
    want = jrwkv.init_rwkv_state(jcfg, 3)
    got = trwkv.init_rwkv_state(tcfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32


def test_rwkv_time_decode_continues_prefill_like_jax():
    """Prefill of s tokens then one decode step equals prefill of s + 1
    tokens: the state returned by prefill is the state after the last real
    token (the padding carries it)."""
    _, tcfg = _cfgs("rwkv6-1.6b")
    p = tree_from_numpy(_rwkv_time_params(tcfg))
    x = _normal(2, 12, tcfg.d_model)
    full = trwkv.apply_rwkv_time(p, tcfg, _t(x), chunk=8)
    _, (S, x_last) = trwkv.apply_rwkv_time(p, tcfg, _t(x[:, :11]), chunk=8,
                                           return_state=True)
    st = trwkv.init_rwkv_state(tcfg, 2, device="cpu")._replace(S=S, x_time=x_last)
    y, _ = trwkv.rwkv_time_decode(p, tcfg, _t(x[:, 11:]), st)
    _close(y[:, 0], full[:, -1], 1e-3)
