"""The port's error-feedback int8 compression (``repro_torch.optim.compress``)
against the JAX package's ``repro.optim.compress`` on the same float32
arrays (numpy seeds): ``quantize_int8``, ``compress_with_feedback`` and the
stacked mean are bitwise equal (q, scale, residual, mean); the wire bytes
are the same numbers.  ``compressed_allreduce`` over a gloo group of one
rank is the dequantized ``compress_with_feedback``; across ranks it is
held by the mesh trainer's compressed runs against the JAX package's
(tests/test_torch_parallel_train.py).  Tolerance: none (bitwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as jc
from repro_torch.optim import compress as tc

SHAPES = [(7,), (33, 5), (4, 16, 9)]


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _eq(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_int8_is_bitwise_jax(shape, scale):
    x = _arr(shape, 1, scale)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    _eq(q, jq, "q")
    _eq(s, js, "scale")
    _eq(tc.dequantize_int8(q, s), jc.dequantize_int8(jq, js), "dequant")


def test_quantize_int8_of_zeros_uses_the_floor_scale():
    q, s = tc.quantize_int8(torch.zeros(5))
    jq, js = jc.quantize_int8(jnp.zeros(5))
    _eq(q, jq)
    _eq(s, js)


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_with_feedback_is_bitwise_jax_over_steps(shape):
    """Three steps of error feedback: q, scale and the carried residual."""
    r = torch.zeros(shape)
    jr = jnp.zeros(shape, jnp.float32)
    for step in range(3):
        g = _arr(shape, 10 + step)
        q, s, r = tc.compress_with_feedback(torch.from_numpy(g), r)
        jq, js, jr = jc.compress_with_feedback(jnp.asarray(g), jr)
        _eq(q, jq, f"q {step}")
        _eq(s, js, f"scale {step}")
        _eq(r, jr, f"residual {step}")


@pytest.mark.parametrize("n_pod", [1, 2, 3])
def test_stacked_compressed_mean_is_bitwise_jax(n_pod):
    grads = {"a": _arr((n_pod, 6, 4), 3), "b": [_arr((n_pod, 5), 4)]}
    tg = jax.tree_util.tree_map(torch.from_numpy, grads)
    shapes = {"a": torch.zeros(6, 4), "b": [torch.zeros(5)]}
    ef = tc.ef_init(shapes, n_pod=n_pod)
    jef = jc.ef_init({"a": jnp.zeros((6, 4)), "b": [jnp.zeros(5)]},
                     n_pod=n_pod)
    for step in range(2):
        mean, ef = tc.tree_stacked_compressed_mean(tg, ef)
        jmean, jef = jc.tree_stacked_compressed_mean(
            jax.tree_util.tree_map(jnp.asarray, grads), jef)
        _eq(mean["a"], jmean["a"], f"mean a {step}")
        _eq(mean["b"][0], jmean["b"][0], f"mean b {step}")
        _eq(ef.residual["a"], jef.residual["a"], f"residual a {step}")
        _eq(ef.residual["b"][0], jef.residual["b"][0], f"res b {step}")


def test_wire_bytes_match_jax_and_are_a_quarter():
    grads = {"w": np.zeros((128, 64), np.float32),
             "b": np.zeros(64, np.float32)}
    got = tc.compression_wire_bytes(jax.tree_util.tree_map(torch.from_numpy,
                                                           grads))
    want = jc.compression_wire_bytes(jax.tree_util.tree_map(jnp.asarray,
                                                            grads))
    assert got == want
    un, comp = got
    assert comp == un // 4 + 4 * 2


def test_ef_init_shapes_and_devices():
    ef = tc.ef_init({"w": torch.zeros(3, 2, dtype=torch.bfloat16)}, n_pod=4)
    r = ef.residual["w"]
    assert r.shape == (4, 3, 2) and r.dtype == torch.float32
    assert tc.ef_init({"w": torch.zeros(3)}).residual["w"].shape == (3,)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_allreduce_on_one_rank_is_the_feedback_step(shape, world1):
    g = torch.from_numpy(_arr(shape, 7))
    r0 = torch.from_numpy(_arr(shape, 8, 1e-3))
    mean, res = tc.compressed_allreduce(g, r0, group=None,
                                        scale_group=dist.group.WORLD)
    q, s, want_res = tc.compress_with_feedback(g, r0)
    assert torch.equal(mean, tc.dequantize_int8(q, s))
    assert torch.equal(res, want_res)
    tree, ef = tc.tree_compressed_allreduce({"g": g}, tc.EFState(
        residual={"g": r0}))
    assert torch.equal(tree["g"], mean) and torch.equal(ef.residual["g"],
                                                        res)
