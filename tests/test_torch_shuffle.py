"""Port shuffles (dense and kernel) vs the JAX package's shuffles.

The same seeded numpy destinations and payloads go through one of the JAX
package's three shuffles — ``ReferenceEngine.shuffle`` (the numpy loop, for
the wide fuzz grid), ``repro.core.mrmodel.shuffle`` (dense) or
``repro.core.kshuffle.kernel_shuffle`` (Pallas in interpret mode, at tiny
tiles) — and through the port's dense shuffle, kernel shuffle and
ReferenceEngine.  Mailbox
payload, validity and every RoundStats field must agree exactly, and the
port's stats are int32.  The kernel path's guards are held against the JAX
package's at the exact edges.
"""
import numpy as np
import pytest
import torch

from repro.core import ReferenceEngine as JaxReferenceEngine
from repro.core import kshuffle as jax_kshuffle
from repro.core.mrmodel import shuffle as jax_dense_shuffle
from repro_torch.core import LocalEngine, ReferenceEngine, get_engine
from repro_torch.core import kshuffle
from repro_torch.core.kshuffle import kernel_fits, kernel_shuffle
from repro_torch.core.mrmodel import shuffle as dense_shuffle
from repro_torch.interop import tree_from_numpy
from repro_torch.testing import assert_same_box, assert_same_stats

PATTERNS = ("uniform", "all_same", "all_invalid", "overflow", "more_nodes",
            "empty_2d")


def _case(seed):
    """The differential fuzz cases of the JAX package's kernel-shuffle
    suite: every destination pattern the dense shuffle accepts."""
    rng = np.random.default_rng(seed)
    pattern = PATTERNS[seed % len(PATTERNS)]
    V = int(rng.integers(1, 24))
    cap = int(rng.integers(1, 6))
    n = int(rng.integers(0, 300))
    if pattern == "uniform":
        dests = rng.integers(-1, V, n)
    elif pattern == "all_same":
        dests = np.full(n, int(rng.integers(0, V)))
    elif pattern == "all_invalid":
        dests = np.full(n, -1)
    elif pattern == "overflow":
        V, cap = int(rng.integers(1, 4)), 1
        dests = rng.integers(-1, V, n)
    elif pattern == "more_nodes":
        V, n = 300, int(rng.integers(0, 40))
        dests = rng.integers(-1, V, n)
    else:                                        # empty_2d: (0, M) sends
        dests = np.zeros((0, int(rng.integers(1, 5))))
    dests = dests.astype(np.int32)
    payload = {"x": rng.normal(size=dests.shape).astype(np.float32),
               "y": rng.integers(0, 99, dests.shape + (2,)).astype(np.int32)}
    return dests, payload, V, cap


def _port_results(dests, payload, V, cap, tile_n=None):
    td, tp = torch.from_numpy(dests), tree_from_numpy(payload)
    return {"dense": dense_shuffle(td, tp, V, cap),
            "kernel": kernel_shuffle(td, tp, V, cap, tile_n=tile_n),
            "reference": ReferenceEngine().shuffle(dests, payload, V, cap)}


def _assert_all_match(want, results, ctx):
    box_w, st_w = want
    for name, (box, st) in results.items():
        assert_same_box(box_w, box, ctx=f"{ctx} {name}")
        assert_same_stats(st_w, st, ctx=f"{ctx} {name}")


@pytest.mark.parametrize("seed", range(18))
def test_fuzz_matches_jax_reference(seed):
    dests, payload, V, cap = _case(seed)
    tile_n = (None, 8, 32)[seed % 3]
    _assert_all_match(JaxReferenceEngine().shuffle(dests, payload, V, cap),
                      _port_results(dests, payload, V, cap, tile_n),
                      f"seed={seed} V={V} cap={cap} shape={dests.shape} "
                      f"tile_n={tile_n}")


@pytest.mark.parametrize("tile_n", [1, 3, 8])
def test_multi_tile_matches_jax_kernel(tile_n):
    """Tiny tiles cross every tile boundary: the cross-tile prefix must
    stitch per-tile ranks into the JAX kernel path's global FIFO order."""
    rng = np.random.default_rng(42 + tile_n)
    V, cap, n = 7, 3, 45
    dests = rng.integers(-1, V, n).astype(np.int32)
    payload = rng.normal(size=n).astype(np.float32)
    want = jax_kshuffle.kernel_shuffle(dests, payload, V, cap, tile_n=tile_n)
    _assert_all_match(want, _port_results(dests, payload, V, cap, tile_n),
                      f"tile_n={tile_n}")


def test_forced_overflow_fifo_matches_jax_dense():
    """3x oversubscription: identical FIFO-kept prefix and drop count."""
    V, cap = 4, 3
    dests = np.asarray([0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0], np.int32)
    payload = np.arange(12, dtype=np.float32)
    want = jax_dense_shuffle(dests, payload, V, cap)
    results = _port_results(dests, payload, V, cap)
    assert int(results["kernel"][1].dropped) == 6
    _assert_all_match(want, results, "overflow")


@pytest.mark.parametrize("seed", range(2))
def test_2d_mailbox_sends_match_jax_reference(seed):
    rng = np.random.default_rng(100 + seed)
    V, cap = int(rng.integers(2, 10)), int(rng.integers(1, 5))
    dests = rng.integers(-1, V, (V, cap)).astype(np.int32)
    payload = rng.normal(size=(V, cap)).astype(np.float32)
    _assert_all_match(JaxReferenceEngine().shuffle(dests, payload, V, cap),
                      _port_results(dests, payload, V, cap), f"seed={seed}")


@pytest.mark.parametrize("dests_shape,V,cap", [
    ((0,), 1, 2), ((0,), 4, 2), ((0, 3), 1, 2), ((0, 3), 4, 3), ((5,), 1, 2),
    ((9,), 5, 2), ((3,), 64, 2),
], ids=["n0-V1", "n0-V4", "2d-empty-V1", "2d-empty-V4", "V1-overflow",
        "all-invalid", "more-nodes"])
def test_empty_and_degenerate_match_jax(dests_shape, V, cap):
    n = int(np.prod(dests_shape))
    if dests_shape == (9,):
        dests = np.full(dests_shape, -1, np.int32)
    elif dests_shape == (3,):
        dests = np.asarray([7, 0, 7], np.int32)
    else:
        dests = np.zeros(dests_shape, np.int32)
    payload = np.arange(float(n), dtype=np.float32).reshape(dests_shape)
    want = jax_dense_shuffle(dests, payload, V, cap)
    results = _port_results(dests, payload, V, cap)
    for name, (box, _) in results.items():
        assert tuple(box.valid.shape) == (V, cap), name
    _assert_all_match(want, results, f"{dests_shape} V={V}")


def test_engines_take_numpy_and_route_per_call(monkeypatch):
    """The kernel engine routes each call through kernel_fits: past the
    counts budget it takes the dense shuffle, below it the kernels, with
    results identical to the dense engine and every decision counted."""
    V, cap = 8, 4
    tile = kshuffle._tile_width(V)
    monkeypatch.setattr(kshuffle, "_COUNTS_BUDGET", V + 1)
    rng = np.random.default_rng(10)
    eng = get_engine("kernel", device="cpu")
    oracle = LocalEngine(device="cpu")
    for n in (2 * tile, 64):
        d = rng.integers(-1, V, n).astype(np.int32)
        p = np.arange(n, dtype=np.float32)
        box_o, st_o = oracle.shuffle(d, p, V, cap)
        box_k, st_k = eng.shuffle(d, p, V, cap)
        assert_same_box(box_o, box_k, ctx=f"n={n}")
        assert_same_stats(st_o, st_k, ctx=f"n={n}")
    assert eng.route_log.snapshot() == (1, 1)
    assert oracle.route_log.snapshot() == (0, 0)


GUARD_CASES = [
    (100, 8, None), (0, 5, None), ((1 << 18) - 1, 64, None),
    ((1 << 18) + 1, 64, None),
    (40000, 2 ** 16, None), (70000, 2 ** 16, None),
    (1 << 27, 1023, None), ((1 << 27) + 1, 1023, None),
    (100, (1 << 21) - 1, None), (100, 1 << 21, None), (0, 1 << 22, None),
    (512, (1 << 21) - 1, 512), (512, (1 << 21) - 1, 1024),
    (200, (1 << 21) - 1, 8), (1 << 24, 2047, None), (50331648, 2047, None),
    (1 << 25, 2047, None),
]


@pytest.mark.parametrize("n,V,tile_n", GUARD_CASES)
def test_guards_match_jax(n, V, tile_n):
    """kernel_fits, the tile width and the strict guard agree with the JAX
    package's at every guard edge (budgets are identical in this port)."""
    want = jax_kshuffle.kernel_fits(n, V, tile_n)
    assert kernel_fits(n, V, tile_n) == want
    assert kshuffle._tile_width(V, tile_n) == \
        jax_kshuffle._tile_width(V, tile_n)
    raised = False
    try:
        kshuffle._check_fits(n, V, tile_n)
    except ValueError:
        raised = True
    assert raised == (not want)


def test_strict_guard_messages():
    with pytest.raises(ValueError, match="key space"):
        kernel_shuffle(torch.zeros(8, dtype=torch.int32), torch.zeros(8),
                       1 << 22, 4)
    with pytest.raises(ValueError, match="counts budget"):
        kernel_shuffle(torch.zeros(200, dtype=torch.int32), torch.zeros(200),
                       (1 << 21) - 1, 4, tile_n=8)


@pytest.mark.parametrize("n,M,fits", [
    (1 << 24, 8192, True),       # the main path: V = 2048, capacity 24576
    (1 << 20, 8192, True),
    (1 << 24, 4096, False),      # V = 4096 halves the tile: both calls dense
    (1 << 25, 8192, False),
])
def test_sort_sizes_route_as_in_jax(n, M, fits):
    """Both shuffle calls of a levels=1 sort query (entry, local-sort)
    route to the kernels exactly when they do in the JAX package."""
    V = -(-n // M)
    cap = -(-3 * n // V)
    for items in (n, V * cap):
        assert kernel_fits(items, V) == fits == \
            jax_kshuffle.kernel_fits(items, V)
