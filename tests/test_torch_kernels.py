"""Port kernels vs the JAX package's Pallas kernels (interpret mode).

On the CPU the port's wrappers take each kernel's plain PyTorch version;
the same seeded numpy inputs go through the JAX kernel in interpret mode and
through the port, and must agree exactly (all-integer outputs; a sort
permutes its inputs).  ``test_torch_cuda.py`` holds the hand-written
kernels against the plain versions on the card.
"""
import numpy as np
import pytest
import torch

from repro.kernels.bincount import bincount as jax_bincount
from repro.kernels.bincount import bincount_tiles as jax_bincount_tiles
from repro.kernels.bitonic_sort import bitonic_sort as jax_bitonic_sort
from repro.kernels.prefix_scan import prefix_scan as jax_prefix_scan
from repro_torch.kernels import (bincount, bitonic_sort, chain,
                                 flash_attention, ops, prefix_scan, ref,
                                 ssm_scan)

RNG = np.random.default_rng(1234)


def _unique_keys(rows, n, dtype=np.int32):
    base = RNG.permutation(max(rows * n, 1) * 4)[:rows * n]
    return base.reshape(rows, n).astype(dtype)


@pytest.mark.parametrize("T,tile_n,n_buckets", [
    (1, 32, 8),          # single tile: prefix must be all-zero
    (5, 16, 8),          # multi-tile prefix
    (3, 7, 100),         # n_buckets > items per tile
    (4, 8, 1),           # single bucket
    (0, 16, 8),          # no tiles
    (2, 0, 8),           # empty tiles
    (6, 40, 13),         # (every case draws ids up to n_buckets + 1)
])
def test_bincount_tiles_matches_jax(T, tile_n, n_buckets):
    tiles = RNG.integers(-1, n_buckets + 2, (T, tile_n)).astype(np.int32)
    want = jax_bincount_tiles(tiles, n_buckets, interpret=True)
    got = ops.bincount_tiles(torch.from_numpy(tiles), n_buckets)
    oracle = ref.bincount_tiles_ref(torch.from_numpy(tiles), n_buckets)
    for w, g, o, name in zip(want, got, oracle, ("counts", "tile_prefix",
                                                 "bucket_offsets")):
        assert g.dtype == torch.int32 and g.shape == (T, n_buckets), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(o.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n,tile_n,n_buckets", [
    (9 * 64 - 5, 64, 2048),     # T = 9: one group of 8 tiles and one more
    (17 * 32, 32, 2048),        # T = 17, no padding
    (7 * 128 + 1, 128, 2048),   # T = 8, a tail of one item
    (3 * 64, 64, 4096),         # fewer buckets a group (V above 2048)
])
def test_bincount_tiles_kshuffle_padding_matches_jax(n, tile_n, n_buckets):
    """Tiles cut from a flat dest vector as kshuffle cuts them: source
    order, the tail padded with the "no item" sentinel -1."""
    dests = RNG.integers(-1, n_buckets, n).astype(np.int32)
    T = -(-n // tile_n)
    tiles = np.pad(dests, (0, T * tile_n - n),
                   constant_values=-1).reshape(T, tile_n)
    want = jax_bincount_tiles(tiles, n_buckets, interpret=True)
    got = ops.bincount_tiles(torch.from_numpy(tiles), n_buckets)
    for w, g, name in zip(want, got, ("counts", "tile_prefix",
                                      "bucket_offsets")):
        assert g.dtype == torch.int32 and g.shape == (T, n_buckets), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal((got[1][-1] + got[0][-1]).numpy(),
                                  np.bincount(dests[dests >= 0],
                                              minlength=n_buckets))


@pytest.mark.parametrize("n", [4095, 4096, 4097])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_int32_wraps_like_jax(n, exclusive):
    """Rows one below, at and one above the kernel's 4096-element tile, of
    int32 values whose sums wrap modulo 2^32."""
    x = RNG.integers(-(1 << 30), 1 << 30, (3, n)).astype(np.int32)
    want = jax_prefix_scan(x, exclusive=exclusive, interpret=True)
    got = ops.prefix_scan(torch.from_numpy(x), exclusive=exclusive)
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wide = np.cumsum(x.astype(np.int64), axis=1) - (x if exclusive else 0)
    assert (np.abs(wide) > 2**31).any()          # the sums do wrap
    np.testing.assert_array_equal(got.numpy(), wide.astype(np.int32))


def test_bincount_tiles_totals_match_jax_bincount():
    """tile_prefix[-1] + counts[-1] is the global histogram."""
    tiles = RNG.integers(-1, 13, (6, 32)).astype(np.int32)
    C, P, _ = ops.bincount_tiles(torch.from_numpy(tiles), 13)
    want = jax_bincount(tiles.reshape(-1), 13, block_t=64, interpret=True)
    np.testing.assert_array_equal((P[-1] + C[-1]).numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,n,dtype", [
    (1, 8, np.int32), (2, 64, np.int32), (3, 100, np.int32), (1, 7, np.int32),
    (4, 256, np.int32), (10, 12, np.int32),
    (1, 7, np.float32), (3, 100, np.float32),
])
def test_bitonic_sort_matches_jax(rows, n, dtype):
    if dtype == np.int32:
        k = _unique_keys(rows, n)       # unique: the permutation is defined
    else:
        k = RNG.normal(size=(rows, n)).astype(dtype)
    v = RNG.normal(size=(rows, n)).astype(np.float32)
    wk, wv = jax_bitonic_sort(k, v, interpret=True)
    gk, gv = ops.bitonic_sort(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    rk, rv = ref.bitonic_sort_ref(torch.from_numpy(k), torch.from_numpy(v))
    assert torch.equal(rk, gk) and torch.equal(rv, gv)


@pytest.mark.parametrize("rows,n", [
    (1, 0),              # empty row
    (2, 1),              # single element
    (1, 5),              # non-power-of-two (padding path)
    (3, 33),             # just past a power of two
])
def test_bitonic_sort_awkward_matches_jax(rows, n):
    k = _unique_keys(rows, n)
    v = RNG.integers(0, 1 << 20, (rows, n)).astype(np.int32)
    wk, wv = jax_bitonic_sort(k, v, interpret=True)
    gk, gv = ops.bitonic_sort(torch.from_numpy(k), torch.from_numpy(v))
    assert gk.shape == (rows, n) and gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_bitonic_sort_width_guard_matches_jax():
    """Both packages refuse one row past 2^18 padded, with one message."""
    n = (1 << 18) + 1
    k = np.zeros((1, n), np.int32)
    with pytest.raises(ValueError, match="single-VMEM-tile"):
        jax_bitonic_sort(k, k, interpret=True)
    with pytest.raises(ValueError, match="single-VMEM-tile"):
        ops.bitonic_sort(torch.from_numpy(k), torch.from_numpy(k))
    with pytest.raises(ValueError, match="matching"):
        ops.bitonic_sort(torch.zeros(2, 3), torch.zeros(2, 4))


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no kernel launch is counted,
    and nothing is built."""
    ops.reset_launches()
    ops.bincount_tiles(torch.zeros((2, 4), dtype=torch.int32), 3)
    ops.bitonic_sort(torch.zeros((2, 4), dtype=torch.int32),
                     torch.zeros((2, 4), dtype=torch.int32))
    ops.flash_attention(torch.zeros((1, 2, 4, 8)), torch.zeros((1, 1, 4, 8)),
                        torch.zeros((1, 1, 4, 8)))
    ops.ssm_scan(torch.ones((1, 3, 2)), torch.zeros((1, 3, 2)))
    ops.ssm_scan(torch.ones((1, 3, 2)),
                 torch.zeros((1, 3, 2), requires_grad=True)).sum().backward()
    ops.prefix_scan(torch.zeros((2, 4), dtype=torch.int32))
    ops.bincount(torch.zeros((4,), dtype=torch.int32), 3)
    ops.monotone_chain(torch.zeros((2, 4, 2)),
                       torch.tensor([4, 0], dtype=torch.int32))
    assert ops.launches() == {"bincount_tiles": 0, "bitonic_sort": 0,
                              "flash_attention": 0, "ssm_scan": 0,
                              "ssm_scan.bwd": 0, "prefix_scan": 0, "bincount": 0,
                              "monotone_chain": 0,
                              "bincount_tiles.single_pass": 0,
                              "bincount_tiles.global": 0,
                              "flash_attention.wgmma": 0,
                              "flash_attention.cuda_core": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bincount.bincount_tiles_cuda(torch.zeros((2, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_sort.bitonic_sort_cuda(torch.zeros((2, 4)), torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(*[torch.zeros((1, 2, 4, 64))] * 3)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan.ssm_scan_cuda(torch.ones((1, 3, 2)), torch.zeros((1, 3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan.ssm_scan_bwd_cuda(*[torch.zeros((1, 3, 2))] * 3)
    with pytest.raises(ValueError, match="CUDA"):
        prefix_scan.prefix_scan_cuda(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        bincount.bincount_cuda(torch.zeros((4,), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        chain.monotone_chain_cuda(torch.zeros((2, 4, 2)),
                                  torch.zeros((2,), dtype=torch.int32))
