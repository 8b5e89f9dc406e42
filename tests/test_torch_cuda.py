"""The hand-written CUDA kernels against their plain PyTorch versions.

Launches each kernel on the card at small shapes, the shuffle's tile width
and the shapes that take each kernel's second path (a histogram in global
memory, a row wider than shared memory), and requires exact agreement.
Marked ``cuda``: they skip without a card.  They import no JAX, so they run
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bincount, bitonic_sort

RNG = np.random.default_rng(4321)


def _unique_keys(rows, n):
    base = RNG.permutation(max(rows * n, 1) * 4)[:rows * n]
    return base.reshape(rows, n).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,tile_n,n_buckets", [
    (1, 32, 8), (5, 16, 8), (3, 7, 100), (4, 8, 1), (0, 16, 8), (2, 0, 8),
    (64, 4096, 2048),            # the shuffle's tile width
    (4, 8, 1 << 20),             # histogram in global memory
])
def test_bincount_tiles_kernel_matches_plain(cuda, T, tile_n, n_buckets):
    tiles = torch.from_numpy(
        RNG.integers(-1, n_buckets + 2, (T, tile_n)).astype(np.int32)).to(cuda)
    got = bincount.bincount_tiles_cuda(tiles, n_buckets)
    torch.cuda.synchronize()
    want = bincount.bincount_tiles_plain(tiles, n_buckets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,dtype", [
    (1, 8, np.int32), (3, 100, np.int32), (2, 1, np.int32), (7, 33, np.int32),
    (64, 4096, np.int32), (16, 1000, np.float32),
    (1, 1 << 18, np.int32),      # global stages above the shared-memory row
    (2, 40000, np.float32),
])
def test_bitonic_sort_kernel_matches_plain(cuda, rows, n, dtype):
    if dtype == np.int32:
        k = torch.from_numpy(_unique_keys(rows, n)).to(cuda)
    else:
        # distinct float keys: the network is not stable
        k = torch.from_numpy(_unique_keys(rows, n).astype(dtype) * 0.5).to(cuda)
    v = torch.from_numpy(
        RNG.integers(0, 1 << 30, (rows, n)).astype(np.int32)).to(cuda)
    gk, gv = bitonic_sort.bitonic_sort_cuda(k, v)
    torch.cuda.synchronize()
    wk, wv = bitonic_sort.bitonic_sort_plain(k, v)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
