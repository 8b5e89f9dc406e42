"""The hand-written CUDA kernels against their plain PyTorch versions.

Launches each kernel on the card at small shapes, the shuffle's tile width
and the shapes that take each kernel's second path (a histogram in global
memory, a row wider than shared memory), and requires exact agreement;
``flash_attention`` at the edge shapes and TinyLlama's prefill shape, within
2e-4 (float32) and 2e-2 (bfloat16).
Marked ``cuda``: they skip without a card.  They import no JAX, so they run
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bincount, bitonic_sort, ops
from repro_torch.kernels import flash_attention as flash

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


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 4, 2, 128, 128, 64, True),
    (1, 2, 2, 200, 200, 32, False),    # ragged tiles, key masking
    (1, 8, 2, 256, 256, 64, True),
    (1, 2, 1, 100, 100, 48, True),     # MQA, head dim not 2^k
    (2, 4, 4, 64, 64, 128, False),
    (2, 4, 4, 1, 512, 64, False),      # one query against a 512-key cache
    (8, 32, 4, 2048, 2048, 64, True),  # TinyLlama-1.1B prefill, B 8, S 2048
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, d,
                                              causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq * d + hq)
    q = torch.randn(b, hq, sq, d, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(b, hkv, sk, d, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    before = flash.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    k = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(k.half(), k.half(), k.half())
    k16 = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim 16"):
        ops.flash_attention(k16, k16, k16)
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(k, k.bfloat16(), k)
