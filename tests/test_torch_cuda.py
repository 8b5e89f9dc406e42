"""The hand-written CUDA kernels against their plain PyTorch versions.

Launches each kernel on the card at small shapes, the shuffle's tile width
and the shapes that take each kernel's second path (a histogram in global
memory, a row wider than shared memory), and requires exact agreement;
``bitonic_sort`` also at every width where its mechanism changes, and on
tie-heavy rows (sorted keys, the same (key, value) pairs);
``flash_attention`` at the edge shapes, lengths off the wgmma tiles, every
head dim and the two prefill shapes, within 2e-4 (float32) and 2e-2
(bfloat16), and its launches counted by route; ``ssm_scan`` at the edge
shapes and the zamba2 and RWKV6 prefill shapes within 2e-4; ``prefix_scan``
exactly in int32 and, in float32, within twice ``torch.cumsum``'s own error
against a float64 cumsum; ``bincount`` exactly.  The two look-back kernels
also at their edges: ``prefix_scan`` one below, at and above its tile,
unaligned row tails and bases, a row of 4096 tiles, float32 of mixed
magnitudes; ``bincount_tiles`` at T = 1, G and G + 1 where the group size G
changes with V, across its route boundary, on ids all outside [0, V), and
on the single-pass route at the shuffle's shape.
Marked ``cuda``: they skip without a card.  They import no JAX, so they run
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bincount, bitonic_sort, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import prefix_scan, ssm_scan

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
    (4096, 4096, np.int32),      # a main-path query's entry sort
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
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                               4095, 4096, 4097, 16384, 16385, 1 << 18])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_bitonic_sort_kernel_at_mechanism_widths(cuda, n, dtype):
    # widths where the kernel changes mechanism: rows sharing a block,
    # register chunks, lane and warp bits, a row per block, global stages
    rows = 1 if n == 1 << 18 else 3
    k = torch.from_numpy(_unique_keys(rows, n).astype(dtype)).to(cuda)
    v = torch.from_numpy(
        RNG.integers(0, 1 << 30, (rows, n)).astype(np.int32)).to(cuda)
    gk, gv = bitonic_sort.bitonic_sort_cuda(k, v)
    torch.cuda.synchronize()
    wk, wv = bitonic_sort.bitonic_sort_plain(k, v)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def _pairs(k, v):
    bits = k.view(torch.int32).long() & 0xFFFFFFFF
    return torch.sort((bits << 32) | (v.long() & 0xFFFFFFFF), 1).values


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(64, 4096), (5, 33), (3, 4097),
                                    (2, 16385), (1, 1 << 18)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_bitonic_sort_kernel_on_ties(cuda, rows, n, dtype):
    # 8 key values (both float zeros among them): the network is not
    # stable, so the keys come out sorted and the (key, value) pairs are
    # those that went in
    pick = torch.from_numpy(RNG.integers(0, 8, (rows, n))).to(cuda)
    if dtype == torch.float32:
        k = torch.tensor([0.0, -0.0, 1.5, -2.0, 3.0, -0.0, 0.0, 7.0],
                         device=cuda)[pick]
    else:
        k = (pick - 4).to(torch.int32)
    v = torch.from_numpy(
        RNG.integers(0, 1 << 30, (rows, n)).astype(np.int32)).to(cuda)
    gk, gv = bitonic_sort.bitonic_sort_cuda(k, v)
    torch.cuda.synchronize()
    assert bool((gk[:, 1:] >= gk[:, :-1]).all())
    assert torch.equal(_pairs(gk, gv), _pairs(k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 4, 2, 128, 128, 64, True),
    (1, 2, 2, 200, 200, 32, False),    # ragged tiles, key masking
    (1, 8, 2, 256, 256, 64, True),
    (1, 2, 1, 100, 100, 48, True),     # MQA, head dim not 2^k
    (2, 4, 4, 64, 64, 128, False),
    (2, 4, 4, 1, 512, 64, False),      # one query against a 512-key cache
    (8, 32, 4, 2048, 2048, 64, True),  # TinyLlama-1.1B prefill, B 8, S 2048
    (8, 32, 32, 2048, 2048, 64, True),  # zamba2-1.2b's shared block
    (2, 16, 4, 2048, 2048, 128, True),  # d 128 causal at S 2048
    (1, 4, 2, 300, 300, 128, True),    # lengths off the wgmma tiles
    (2, 4, 4, 200, 200, 64, False),
    (1, 2, 2, 77, 333, 128, False),
    (1, 4, 1, 129, 129, 32, True),
    (1, 4, 4, 65, 65, 48, False),
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
@pytest.mark.parametrize("d,dtype,route", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (32, torch.bfloat16, "cuda_core"), (48, torch.bfloat16, "cuda_core"),
    (64, torch.float32, "cuda_core"), (128, torch.float32, "cuda_core"),
])
def test_flash_attention_counts_each_route(cuda, d, dtype, route):
    q = torch.randn(1, 2, 70, d, device=cuda).to(dtype)
    before = dict(flash.route_launches)
    ops.flash_attention(q, q, q)
    after = dict(flash.route_launches)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    ops.reset_launches()
    assert flash.route_launches == {"wgmma": 0, "cuda_core": 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,a_dtype,x_dtype", [
    (2, 100, 16, torch.float32, torch.float32),
    (1, 513, 8, torch.float32, torch.float32),
    (3, 64, 32, torch.bfloat16, torch.float32),
    (1, 16, 4, torch.float32, torch.bfloat16),
    (2, 33, 300, torch.bfloat16, torch.bfloat16),
    (8, 16, 262144, torch.float32, torch.float32),   # zamba2-1.2b prefill
    (8, 32, 131072, torch.float32, torch.float32),   # rwkv6-1.6b prefill
])
def test_ssm_scan_kernel_matches_plain(cuda, b, t, d, a_dtype, x_dtype):
    gen = torch.Generator(device=cuda).manual_seed(t * d)
    a = (0.8 + 0.2 * torch.rand(b, t, d, device=cuda, generator=gen)) \
        .to(a_dtype)
    x = torch.randn(b, t, d, device=cuda, generator=gen).to(x_dtype)
    before = ssm_scan.launches
    got = ops.ssm_scan(a, x)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want = ssm_scan.ssm_scan_plain(a, x)
    tol = 2e-4 if x_dtype == torch.float32 else 2e-2
    assert got.dtype == x_dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssm_scan_kernel_refuses_a_gradient(cuda):
    a = torch.rand(1, 4, 8, device=cuda, requires_grad=True)
    x = torch.randn(1, 4, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.ssm_scan(a, x)
    with torch.no_grad():
        assert ops.ssm_scan(a, x).shape == (1, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [
    (2, 1), (3, 13), (2, 700), (1, 1024), (4, 1025), (16, 128),
    (2048, 12288),               # the local-sort count scan: V x T tiles
    (3, 1 << 20),
])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_kernel_matches_plain(cuda, rows, n, exclusive):
    gen = torch.Generator(device=cuda).manual_seed(rows + n)
    xi = torch.randint(-(1 << 30), 1 << 30, (rows, n), dtype=torch.int32,
                       device=cuda, generator=gen)       # sums wrap
    got = ops.prefix_scan(xi, exclusive=exclusive)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, prefix_scan.prefix_scan_plain(xi, exclusive))
    xf = torch.randn(rows, n, device=cuda, generator=gen)
    got = ops.prefix_scan(xf, exclusive=exclusive)
    exact = torch.cumsum(xf.double(), -1) - (xf.double() if exclusive else 0)
    err = (got.double() - exact).abs().max().item()
    own = (prefix_scan.prefix_scan_plain(xf, exclusive).double()
           - exact).abs().max().item()
    assert err <= 2 * own + 1e-6, (err, own)


@pytest.mark.cuda
def test_prefix_scan_kernel_passes_an_empty_axis(cuda):
    x = torch.zeros((3, 0), dtype=torch.int32, device=cuda)
    assert ops.prefix_scan(x) is x


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_buckets", [
    (0, 8), (13, 64), (31, 5), (6, 100), (100, 8), (5000, 50),
    (1 << 24, 2048),             # the sort's destinations
    (1 << 20, 100000),           # above the shared-memory histogram
])
def test_bincount_kernel_matches_plain(cuda, n, n_buckets):
    gen = torch.Generator(device=cuda).manual_seed(n + n_buckets)
    ids = torch.randint(-3, n_buckets + 3, (n,), dtype=torch.int32,
                        device=cuda, generator=gen)
    got = ops.bincount(ids, n_buckets)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n_buckets,)
    assert torch.equal(got, bincount.bincount_plain(ids, n_buckets))


@pytest.mark.cuda
def test_bincount_kernel_all_dropped(cuda):
    ids = torch.tensor([-1] * 40 + [7] * 40, dtype=torch.int32, device=cuda)
    assert not ops.bincount(ids, 7).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_buckets", [2048, 2049, 4096, 4097, 6144, 8192,
                                       8193, 12288, 16385, 48 * 1024,
                                       48 * 1024 + 1])
@pytest.mark.parametrize("which", ["1", "G", "G+1"])
def test_bincount_tiles_kernel_at_group_edges(cuda, n_buckets, which):
    # the group size G falls with V (8 at 2048, 1 from 8193); at 6144 and
    # 12288 the histograms fill exactly 48 KB; above 48 Ki buckets the
    # kernel takes its global route (G 0)
    G = bincount.group_tiles(1, 1024, n_buckets)
    assert G == {2048: 8, 2049: 7, 4096: 4, 4097: 3, 6144: 2, 8192: 2}.get(
        n_buckets, 0 if n_buckets > 48 * 1024 else 1)
    T = {"1": 1, "G": max(G, 1), "G+1": max(G, 1) + 1}[which]
    tiles = torch.from_numpy(
        RNG.integers(-2, n_buckets + 2, (T, 1024)).astype(np.int32)).to(cuda)
    before = dict(bincount.route_launches)
    got = ops.bincount_tiles(tiles, n_buckets)
    torch.cuda.synchronize()
    route = "single_pass" if G else "global"
    assert bincount.route_launches[route] == before[route] + 1
    for g, w in zip(got, bincount.bincount_tiles_plain(tiles, n_buckets)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("T,tile_n", [(12288, 4096), (9, 4095), (17, 6),
                                      (1, 1)])
def test_bincount_tiles_kernel_on_ignored_and_uniform_ids(cuda, T, tile_n):
    # every id outside [0, V); then whole tiles of one bucket (a warp adds
    # them once), then the two mixed
    V = 2048
    outside = torch.from_numpy(RNG.choice(
        np.array([-5, -1, V, V + 7], np.int32), (T, tile_n))).to(cuda)
    uniform = torch.from_numpy(np.repeat(
        RNG.integers(0, V, (T, 1)).astype(np.int32), tile_n, 1)).to(cuda)
    mixed = torch.where(torch.from_numpy(RNG.random((T, tile_n)) < 0.5)
                        .to(cuda), outside, uniform)
    for tiles in (outside, uniform, mixed):
        got = ops.bincount_tiles(tiles, V)
        torch.cuda.synchronize()
        for g, w in zip(got, bincount.bincount_tiles_plain(tiles, V)):
            assert torch.equal(g, w)
    assert not ops.bincount_tiles(outside, V)[0].any()


@pytest.mark.cuda
def test_bincount_tiles_takes_the_single_pass_route_in_the_shuffle(cuda):
    # the entry shuffle of a sort query at its main-path geometry: 2^24
    # items into V = 2048 reducers, tiles of 4096 padded by -1
    from repro_torch.core.kshuffle import kernel_shuffle
    n, V = 1 << 24, 2048
    dests = torch.randint(-1, V, (n,), dtype=torch.int32, device=cuda)
    ops.reset_launches()
    kernel_shuffle(dests, (dests,), V, 3 * n // V)
    torch.cuda.synchronize()
    got = ops.launches()
    assert got["bincount_tiles"] == 1
    assert got["bincount_tiles.single_pass"] == 1
    assert got["bincount_tiles.global"] == 0
    ops.reset_launches()
    assert bincount.route_launches == {"single_pass": 0, "global": 0}


def _scan_checks(x, exclusive):
    got = ops.prefix_scan(x, exclusive=exclusive)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.dtype == torch.int32:
        assert torch.equal(got, prefix_scan.prefix_scan_plain(x, exclusive))
        return
    exact = torch.cumsum(x.double(), -1) - (x.double() if exclusive else 0)
    err = (got.double() - exact).abs().max().item()
    own = (prefix_scan.prefix_scan_plain(x, exclusive).double()
           - exact).abs().max().item()
    assert err <= 2 * own + 2.0 ** -22 * exact.abs().max().item(), (err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [
    (3, 4095), (3, 4096), (3, 4097),              # one tile, and one more
    (2, 8193), (2, 8194), (2, 8195),              # unaligned row tails
    (5, 3 * 4096 + 4),
    (1, 1 << 24),                # 4096 tiles: look-back past one warp's 32
])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_kernel_at_look_back_edges(cuda, rows, n, dtype,
                                               exclusive):
    gen = torch.Generator(device=cuda).manual_seed(rows * n)
    if dtype == torch.int32:
        x = torch.randint(-(1 << 30), 1 << 30, (rows, n), dtype=dtype,
                          device=cuda, generator=gen)
    else:
        x = torch.randn(rows, n, device=cuda, generator=gen)
    _scan_checks(x, exclusive)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_prefix_scan_kernel_on_an_unaligned_base(cuda, dtype):
    # rows of a multiple of 4 whose base is 4 bytes past 16-byte alignment:
    # the scalar loads and stores
    flat = torch.arange(1 + 4 * 8192, device=cuda).to(dtype)
    x = flat[1:].view(4, 8192)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    _scan_checks(x, False)
    _scan_checks(x, True)


@pytest.mark.cuda
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_kernel_on_mixed_magnitudes(cuda, exclusive):
    # float32 of magnitudes 1e-6 .. 1e6 and both signs, 64 tiles a row
    gen = torch.Generator(device=cuda).manual_seed(7)
    mag = 10.0 ** (12 * torch.rand(4, 1 << 18, device=cuda, generator=gen)
                   - 6)
    sign = torch.randint(0, 2, mag.shape, device=cuda, generator=gen) * 2 - 1
    _scan_checks((mag * sign).float(), exclusive)
