"""The hand-written CUDA kernels against their plain PyTorch versions.

Launches each kernel on the card at small shapes, the shuffle's tile width
and the shapes that take each kernel's second path (a histogram in global
memory, a row wider than shared memory), and requires exact agreement;
``bitonic_sort`` also at every width where its mechanism changes, and on
tie-heavy rows (sorted keys, the same (key, value) pairs);
``flash_attention`` at the edge shapes, lengths off the wgmma tiles, every
head dim and the two prefill shapes, within 2e-4 (float32) and 2e-2
(bfloat16), and its launches counted by route, and refusing a gradient;
``ssm_scan`` at the edge shapes and the zamba2 and RWKV6 prefill shapes
within 2e-4, and its backward kernel against autograd through the plain
version at T = 1, T and D off the kernel's unroll and block, bfloat16
inputs and the two training shapes; ``prefix_scan``
exactly in int32 and, in float32, within twice ``torch.cumsum``'s own error
against a float64 cumsum; ``bincount`` exactly.  The two look-back kernels
also at their edges: ``prefix_scan`` one below, at and above its tile,
unaligned row tails and bases, a row of 4096 tiles, float32 of mixed
magnitudes; ``bincount_tiles`` at T = 1, G and G + 1 where the group size G
changes with V, across its route boundary, on ids all outside [0, V), and
on the single-pass route at the shuffle's shape; ``bincount`` also on
views at offsets 1-3, every n from 1 to 17, one bucket, every id ignored,
both sides of its route boundary and two streams at once.
``monotone_chain`` equals its plain version bit for bit on the 2-D hull's
degenerate runs, integer-grid runs, Gaussian runs, a run whose every point
is extreme (and 2^18 such points against the run itself), runs one below,
at and above each stage, ring and window size the launch takes, chains
that pop below the shared-memory window, near-collinear float32 runs, x
ties, subnormal coordinates, clamped counts and a merge-shaped batch of
2048 runs; the three geometry plans on the kernel engine equal the dense
engine.  The fault proxy keeps the card and the kernels, and a traced, a
recovered and a served query on the card equal the plain ones.  The MoE
layer's bf16 einsum dispatch on the card agrees with a float32 loop over
its experts that takes the same routes.
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
    (1, 4, 2, 100, 100, 16, True),     # head dim padded to 32
    (2, 8, 2, 300, 300, 112, True),    # kimi-k2's head dim, padded to 128
    (1, 2, 2, 70, 90, 8, False),       # head dim padded to 32
    (8, 8, 8, 1500, 1500, 64, False),  # whisper-base's encoder
    (8, 8, 8, 32, 1500, 64, False),    # its cross-attention at prefill
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
    k160 = torch.zeros(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim 160"):
        ops.flash_attention(k160, k160, k160)
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
@pytest.mark.parametrize("b,t,d,a_dtype,x_dtype", [
    (2, 1, 16, torch.float32, torch.float32),        # T = 1
    (1, 13, 8, torch.float32, torch.float32),        # T off the unroll of 8
    (2, 100, 300, torch.float32, torch.float32),     # D off the block of 256
    (3, 64, 32, torch.bfloat16, torch.float32),
    (1, 16, 4, torch.float32, torch.bfloat16),
    (2, 33, 300, torch.bfloat16, torch.bfloat16),
    (8, 16, 262144, torch.float32, torch.float32),   # zamba2-1.2b training
    (8, 32, 131072, torch.float32, torch.float32),   # rwkv6-1.6b training
])
def test_ssm_scan_backward_kernel_matches_plain_autograd(cuda, b, t, d,
                                                         a_dtype, x_dtype):
    """Under a gradient ``ops.ssm_scan`` launches the forward and the
    backward kernel once each; da and dx for a seeded dh equal autograd
    through the plain version within 2e-4 (float32) or 2e-2 (bfloat16),
    in a's and x's dtypes."""
    gen = torch.Generator(device=cuda).manual_seed(t * d + 1)
    a = (0.8 + 0.2 * torch.rand(b, t, d, device=cuda, generator=gen)) \
        .to(a_dtype)
    x = torch.randn(b, t, d, device=cuda, generator=gen).to(x_dtype)
    dh = torch.randn(b, t, d, device=cuda, generator=gen).to(x_dtype)
    ops.reset_launches()
    ka, kx = a.clone().requires_grad_(), x.clone().requires_grad_()
    ops.ssm_scan(ka, kx).backward(dh)
    torch.cuda.synchronize()
    got = ops.launches()
    assert (got["ssm_scan"], got["ssm_scan.bwd"]) == (1, 1)
    pa, px = a.clone().requires_grad_(), x.clone().requires_grad_()
    ssm_scan.ssm_scan_plain(pa, px).backward(dh)
    assert ops.launches()["ssm_scan.bwd"] == 1
    tol = 2e-4 if a_dtype == x_dtype == torch.float32 else 2e-2
    if pa.grad is None:         # T = 1: h does not depend on a
        pa.grad = torch.zeros_like(pa)
    for got_g, want_g, dtype in ((ka.grad, pa.grad, a_dtype),
                                 (kx.grad, px.grad, x_dtype)):
        assert got_g.dtype == dtype and got_g.shape == want_g.shape
        torch.testing.assert_close(got_g.float(), want_g.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_ssm_scan_backward_wrapper_checks_its_inputs(cuda):
    a = torch.rand(1, 4, 8, device=cuda)
    h = torch.randn(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="does not match"):
        ssm_scan.ssm_scan_bwd_cuda(a, h, h.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssm_scan.ssm_scan_bwd_cuda(a.double(), h.double(), h.double())
    da, dx = ssm_scan.ssm_scan_bwd_cuda(a[:, :0], h[:, :0], h[:, :0])
    assert da.shape == dx.shape == (1, 0, 8)


@pytest.mark.cuda
def test_flash_attention_refuses_a_gradient(cuda):
    """Neither package has a backward for the flash kernel: under a
    gradient the CUDA route raises and names ``attn_impl="xla"``."""
    q = torch.randn(1, 2, 64, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == (1, 2, 64, 64)
    assert ops.flash_attention(q.detach(), k, k).shape == (1, 2, 64, 64)


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


def _bincount_held(ids, n_buckets):
    got = ops.bincount(ids, n_buckets)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n_buckets,)
    assert torch.equal(got, bincount.bincount_plain(ids, n_buckets))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [3, 6, (1 << 20) + 5])
def test_bincount_kernel_on_offset_views(cuda, offset, n):
    """ids a view 4, 8 or 12 bytes past a 16-byte boundary: the scalar
    head and tail around the 16-byte loads."""
    gen = torch.Generator(device=cuda).manual_seed(offset * n)
    base = torch.randint(-3, 2051, (n + 4,), dtype=torch.int32, device=cuda,
                         generator=gen)
    ids = base[offset:offset + n]
    assert ids.is_contiguous() and ids.data_ptr() % 16 == 4 * offset
    _bincount_held(ids, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, 18))
def test_bincount_kernel_at_small_n(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    ids = torch.randint(-2, 10, (n,), dtype=torch.int32, device=cuda,
                        generator=gen)
    _bincount_held(ids, 8)


@pytest.mark.cuda
def test_bincount_kernel_on_one_bucket(cuda):
    n = (1 << 22) + 3
    ids = torch.full((n,), 1234, dtype=torch.int32, device=cuda)
    got = _bincount_held(ids, 2048)
    assert int(got[1234]) == n and int(got.sum()) == n


@pytest.mark.cuda
def test_bincount_kernel_ignores_every_id_outside(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    outside = torch.tensor([-(1 << 31), -5, -1, 2048, 2049, (1 << 31) - 1],
                           dtype=torch.int32, device=cuda)
    ids = outside[torch.randint(0, 6, ((1 << 20) + 1,), device=cuda,
                                generator=gen)]
    assert not _bincount_held(ids, 2048).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_buckets", [48 * 1024, 48 * 1024 + 1])
def test_bincount_kernel_at_its_route_boundary(cuda, n_buckets):
    gen = torch.Generator(device=cuda).manual_seed(n_buckets)
    ids = torch.randint(-3, n_buckets + 3, ((1 << 20) + 7,),
                        dtype=torch.int32, device=cuda, generator=gen)
    _bincount_held(ids, n_buckets)


@pytest.mark.cuda
def test_bincount_kernel_on_two_streams_at_once(cuda):
    """Two calls in flight on two streams: each equals torch.bincount."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    ids = [torch.randint(0, V, (n,), dtype=torch.int32, device=cuda,
                         generator=gen)
           for n, V in (((1 << 22) + 1, 2048), (1 << 22, 3000))]
    now = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, x, V in zip(streams, ids, (2048, 3000)):
        s.wait_stream(now)
        with torch.cuda.stream(s):
            got.append(ops.bincount(x, V))
    torch.cuda.synchronize()
    for g, x, V in zip(got, ids, (2048, 3000)):
        assert torch.equal(g, torch.bincount(x, minlength=V).to(torch.int32))


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


def _plan_families():
    """(name, plan, inputs, key) at small sizes: one query of each
    searching and simulation plan family."""
    from repro_torch.core import (BSPProgram, bsp_plan, funnel_write_plan,
                                  multisearch_plan, prefix_plan)
    rng = np.random.default_rng(77)
    q = rng.normal(size=3000).astype(np.float32)
    piv = rng.normal(size=200).astype(np.float32)
    x = rng.integers(-100, 100, 5000).astype(np.int32)
    addrs = rng.integers(-1, 9, 4000).astype(np.int32)
    vals = rng.integers(-50, 50, 4000).astype(np.int32)

    def step(t, ids, s, box, ok):
        dests = (s * 64).to(torch.int32).clamp_max(63) if t == 0 else \
            torch.full_like(s, -1, dtype=torch.int32)
        return s, dests, s

    keys = rng.random((64, 32)).astype(np.float32)
    return [
        ("multisearch", multisearch_plan(3000, 200, 16), (q, piv),
         rng.permutation(3000)),
        ("prefix", prefix_plan(5000, 64, physical=True), (x,), None),
        ("funnel", funnel_write_plan(4000, 9, 64, torch.add, identity=0,
                                     dtype="int32"),
         (addrs, vals, np.zeros(9, np.int32)), None),
        ("bsp", bsp_plan(BSPProgram(step), 2, 96, 64, torch.tensor(0.0)),
         (keys,), None),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["multisearch", "prefix", "funnel", "bsp"])
def test_plan_families_on_the_card_match_the_cpu(cuda, family):
    """Each searching and simulation plan on the card's kernel engine: every
    shuffle on the kernels, every ``bincount_tiles`` launch single-pass,
    outputs and CostAccum equal to the CPU kernel engine's on the same
    draw (explicit slots for the multisearch batches)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import get_engine
    _, plan, inputs, key = next(f for f in _plan_families()
                                if f[0] == family)
    eng = get_engine("kernel", device=cuda)
    ops.reset_launches()
    got = eng.compile(plan)(*inputs, key=key)
    torch.cuda.synchronize()
    shuffles = eng.route_log.kernel
    assert eng.route_log.dense == 0 and shuffles > 0
    launches = ops.launches()
    assert launches["bincount_tiles"] == launches["bitonic_sort"] == shuffles
    assert launches["bincount_tiles.single_pass"] == shuffles
    want = get_engine("kernel", device="cpu").compile(plan)(*inputs, key=key)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _chain_batches():
    """name -> (V, L, 2) lex-sorted, deduplicated, compacted runs and their
    counts, made on the CPU: the 2-D hull's degenerate cases, integer-grid
    runs (every orientation test exact), Gaussian runs, and runs of 0, 1
    and 2 points."""
    from repro_torch.core.geometry.chain import _compact, sort_dedup_runs
    rng = np.random.default_rng(99)
    degenerate = [[[0, 0], [1, 1], [2, 2], [3, 3]],
                  [[0, 0], [1, 1], [2, 2], [3, 3], [0, 0], [3, 3]],
                  [[2, 2]] * 5, [[1, 2], [1, 2]], [[3, 4]],
                  [[1, 1], [0, 0]], [[0, 0], [3, 0], [3, 3], [0, 3], [1, 1],
                                     [2, 2]], []]
    batches = {
        "degenerate": [np.asarray(r, np.float32).reshape(-1, 2)
                       for r in degenerate],
        "grid": [rng.integers(-1024, 1024, (k, 2)).astype(np.float32)
                 for k in (3, 100, 2000, 5000)]
        + [rng.integers(-4, 4, (k, 2)).astype(np.float32)
           for k in (50, 700)],
        "gauss": [rng.normal(size=(k, 2)).astype(np.float32)
                  for k in (1, 2, 17, 1500, 4096, 9000)],
    }
    out = {}
    for name, runs in batches.items():
        cap = max(len(r) for r in runs) + 3
        pts = np.zeros((len(runs), cap, 2), np.float32)
        valid = np.zeros((len(runs), cap), bool)
        for v, r in enumerate(runs):
            pts[v, :len(r)] = r
            valid[v, :len(r)] = True
        out[name] = _compact(*sort_dedup_runs(torch.from_numpy(pts),
                                              torch.from_numpy(valid)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["degenerate", "grid", "gauss", "parabola"])
def test_monotone_chain_kernel_matches_plain(cuda, name):
    """Bit for bit, hulls and counts: the kernel's orientation test rounds
    each operation on its own, as the plain version's does."""
    from repro_torch.kernels import chain
    if name == "parabola":
        # integer points on y = x^2: every point is extreme, so the lower
        # chain is the whole run and the upper chain pops at every step
        x = np.arange(-2048, 2048, dtype=np.float32)
        pts = torch.from_numpy(np.stack([x, x * x], 1))[None]
        counts = torch.tensor([4096], dtype=torch.int32)
    else:
        pts, counts = _chain_batches()[name]
    ops.reset_launches()
    got_h, got_c = chain.monotone_chain_cuda(pts.to(cuda), counts.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches()["monotone_chain"] == 1
    want_h, want_c = chain.monotone_chain_plain(pts, counts)
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(got_h.cpu(), want_h)
    if name == "parabola":
        assert want_c.tolist() == [4096]


@pytest.mark.cuda
def test_monotone_chain_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import chain
    pts = torch.zeros((2, 4, 2), device=cuda)
    with pytest.raises(ValueError, match="int32 counts"):
        chain.monotone_chain_cuda(pts, torch.zeros(2, device=cuda))
    with pytest.raises(ValueError, match="float32 points"):
        chain.monotone_chain_cuda(pts.double(),
                                  torch.zeros(2, dtype=torch.int32,
                                              device=cuda))
    ops.reset_launches()
    hull, h = chain.monotone_chain_cuda(torch.zeros((3, 0, 2), device=cuda),
                                        torch.zeros(3, dtype=torch.int32,
                                                    device=cuda))
    assert hull.shape == (3, 0, 2) and h.tolist() == [0, 0, 0]
    assert ops.launches()["monotone_chain"] == 0


def _chain_held(cuda, pts, counts):
    """One launch of the kernel on (V, L, 2) numpy runs and (V,) counts,
    equal bit for bit to the plain version on host copies; returns the
    plain version's (hulls, counts)."""
    from repro_torch.kernels import chain
    pts, counts = torch.from_numpy(pts), torch.from_numpy(counts)
    ops.reset_launches()
    got_h, got_c = chain.monotone_chain_cuda(pts.to(cuda), counts.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches()["monotone_chain"] == 1
    want_h, want_c = chain.monotone_chain_plain(pts, counts)
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(got_h.cpu(), want_h)
    return want_h, want_c


@pytest.mark.cuda
@pytest.mark.parametrize("V", [9, 300, 500, 2048])
def test_monotone_chain_kernel_across_its_stage_and_window_sizes(cuda, V):
    """Runs one shorter than, as long as and one longer than a stage, a
    full ring of stages and the window the launch takes: Gaussian runs, and
    runs whose every point stays on the lower or the upper chain's stack.
    At V 300 and 500 (three and four blocks an SM on 132 SMs) a block asks
    exactly 48 KB of dynamic shared memory."""
    from repro_torch import testing
    from repro_torch.kernels import chain
    shape = chain.kernel_shape(V, 1 << 14)
    sizes = (shape["stage"], shape["stage"] * shape["depth"],
             shape["window"])
    lengths = sorted({x + d for x in sizes for d in (-1, 0, 1)})
    assert chain.kernel_shape(V, lengths[-1]) == shape
    rng = np.random.default_rng(V)
    makers = (lambda k: testing.gauss_run(k, rng),
              lambda k: testing.parabola_run(k, 1.0),
              lambda k: testing.parabola_run(k, -1.0))
    runs = [makers[v % 3](lengths[v % len(lengths)]) for v in range(V)]
    _chain_held(cuda, *testing.pack_runs(runs))


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 2048])
@pytest.mark.parametrize("side", ["lower", "upper"])
def test_monotone_chain_kernel_pops_below_its_window(cuda, V, side):
    """A chain deeper than the shared-memory window, then one point that
    pops it to the bottom: the pops cross the window into device memory."""
    from repro_torch import testing
    from repro_torch.kernels import chain
    window = chain.kernel_shape(V, 1 << 14)["window"]
    depth = window + window // 2 + 3
    pts, counts = testing.pack_runs([testing.deep_pop_run(depth, side)] * V)
    assert chain.kernel_shape(V, pts.shape[1])["window"] == window
    _, h = _chain_held(cuda, pts, counts)
    assert h.tolist() == [3] * V


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["near-collinear", "x-ties", "subnormal"])
@pytest.mark.parametrize("V", [3, 2048])
def test_monotone_chain_kernel_on_float32_edge_families(cuda, family, V):
    """Points of y = x / 3 rounded to float32, some moved by one ulp;
    columns of points that share x; and Gaussian points scaled into the
    subnormal range, whose differences and products the turn test flushes
    to zero as XLA does."""
    from repro_torch import testing
    rng = np.random.default_rng(len(family) * V)
    n = 6000 if V == 3 else 700
    make = {"near-collinear": testing.near_collinear_run,
            "x-ties": testing.x_ties_run,
            "subnormal": lambda k, g: testing.lex_unique(
                testing.gauss_run(k, g) * np.float32(1e-38))}[family]
    _chain_held(cuda, *testing.pack_runs([make(n, rng) for _ in range(V)]))


@pytest.mark.cuda
def test_monotone_chain_kernel_keeps_every_point_of_an_extreme_run(cuda):
    """2^18 points all extreme in float32 (``testing.extreme_run``): the
    lower chain keeps every point and the upper chain none, so the hull is
    the run; too long for the plain version's slot loop, held to the run."""
    from repro_torch import testing
    from repro_torch.kernels import chain
    run = torch.from_numpy(testing.extreme_run(1 << 18))[None].to(cuda)
    hull, h = chain.monotone_chain_cuda(
        run, torch.tensor([1 << 18], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert h.tolist() == [1 << 18] and torch.equal(hull, run)


@pytest.mark.cuda
def test_monotone_chain_kernel_clamps_counts(cuda):
    """Counts of 0, 1 and 2, counts above L (clamped to L) and below 0
    (clamped to 0), on full rows of sorted points."""
    from repro_torch import testing
    rng = np.random.default_rng(5)
    L = 300
    counts = np.asarray([0, 1, 2, L + 5, L + 4000, -3, 3, L], np.int32)
    pts, _ = testing.pack_runs([testing.gauss_run(L, rng)
                                for _ in counts], L)
    _, h = _chain_held(cuda, pts, counts)
    assert h.tolist()[:3] == [0, 1, 2] and h[5] == 0


@pytest.mark.cuda
def test_monotone_chain_kernel_on_a_merge_shaped_batch(cuda):
    """2048 runs of mixed lengths, shaped like the 2-D hull's merge-0 with
    a smaller L: most runs partly live, some empty, some full."""
    from repro_torch import testing
    rng = np.random.default_rng(2048)
    L = 1200
    pts, _ = testing.pack_runs([testing.gauss_run(L, rng)
                                for _ in range(2048)], L)
    counts = rng.integers(0, L + 1, 2048).astype(np.int32)
    counts[:6] = [0, 1, 2, L, L - 1, L]
    _chain_held(cuda, pts, counts)


def _geometry_plans():
    """(name, plan, inputs, key) at small sizes, one of each geometry
    plan family."""
    from repro_torch.core import hull2d_plan, hull3d_plan, lp_plan
    rng = np.random.default_rng(78)
    A = rng.normal(size=(24, 3)).astype(np.float32)
    return [
        ("hull2d", hull2d_plan(6000, 64),
         (rng.normal(size=(6000, 2)).astype(np.float32),), 3),
        ("hull3d", hull3d_plan(16, 64),
         (rng.normal(size=(16, 3)).astype(np.float32),), None),
        ("lp", lp_plan(24, 3, 64),
         (np.array([1.0, -0.5, 0.25], np.float32), A,
          rng.uniform(1, 2, 24).astype(np.float32)), None),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["hull2d", "hull3d", "lp"])
def test_geometry_plans_on_the_card_match_the_dense_engine(cuda, family):
    """Each geometry plan on the card's kernel engine: every shuffle on the
    kernels, ``monotone_chain`` launched once a merge or finalize round of
    the 2-D hull, outputs and CostAccum equal to the card's dense engine
    on the same draw."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import LocalEngine, get_engine
    _, plan, inputs, key = next(f for f in _geometry_plans()
                                if f[0] == family)
    eng = get_engine("kernel", device=cuda)
    ops.reset_launches()
    got = eng.compile(plan)(*inputs, key=key)
    torch.cuda.synchronize()
    launches = ops.launches()
    assert eng.route_log.dense == 0 and eng.route_log.kernel > 0
    assert launches["bincount_tiles"] == eng.route_log.kernel
    chain_rounds = sum(s.name.startswith(("merge", "finalize"))
                       for s in plan.stages)
    assert launches["monotone_chain"] == chain_rounds
    assert (chain_rounds > 0) == (family == "hull2d")
    want = LocalEngine(device=cuda).compile(plan)(*inputs, key=key)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def _sort_query(cuda, n=1 << 14, M=256, seed=3):
    from repro_torch.core import sort_plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return sort_plan(n, M), torch.randn(n, device=cuda, generator=gen), seed


@pytest.mark.cuda
def test_fault_proxy_keeps_the_card_and_the_kernels(cuda, tmp_path):
    """``with_faults`` of a kernel engine on the card keeps its device: a
    recovered query's outputs live on the card, equal the fault-free run,
    and every shuffle it ran (the replay included) launched both shuffle
    kernels."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import execute_plan, get_engine
    from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                           run_plan_with_recovery,
                                           with_faults)
    eng = get_engine("kernel", device=cuda)
    proxy = with_faults(eng, FaultConfig())
    assert proxy.device == eng.device and proxy.device.type == "cuda"
    plan, x, key = _sort_query(cuda)
    want = execute_plan(plan, eng, (x,), key=key)
    ops.reset_launches()
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    got, rep = run_plan_with_recovery(plan, eng, (x,), key=key,
                                      faults=FaultConfig(fail_at=(1,)),
                                      checkpointer=ck)
    torch.cuda.synchronize()
    launches = ops.launches()
    assert rep.restarts == 1 and rep.failures_injected == 1
    # entry, the failed local-sort attempt (no shuffle), its replay
    assert launches["bincount_tiles"] == launches["bitonic_sort"] == 2
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.device.type == "cuda" and torch.equal(g, w)
    tree, _ = ck.load(ck.latest(), device=cuda)
    assert tree["box"].valid.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sort", "hull2d"])
def test_traced_and_recovered_queries_on_the_card(cuda, family, tmp_path):
    """A traced query and a recovered one (asynchronous checkpoints) on the
    card's kernel engine equal the untraced fault-free query; the trace
    keeps the schedule and sees only kernel routes."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import get_engine, hull2d_plan
    from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                           run_plan_with_recovery)
    from repro_torch.obs import Tracer, summarize
    if family == "sort":
        plan, x, key = _sort_query(cuda)
    else:
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        x, key = torch.randn(1 << 14, 2, device=cuda, generator=gen), 5
        plan = hull2d_plan(1 << 14, 256)
    want = get_engine("kernel", device=cuda).compile(plan)(x, key=key)
    tr = Tracer()
    traced = get_engine("kernel", device=cuda, tracer=tr).compile(plan)(
        x, key=key)
    s = summarize(tr)
    assert s["schedule_ok"] and s["routes"]["dense"] == 0
    ck = Checkpointer(tmp_path, plan=plan, every=1, async_save=True)
    recovered, rep = run_plan_with_recovery(
        plan, get_engine("kernel", device=cuda), (x,), key=key,
        faults=FaultConfig(fail_at=(1,)), checkpointer=ck)
    assert rep.restarts == 1
    for out in (traced, recovered):
        for g, w in zip(tree_leaves(out), tree_leaves(want)):
            assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.cuda
def test_query_service_on_the_card_equals_sequential(cuda):
    """A ``QueryService`` drain on the card's kernel engine: every result
    equals the sequential call, on the card, and every shuffle launched
    the kernels."""
    from repro_torch.core import get_engine
    from repro_torch.serve import QueryService, VirtualClock
    from repro_torch.serve import loadgen
    eng = get_engine("kernel", device=cuda)
    cfg = loadgen.TrafficConfig(families=("sort", "multisearch", "hull2d"),
                                n_queries=24, seed=2)
    wl = loadgen.make_workload(loadgen.make_suite(eng, cfg), cfg)
    seq, _, _ = loadgen.run_sequential(eng, wl)
    ops.reset_launches()
    eng.route_log.reset()
    svc = QueryService(eng, max_batch=4, clock=VirtualClock())
    results, _ = loadgen.run_closed_loop(svc, wl)
    torch.cuda.synchronize()
    loadgen.assert_results_equal(results, seq, "service vs sequential")
    assert all(leaf.device.type == "cuda" for r in results.values()
               for leaf in (r.stats.rounds,))
    assert eng.route_log.dense == 0
    assert ops.launches()["bitonic_sort"] == eng.route_log.kernel > 0
    assert ops.launches()["monotone_chain"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,tile_n,n_buckets", [
    (4, 64, 4096, 2048),         # the sort's tiles at B = 4, G = 8 | T
    (3, 13, 1024, 2048),         # G = 8 does not divide T
    (2, 7, 1001, 4097),          # G = 3, scalar loads, one bucket a lane
    (3, 1, 32, 8),               # one group a query
    (2, 5, 64, 1 << 16),         # the global route
    (3, 70, 16, 1 << 16),        # the global route, two chunks a query
])
def test_batched_bincount_tiles_kernel_matches_plain(cuda, B, T, tile_n,
                                                     n_buckets):
    """One launch for B queries: the tables equal the plain version's and
    each query's equal its own unbatched launch, the cross-tile prefix
    restarting at each query, on both routes."""
    tiles = torch.from_numpy(RNG.integers(
        -2, n_buckets + 2, (B, T, tile_n)).astype(np.int32)).to(cuda)
    tiles[0, -1] = -1                                   # an empty tile
    G = bincount.group_tiles(T, tile_n, n_buckets, B)
    assert G == bincount.group_tiles(T, tile_n, n_buckets)
    ops.reset_launches()
    got = ops.bincount_tiles(tiles, n_buckets)
    torch.cuda.synchronize()
    launches = ops.launches()
    assert launches["bincount_tiles"] == 1
    assert launches["bincount_tiles.single_pass" if G
                    else "bincount_tiles.global"] == 1
    for g, w in zip(got, bincount.bincount_tiles_plain(tiles, n_buckets)):
        assert g.shape == (B, T, n_buckets) and torch.equal(g, w)
    for b in range(B):
        for g, w in zip(got, ops.bincount_tiles(tiles[b], n_buckets)):
            assert torch.equal(g[b], w)


@pytest.mark.cuda
def test_bitonic_sort_kernel_on_ties_inf_and_nan(cuda):
    """What the network gives where the plain version differs (see
    ``bitonic_sort_plain``): tied keys' values in the network's order, an
    ``+inf`` key lost to the padding of a row 3 wide, and a NaN row."""
    k, v = bitonic_sort.bitonic_sort_cuda(
        torch.tensor([[1, 1, 1, 0]], dtype=torch.int32, device=cuda),
        torch.arange(4, dtype=torch.int32, device=cuda)[None])
    assert k.tolist() == [[0, 1, 1, 1]]
    assert v.tolist() == [[3, 0, 2, 1]]                 # as the JAX network
    k, v = bitonic_sort.bitonic_sort_cuda(
        torch.tensor([[float("inf"), 1.0, 2.0]], device=cuda),
        torch.arange(3, dtype=torch.int32, device=cuda)[None])
    assert k.tolist() == [[1.0, 2.0, torch.finfo(torch.float32).max]]
    assert v.tolist() == [[1, 2, 0]]
    k, v = bitonic_sort.bitonic_sort_cuda(
        torch.tensor([[float("nan"), 1.0, 0.0, 2.0]], device=cuda),
        torch.arange(4, dtype=torch.int32, device=cuda)[None])
    assert torch.isnan(k[0, 0]) and k[0, 1:].tolist() == [0.0, 1.0, 2.0]
    assert v.tolist() == [[0, 2, 1, 3]]                 # the NaN stays first


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sort", "multisearch", "hull2d"])
def test_batch_on_the_card_is_one_program(cuda, family):
    """``exe.batch(3)`` on the card's kernel engine: every row equals its
    single call, and the batch launches each kernel as often as one
    query."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import get_engine, hull2d_plan, multisearch_plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    if family == "sort":
        plan, n = _sort_query(cuda)[0], 1 << 14
        inputs = (torch.randn(3, n, device=cuda, generator=gen),)
    elif family == "multisearch":
        plan = multisearch_plan(4096, 256, 64)
        inputs = (torch.randn(3, 4096, device=cuda, generator=gen),
                  torch.randn(3, 256, device=cuda, generator=gen))
    else:
        plan = hull2d_plan(1 << 14, 256)
        inputs = (torch.randn(3, 1 << 14, 2, device=cuda, generator=gen),)
    eng = get_engine("kernel", device=cuda)
    exe = eng.compile(plan)
    ops.reset_launches()
    single = exe(*(x[0] for x in inputs), key=5)
    torch.cuda.synchronize()
    one = ops.launches()
    ops.reset_launches()
    out = exe.batch(3)(*inputs, keys=[5, 6, 7])
    torch.cuda.synchronize()
    assert ops.launches() == one and one["bitonic_sort"] > 0
    assert eng.route_log.dense == 0
    for i in range(3):
        want = single if i == 0 else exe(*(x[i] for x in inputs), key=5 + i)
        for g, w in zip(tree_leaves(out), tree_leaves(want)):
            assert g.device.type == "cuda" and torch.equal(g[i], w)


@pytest.mark.cuda
def test_sharded_engine_on_one_nccl_rank_equals_local(cuda, tmp_path):
    """A one-rank NCCL group: ``ShardedEngine(shuffle_impl="kernel")``
    sorts 2^20 keys, overlapped and sequential, bit for bit as the kernel
    ``LocalEngine`` does (values and CostAccum), every shuffle on the
    kernels with the local engine's launches."""
    import torch.distributed as dist
    from repro_torch.core import LocalEngine, ShardedEngine, sort_plan
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        ovl = ShardedEngine(shuffle_impl="kernel", device=cuda)
        seq = ShardedEngine(shuffle_impl="kernel", device=cuda,
                            overlap=False)
        local = LocalEngine(shuffle_impl="kernel", device=cuda)
        n = 1 << 20
        plan = sort_plan(n, 1024, align=ovl.aligned_nodes)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(23)
        x = torch.randn(n, device=cuda, generator=gen)
        results = {}
        for name, eng in (("local", local), ("sharded", ovl),
                          ("sharded-seq", seq)):
            ops.reset_launches()
            results[name] = eng.compile(plan)(x, key=3)
            torch.cuda.synchronize()
            results[name + "-launches"] = ops.launches()
            assert eng.route_log.dense == 0 and eng.route_log.kernel > 0
        want = results["local"]
        assert torch.equal(want.values, torch.sort(x).values)
        assert int(want.stats.dropped) == 0
        assert ovl.route_log.overlapped > 0 and seq.route_log.overlapped == 0
        for name in ("sharded", "sharded-seq"):
            got = results[name]
            assert got.values.device.type == "cuda"
            assert torch.equal(got.values, want.values)
            for a, b in zip(got.stats, want.stats):
                assert torch.equal(a, b)
            assert results[name + "-launches"] == results["local-launches"]
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"])
def test_moe_einsum_bf16_matches_a_float32_expert_loop(cuda, arch):
    """bf16 against float32 with the same routes: rms(got - want) <= 2e-2
    rms(want) and |got - want| <= 2e-2 |want| + 0.12 rms(want), about ten
    bf16 roundings (unit roundoff 2^-9) of the element or of the output's
    scale, and six times that at the tail; chip_smoke.py's rule at full
    width.  Groups of 16 over 4 x 10 tokens pad the last group."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.testing import moe_layer_f32, scaled_close
    cfg = get_config(arch, reduced=True, compute_dtype="bfloat16",
                     param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(4, 10, cfg.d_model, device=cuda,
                    generator=gen).to(torch.bfloat16)
    r = moe._route_tokens(p, cfg, x, group=16)
    got = moe._moe_einsum(p, cfg, x, group=16)
    torch.cuda.synchronize()
    want = moe_layer_f32(p, cfg, x, r)
    assert got.y.dtype == torch.bfloat16
    assert scaled_close(got.y, want, 2e-2)
    assert 0.0 <= got.dropped_frac.item() < 1.0
