"""Assertions the parity tests share: boxes and accumulators of either
package, compared exactly on numpy arrays.  Imports no JAX: JAX arrays
convert through ``np.asarray``."""
from __future__ import annotations

import math

import numpy as np

from ._tree import tree_leaves
from .interop import as_numpy as _np


def assert_same_box(ref, got, ctx: str = "") -> None:
    """Same payload leaves (in flattened order) and validity, bit for bit."""
    ref_leaves, got_leaves = tree_leaves(ref.payload), tree_leaves(got.payload)
    assert len(ref_leaves) == len(got_leaves), \
        f"{ctx}: {len(ref_leaves)} payload leaves != {len(got_leaves)}"
    for la, lb in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(_np(la), _np(lb), err_msg=ctx)
    np.testing.assert_array_equal(_np(ref.valid), _np(got.valid), err_msg=ctx)


def assert_same_accum(ref, got, ctx: str = "") -> None:
    """Every CostAccum field equal (rounds, communication, internal_time,
    max_reducer_io, dropped)."""
    assert tuple(ref._fields) == tuple(got._fields), ctx
    for name, fa, fb in zip(ref._fields, ref, got):
        assert float(_np(fa)) == float(_np(fb)), \
            f"{ctx}: CostAccum.{name} {fa} != {fb}"


def assert_same_stats(ref, got, ctx: str = "") -> None:
    """Every RoundStats field equal, and int32 on both sides."""
    for name, fa, fb in zip(ref._fields, ref, got):
        a, b = _np(fa), _np(fb)
        assert int(a) == int(b), f"{ctx}: RoundStats.{name} {a} != {b}"
        assert a.dtype == np.int32 and b.dtype == np.int32, \
            f"{ctx}: RoundStats.{name} dtypes {a.dtype}, {b.dtype}"


# -- input families of the monotone chain -----------------------------------
# Each returns one run: a (k, 2) float32 array, lex-sorted by (x, y), no point
# twice, as the 2-D hull hands runs to ``ops.monotone_chain``.

def lex_unique(pts: np.ndarray) -> np.ndarray:
    """The distinct rows of a (k, 2) float32 array in (x, y) order."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    keep = np.ones(len(pts), bool)
    keep[1:] = (pts[1:] != pts[:-1]).any(1)
    return pts[keep]


def parabola_run(n: int, sign: float = 1.0) -> np.ndarray:
    """n integer points on y = sign x^2, |x| <= n / 2 + 1: every turn test
    is exact, and every point stays on the lower chain (sign 1) or on the
    upper chain (sign -1)."""
    x = np.arange(n, dtype=np.float32) - np.float32(n // 2)
    return np.stack([x, np.float32(sign) * x * x], 1)


def deep_pop_run(depth: int, side: str = "lower") -> np.ndarray:
    """``depth`` points that all stand on one chain's stack, then one point
    that pops that chain to the bottom of its stack: for the lower chain the
    parabola y = x^2 and a last point far below it on the right; for the
    upper chain (which walks the run backward) y = -x^2 and a first point
    far above it on the left.  The hull has 3 points."""
    if side == "lower":
        run = parabola_run(depth, 1.0)
        far = [[run[-1, 0] + 1, -1e9]]
        return np.concatenate([run, np.asarray(far, np.float32)])
    run = parabola_run(depth, -1.0)
    far = [[run[0, 0] - 1, 1e9]]
    return np.concatenate([np.asarray(far, np.float32), run])


def near_collinear_run(n: int, rng: np.random.Generator) -> np.ndarray:
    """n points of y = x / 3 rounded to float32 (x distinct in [-100, 100)),
    about a quarter of them moved up or down by one ulp: turn tests whose
    sign float32 rounding decides."""
    x = np.unique(rng.uniform(-100, 100, n).astype(np.float32))
    y = x / np.float32(3)
    to = np.where(rng.random(x.size) < 0.5, np.inf, -np.inf).astype(np.float32)
    y = np.where(rng.random(x.size) < 0.25, np.nextafter(y, to), y)
    return np.stack([x, y.astype(np.float32)], 1)


def x_ties_run(n: int, rng: np.random.Generator) -> np.ndarray:
    """About n points whose x takes 16 integer values, y standard normal:
    long vertical columns of points that share x."""
    x = rng.integers(0, 16, n).astype(np.float32)
    return lex_unique(np.stack([x, rng.standard_normal(n).astype(np.float32)],
                               1))


def gauss_run(n: int, rng: np.random.Generator) -> np.ndarray:
    """n standard-normal points, lex-sorted."""
    return lex_unique(rng.standard_normal((n, 2)).astype(np.float32))


def pack_runs(runs, L: int = None):
    """((V, L, 2) float32 points, (V,) int32 counts): run v in the first
    len(runs[v]) slots of row v, zeros after; L defaults to the longest."""
    L = max([len(r) for r in runs] + [0]) if L is None else L
    pts = np.zeros((len(runs), L, 2), np.float32)
    for v, r in enumerate(runs):
        pts[v, :len(r)] = r
    return pts, np.asarray([len(r) for r in runs], np.int32)


def _slope_edges(r_lo: float, ratio: float, count: int):
    """The first ``count``, in increasing slope, of the primitive integer
    vectors (p, q), p >= 1, with r_lo <= q / p < ratio * r_lo."""
    D = max(2, int(math.sqrt(2 * count / (0.6 * r_lo * (ratio - 1)))))
    while True:
        p = np.arange(1, D + 1)
        lo = np.ceil(r_lo * p).astype(np.int64)
        k = np.maximum(np.ceil(ratio * r_lo * p).astype(np.int64) - lo, 0)
        P = np.repeat(p, k)
        Q = np.repeat(lo, k) + np.arange(k.sum()) - np.repeat(np.cumsum(k) - k,
                                                              k)
        keep = np.gcd(P, Q) == 1
        P, Q = P[keep], Q[keep]
        if len(P) >= count:
            order = np.argsort(Q / P, kind="stable")
            return P[order][:count], Q[order][:count]
        D = int(D * 1.3) + 1


def _grid(v: float) -> float:
    """A power of two whose multiples below 4 |v| are float32 numbers."""
    return 2.0 ** (math.floor(math.log2(v)) - 22)


def _convex_side(count: int, per_box: int = 4096, ratio: float = 1.35,
                 gap: float = 1e-3, reach: int = 1 << 16):
    """``count`` points (x, y), x > 0 rising, on a convex chain near
    y = x^2 from (2^-26, 2^-52): in boxes of ``per_box`` points, each box
    on a grid of float32 numbers (``_grid`` of its first point), its edges
    the primitive vectors of slopes in [s, ratio s) in slope order, scaled
    so that x and y grow by about ratio and ratio^2; one long edge of a
    slightly larger slope moves the chain onto the next box's grid."""
    x, y = 2.0 ** -26, 2.0 ** -52
    xs, ys = [x], [y]
    slope = None
    while len(xs) < count:
        if slope is None:
            s_lo = 2 * x
        else:
            ux, uy = 2 * _grid(x), 2 * _grid(y)
            nx = math.ceil((x + reach * ux) / ux) * ux
            ny = round((y + slope * (1 + gap) * (nx - x)) / uy) * uy
            slope = (ny - y) / (nx - x)
            x, y = nx, ny
            xs.append(x)
            ys.append(y)
            s_lo = slope * (1 + gap)
        k = min(per_box, count - len(xs))
        if k <= 0:
            break
        ux, uy = _grid(x), _grid(y)
        P, Q = _slope_edges(s_lo * ux / uy, ratio, k)
        s = math.floor(min((ratio - 1) * x / (P.sum() * ux),
                           (ratio ** 2 - 1) * y / (Q.sum() * uy)))
        xs.extend((x + np.cumsum(P * s) * ux).tolist())
        ys.extend((y + np.cumsum(Q * s) * uy).tolist())
        x, y = xs[-1], ys[-1]
        slope = (Q[-1] * uy) / (P[-1] * ux)
    return np.asarray(xs[:count]), np.asarray(ys[:count])


def extreme_run(n: int) -> np.ndarray:
    """n >= 4 float32 points, lex-sorted, every one a vertex of their hull
    and on its lower chain, in order, under the chain's float32 turn test:
    a convex chain of exact float32 lattice points on both sides of the
    origin (``_convex_side`` and its mirror, the origin between), then one
    point far above on the right, (X, Y), both powers of two, Y 2^26 times
    the chain's highest y.  Every test of three consecutive points is exact
    up to one rounding far below its value, and the far point makes every
    test of the upper chain (which walks back from it) exactly
    Y (x_p - x_b) <= 0, so that chain pops every point.  Every product of a
    test stays a normal float32 up to 2^20 points (between about 2^-104 and
    2^116), so flushing subnormals changes nothing.  Points on y = x^2 with
    x = sinh t stop being convex in float32 somewhere above 2^16 points;
    these do not."""
    right = (n - 1) // 2
    x, y = _convex_side(right)
    left = n - 2 - right
    xs = np.concatenate([-x[:left][::-1], [0.0], x])
    ys = np.concatenate([y[:left][::-1], [0.0], y])
    far_x = 2.0 ** math.ceil(math.log2(xs[-1]) + 1)
    far_y = 2.0 ** (math.ceil(math.log2(ys.max())) + 26)
    pts = np.stack([np.append(xs, far_x), np.append(ys, far_y)], 1)
    out = pts.astype(np.float32)
    assert np.array_equal(out.astype(np.float64), pts), "not float32 points"
    return out


# -- the MoE layer's float32 reference ----------------------------------------

def scaled_close(got, want, tol: float) -> bool:
    """rms(got - want) <= tol rms(want), and |got - want| <= tol |want| +
    6 tol rms(want) everywhere: a bf16 result against float32, with the
    error of the inner sums relative to the output's scale."""
    err, want = got.float() - want.float(), want.float()
    rms = want.pow(2).mean().sqrt()
    return bool(err.pow(2).mean().sqrt() <= tol * rms) and bool(
        (err.abs() <= tol * want.abs() + 6 * tol * rms).all())


#: faults :func:`moe_layer_f32` can plant, to read what a broken layer
#: scores on a check: the routing weights left out, the shared expert
#: dropped, each token's last choice dropped, expert 0 left out
MOE_FAULTS = ("unweighted", "no_shared", "last_choice", "expert0")


def moe_layer_f32(p, cfg, x, r, fault: str = None):
    """The MoE layer's output in float32 for one run's ``Routes`` r (ids,
    keep and weights, (groups, group, k), over x's tokens padded to whole
    groups): a loop over the experts, one expert's weights cast at a time,
    plus the shared expert; with one of MOE_FAULTS planted if ``fault``."""
    import torch
    import torch.nn.functional as F
    b, s, d = x.shape
    k = r.ids.shape[-1]
    xt = x.float().reshape(-1, d)
    ids, keep = r.ids.reshape(-1, k)[:b * s], r.keep.reshape(-1, k)[:b * s]
    w = r.w.float().reshape(-1, k)[:b * s]
    if fault == "unweighted":
        w = torch.ones_like(w)
    if fault == "last_choice":
        keep = keep.clone()
        keep[:, -1] = False
    out = torch.zeros_like(xt)
    for j in range(int(fault == "expert0"), cfg.n_experts):
        tok, choice = torch.nonzero((ids == j) & keep, as_tuple=True)
        if tok.numel():
            xj = xt[tok]
            h = F.silu(xj @ p["w_gate"][j].float()) * (xj @ p["w_up"][j]
                                                      .float())
            out.index_add_(0, tok, (h @ p["w_down"][j].float())
                           * w[tok, choice, None])
    if cfg.shared_expert and fault != "no_shared":
        sp = p["shared"]
        h = F.silu(xt @ sp["w_gate"].float()) * (xt @ sp["w_up"].float())
        out += h @ sp["w_down"].float()
    return out.reshape(b, s, d)
