"""Float64 numpy oracles for the geometry subsystem.

These are the sequential ground truths the engine round programs are tested
against, copied from the JAX package's oracles with the same degenerate
semantics:

- duplicate points are removed up front (``np.unique`` rows), so an
  all-identical cloud yields a 1-vertex hull instead of repeated vertices;
- N <= 2 (after dedup) returns the sorted distinct points, not raw input;
- all-collinear inputs return exactly the two extreme endpoints;
- the empty input returns an empty (0, 2) array.

Orientation convention shared with the engine path: strict hull (collinear
boundary points excluded), CCW, starting at the lexicographic minimum.
"""
from __future__ import annotations

import itertools

import numpy as np


def _cross(o, a, b):
    return ((a[0] - o[0]) * (b[1] - o[1])
            - (a[1] - o[1]) * (b[0] - o[0]))


def _monotone_chain(pts: np.ndarray) -> np.ndarray:
    """Sequential hull of x-sorted distinct points (the reducer-local f)."""
    pts = [tuple(p) for p in pts]
    if len(pts) <= 2:
        return np.asarray(pts, np.float64).reshape(len(pts), 2)
    lower = []
    for p in pts:
        while len(lower) >= 2 and _cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper = []
    for p in reversed(pts):
        while len(upper) >= 2 and _cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def convex_hull_oracle(points: np.ndarray) -> np.ndarray:
    """2-D hull, CCW from the lexicographic minimum, degenerate-safe."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if pts.shape[0] == 0:
        return pts
    spts = np.unique(pts, axis=0)        # dedup + lexicographic sort
    if spts.shape[0] <= 2:
        return spts
    hull = _monotone_chain(spts)
    start = np.lexsort((hull[:, 1], hull[:, 0]))[0]
    return np.roll(hull, -start, axis=0)


def convex_hull_3d_oracle(points: np.ndarray, eps: float = 1e-4
                          ) -> np.ndarray:
    """Sorted indices of the 3-D hull vertices, by the same brute-force
    supporting-plane definition as the engine path, in float64.

    n < 4 marks every point extreme; near-coplanar supports within the
    tolerance band are all reported (degenerate flat clouds mark all
    points) — the documented shared semantics."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    n = pts.shape[0]
    if n < 4:
        return np.arange(n)
    scale = max(float(np.max(np.abs(pts))), 1.0)
    tol = eps * scale
    mask = np.zeros(n, bool)
    for i, j, k in itertools.combinations(range(n), 3):
        nrm = np.cross(pts[j] - pts[i], pts[k] - pts[i])
        nn = float(np.linalg.norm(nrm))
        if nn <= 1e-6 * scale * scale:
            continue
        dist = (pts - pts[i]) @ (nrm / nn)
        if np.all(dist <= tol) or np.all(dist >= -tol):
            mask[[i, j, k]] = True
    return np.flatnonzero(mask)


def linear_program_oracle(c, A, b, feas_eps: float = 1e-5):
    """Dense float64 enumeration of all candidate basis vertices."""
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    n, d = A.shape
    best, best_x = np.inf, None
    for rows in itertools.combinations(range(n), d):
        sub = A[list(rows)]
        if abs(np.linalg.det(sub)) < 1e-9:
            continue
        x = np.linalg.solve(sub, b[list(rows)])
        if np.all(A @ x <= b + feas_eps):
            obj = float(c @ x)
            if obj < best:
                best, best_x = obj, x
    if not np.isfinite(best):
        return None, None
    return best_x, best
