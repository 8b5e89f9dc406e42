"""3-D convex hull through the CRCW PRAM simulation (paper §1.4 via Thm 3.2).

The paper's third headline application reduces 3-D hulls to a constant-step
CRCW PRAM computation simulated in O(log_M P) MapReduce rounds per step.
The parallel step realized here is the classical brute-force facet test:
one PRAM processor per point triple (i, j, k) decides whether the plane
through its triple supports the point set (all points on one closed side);
supporting triples then mark their three vertices as hull vertices through
a Max-CRCW concurrent write — three PRAM steps (one per triple vertex),
each an invisible-funnel combine (Theorem 3.2), driven end to end by
:func:`repro_torch.core.funnel.simulate_crcw`.  With ``engine=`` every
funnel level runs as an engine round, so the same program executes — with
the same results and stats — on every backend.

Work is O(n^3 · n): the paper's point for fixed dimension is round
complexity, not work efficiency.  Degenerate semantics (shared with the
float64 oracle): near-coplanar supports within the tolerance band are all
reported, so a fully coplanar cloud marks every point; inputs with n < 4
mark every point extreme.

The facet test's products are float32 library calls (``torch.linalg.cross``,
``torch.linalg.norm``, one matmul for the (P, n) distances).  A float32
matmul on the card must not run in TF32, which keeps about three digits:
:func:`_facet_mask` refuses to run on the card unless
``torch.get_float32_matmul_precision()`` is ``"highest"`` (the default).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..._device import as_device
from ..costmodel import CostAccum, MRCost, tree_height
from ..funnel import PRAMProgram, _crcw_step, simulate_crcw
from ..plan import Plan, PlanState, custom_stage
from .util import combinations_array, require_true_float32


class Hull3DResult(NamedTuple):
    """3-D hull output."""

    mask: torch.Tensor    # (n,) bool — point i is a vertex of the hull
    stats: CostAccum


def _facet_mask(pts: torch.Tensor, tri: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Which triples span a supporting plane of the whole set (vectorized).
    ``pts`` is (..., n, 3), a batch's queries on the leading axis; returns
    (..., P)."""
    require_true_float32(pts, "the 3-D hull's facet test")
    tri = tri.long()
    A, B, C = (pts[..., tri[:, k], :] for k in range(3))
    nrm = torch.linalg.cross(B - A, C - A, dim=-1)       # (..., P, 3)
    nn = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    scale = pts.abs().amax(dim=(-2, -1)).clamp_min(1.0)[..., None]
    nondeg = nn[..., 0] > 1e-6 * scale * scale
    unit = nrm / nn.clamp_min(1e-30)
    # signed distance of every point to every candidate plane: (..., P, n)
    dist = unit @ pts.transpose(-2, -1) - (unit * A).sum(-1, keepdim=True)
    tol = (eps * scale)[..., None]
    return nondeg & ((dist <= tol).all(-1) | (dist >= -tol).all(-1))


_HULL3D_PROG = PRAMProgram(
    # One PRAM step per triple vertex: read the cell (funnel read collapses
    # duplicates), then concurrently write 1.0 into it, combined by max.
    read_addr=lambda state, t: state["tri"][..., t],
    compute=lambda state, vals, t: (
        state,
        torch.where(state["facet"], state["tri"][..., t], -1),
        torch.ones_like(vals)),
)


def hull3d_plan(n: int, M: int, *, eps: float = 1e-4,
                shape: bool = True) -> Plan:
    """3-D convex hull as a plan builder: the Theorem 3.2 CRCW simulation
    with one named stage per PRAM step (three Max-CRCW steps, one per
    triple vertex), each running its invisible funnels as engine rounds.
    Input at execute time: ``(points,)`` of shape (n, 3).

    ``shape`` selects the write funnels' shape-scheduled (default) vs
    frozen per-level footprint — the same results and stats either way.
    """
    n, M = int(n), int(M)
    fingerprint = ("hull3d", n, M, float(eps), bool(shape))
    if n < 4:                      # degenerate: every point is extreme
        return Plan(
            name="hull3d", fingerprint=fingerprint, n_nodes=1, stages=(),
            prologue=lambda inputs, keys, device: {
                "mask": torch.ones((len(keys), n), dtype=torch.bool,
                                   device=device)},
            epilogue=lambda st: Hull3DResult(mask=st.carry["mask"],
                                             stats=st.accum),
            round_bound=0, input_spec=(((n, 3), None),))
    tri_host = combinations_array(n, 3, device="cpu")   # (P, 3) static
    P = int(tri_host.shape[0])
    d = max(2, M // 2)
    L = tree_height(max(P, 2), d)

    def prologue(inputs, keys, device):
        pts = torch.as_tensor(inputs[0], dtype=torch.float32, device=device)
        tri = tri_host.to(device)
        B = pts.shape[0]
        return {"state": {"tri": tri.expand(B, -1, -1),
                          "facet": _facet_mask(pts, tri, eps)},
                "memory": torch.zeros((B, n), dtype=torch.float32,
                                      device=device)}

    stages = []
    for t in range(3):
        def make_apply(t=t):
            def apply(engine, state: PlanState) -> PlanState:
                c = state.carry
                proc_state, memory, accum = _crcw_step(
                    _HULL3D_PROG, c["state"], c["memory"], t, M,
                    torch.maximum, 0.0, engine, True, state.accum,
                    shape=shape, batched=True)
                return PlanState(state.box,
                                 {"state": proc_state, "memory": memory},
                                 accum)
            return apply
        # per step: 2L+1 funnel-read rounds + L+1 engine write-funnel
        # rounds; the declared footprint is the write funnel's level-0
        # (peak) shape: ceil(P/d) groups x n cells.
        stages.append(custom_stage(f"pram-step-{t}", 3 * L + 2, d,
                                   make_apply(), -(-P // d) * n))

    def epilogue(state):
        return Hull3DResult(mask=state.carry["memory"] > 0.5,
                            stats=state.accum)

    return Plan(name="hull3d", fingerprint=fingerprint, n_nodes=P * n,
                stages=tuple(stages), prologue=prologue, epilogue=epilogue,
                round_bound=3 * (3 * L + 2),
                input_spec=(((n, 3), None),))


def convex_hull_3d_mr(points, M: int, *, engine=None, eps: float = 1e-4,
                      device="cuda") -> Hull3DResult:
    """Deprecated wrapper: with ``engine=`` it builds :func:`hull3d_plan`,
    compiles it on that backend (cached per fingerprint) and runs it;
    ``engine=None`` keeps the legacy dense-funnel realization (identical
    results, dense accounting structure) on ``device`` — the card unless
    the caller asks for the CPU.  Prefer the plan API.
    """
    from ..api import deprecated_entry
    deprecated_entry("convex_hull_3d_mr", "hull3d_plan")
    pts = torch.as_tensor(points, dtype=torch.float32)
    if engine is not None:
        plan = hull3d_plan(pts.shape[0], M, eps=eps)
        return engine.compile(plan)(pts)
    return _hull3d_dense(pts.to(as_device(device, "hull3d")), M, eps)


def _hull3d_dense(pts: torch.Tensor, M: int, eps: float) -> Hull3DResult:
    """Legacy dense-funnel realization (identical results; the dense
    accounting structure of funnel_write's segmented-scan path), on
    ``pts``'s device."""
    n = int(pts.shape[0])
    dev = pts.device
    if n < 4:                      # degenerate: every point is extreme
        return Hull3DResult(mask=torch.ones((n,), dtype=torch.bool,
                                            device=dev),
                            stats=CostAccum.zero(dev))
    tri = combinations_array(n, 3, device=dev)          # (P, 3) static
    facet = _facet_mask(pts, tri, eps)
    state = {"tri": tri, "facet": facet}
    _, memory, accum = simulate_crcw(
        _HULL3D_PROG, state, torch.zeros((n,), dtype=torch.float32,
                                         device=dev),
        3, M, torch.maximum, identity=0.0, engine=None, with_accum=True)
    return Hull3DResult(mask=memory > 0.5, stats=accum)


def convex_hull_3d(points, M: int, *, engine=None, eps: float = 1e-4,
                   cost: Optional[MRCost] = None,
                   device="cuda") -> np.ndarray:
    """Host wrapper: sorted indices of the hull vertices of ``points``.
    ``engine=None`` runs the dense path on ``device`` (the card unless the
    caller asks for the CPU)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    if engine is not None:
        res = engine.compile(hull3d_plan(pts.shape[0], M, eps=eps))(pts)
        engine.require_no_drops(res.stats, what="3-D convex hull")
    else:
        res = _hull3d_dense(pts.to(as_device(device, "hull3d")), M, eps)
    if cost is not None:
        cost.absorb(res.stats)
    return np.flatnonzero(res.mask.cpu().numpy())


def hull3d_round_bound(n: int, M: int, n_steps: int = 3) -> int:
    """Paper bound O(T log_M P) as a concrete ceiling for the Thm 3.2 3-D
    hull: per PRAM step, <= 2L+1 read rounds + L+1 write rounds with
    L = ceil(log_d P), d = max(2, M/2), P = C(n, 3)."""
    if n < 4:
        return 0
    P = n * (n - 1) * (n - 2) // 6
    L = tree_height(max(P, 2), max(2, M // 2))
    return n_steps * (3 * L + 2)
