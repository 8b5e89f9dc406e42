"""Fixed-dimensional linear programming by Min-CRCW combine (paper §1.4).

Minimize c·x subject to Ax <= b with A (n, d), d fixed.  Parallel
structure — every d-subset of constraints is a PRAM processor holding one
candidate basis; it solves its d x d system for the candidate vertex, tests
feasibility against all n constraints, and the best feasible objective wins
through a Min-semigroup invisible funnel into a single cell (Theorem 3.2) —
the MapReduce analogue of the constant-time fixed-dimension RAM algorithms
the paper cites.  Work is O(C(n, d) · n); rounds are O(log_M C(n, d)) =
O(d log_M n).

With ``engine=`` the Min funnel executes as rounds of that backend (see
:func:`repro_torch.core.funnel.funnel_write_plan`), so the combine — and
its stats — run identically on every engine.  min over floats is exact, so
the optimum is the same across backends and combine orders.

The per-basis work is float32 library calls: a batched ``torch.linalg.det``
and ``torch.linalg.solve_ex`` (which neither raises on a singular batch
member nor waits for the device), and one matmul for the (n, C(n, d))
feasibility test, which on the card must not run in TF32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..._device import as_device
from ..costmodel import CostAccum, MRCost, tree_height
from ..funnel import _funnel_write_dense, _funnel_write_engine
from ..plan import Plan, PlanState, custom_stage
from .util import combinations_array, require_true_float32


class LPResult(NamedTuple):
    """LP output."""

    x: torch.Tensor          # (d,) best candidate vertex (valid iff feasible)
    objective: torch.Tensor  # 0-d float32; +inf when no feasible vertex
    stats: CostAccum


def _solve_bases(c, A, bv, bases, feas_eps):
    """Every candidate basis solves its d x d system and tests feasibility
    against all n constraints (the per-processor PRAM work).  Singular
    bases (|det| <= 1e-9) solve the identity instead and are infeasible.
    ``c`` (..., d), ``A`` (..., n, d) and ``bv`` (..., n) may carry a
    batch's leading axis; the results are then (..., Q, d), (..., Q)."""
    require_true_float32(A, "the LP's feasibility test")
    d = int(A.shape[-1])
    bases = bases.long()
    sub_A = A[..., bases, :]                            # (..., Q, d, d)
    sub_b = bv[..., bases]                              # (..., Q, d)
    ok = torch.linalg.det(sub_A).abs() > 1e-9
    safe_A = torch.where(ok[..., None, None], sub_A,
                         torch.eye(d, dtype=A.dtype, device=A.device))
    xs = torch.linalg.solve_ex(safe_A, sub_b[..., None]).result[..., 0]
    feas = ok & (A @ xs.transpose(-2, -1)
                 <= bv[..., None] + feas_eps).all(-2)
    obj = torch.where(feas, (xs @ c[..., None])[..., 0], math.inf)
    return xs, feas, obj


def _lp_inputs(c, A, b, device):
    return tuple(torch.as_tensor(v, dtype=torch.float32, device=device)
                 for v in (c, A, b))


def lp_plan(n: int, d: int, M: int = 64, *, feas_eps: float = 1e-5,
            shape: bool = True) -> Plan:
    """Fixed-dimensional LP as a plan builder: the C(n, d) candidate bases
    solve and feasibility-test in the prologue (per-processor work), then
    one named Min-CRCW funnel stage combines the best feasible objective
    into a single cell as engine rounds (O(log_M C(n, d)) of them).  Inputs
    at execute time: ``(c, A, b)``.  ``shape`` selects the funnel's
    shape-scheduled (default) vs frozen footprint — the same optimum and
    stats either way.
    """
    n, d = int(n), int(d)
    bases_host = combinations_array(n, d, device="cpu")  # (Q, d) static
    Q = int(bases_host.shape[0])
    L = tree_height(max(Q, 2), max(2, M // 2))
    fingerprint = ("lp", n, d, int(M), float(feas_eps), bool(shape))

    def prologue(inputs, keys, device):
        c, A, bv = _lp_inputs(*inputs, device)
        xs, feas, obj = _solve_bases(c, A, bv, bases_host.to(device),
                                     feas_eps)
        return {"xs": xs, "feas": feas, "obj": obj,
                "memory": torch.full((len(keys), 1), math.inf,
                                     dtype=torch.float32, device=device)}

    def min_funnel(engine, state: PlanState) -> PlanState:
        # Min-CRCW: every live processor writes its objective to cell 0.
        carry = state.carry
        addrs = torch.where(carry["feas"], 0, -1).to(torch.int32)
        res = _funnel_write_engine(addrs, carry["obj"], carry["memory"],
                                   torch.minimum, M, engine, math.inf,
                                   shape=shape, batched=True)
        return PlanState(state.box, {**carry, "memory": res.memory},
                         state.accum.merge_sequential(res.stats))

    # Declared footprint: the funnel's level-0 (peak) shape — ceil(Q/f)
    # groups x 1 cell.
    stages = (custom_stage("min-funnel", L + 1, max(2, M // 2), min_funnel,
                           -(-Q // max(2, M // 2))),)

    def epilogue(state):
        carry = state.carry
        # Broadcast winner: the arg-min candidate (exact for float min;
        # torch.argmin returns the first minimum, as jnp.argmin does).
        obj = carry["obj"]
        k = torch.argmin(obj, dim=-1)
        rows = torch.arange(obj.shape[0], device=obj.device)
        return LPResult(x=carry["xs"][rows, k],
                        objective=carry["memory"][:, 0], stats=state.accum)

    return Plan(name="lp", fingerprint=fingerprint, n_nodes=Q,
                stages=stages, prologue=prologue, epilogue=epilogue,
                round_bound=L + 1,
                input_spec=(((d,), None), ((n, d), None), ((n,), None)))


def linear_program_mr(c, A, b, M: int = 64, *, engine=None,
                      feas_eps: float = 1e-5, device="cuda") -> LPResult:
    """Deprecated wrapper: with ``engine=`` it builds :func:`lp_plan`,
    compiles it on that backend (cached per fingerprint) and runs it;
    ``engine=None`` keeps the legacy dense-funnel combine (identical
    optimum, dense accounting structure) on ``device`` — the card unless
    the caller asks for the CPU.  Prefer the plan API.
    """
    from ..api import deprecated_entry
    deprecated_entry("linear_program_mr", "lp_plan")
    A = torch.as_tensor(A, dtype=torch.float32)
    if engine is not None:
        plan = lp_plan(int(A.shape[0]), int(A.shape[1]), M,
                       feas_eps=feas_eps)
        return engine.compile(plan)(c, A, b)
    return _lp_dense(*_lp_inputs(c, A, b, as_device(device, "lp")), M,
                     feas_eps)


def _lp_dense(c, A, b, M: int, feas_eps: float) -> LPResult:
    """Legacy dense-funnel realization of the Min-CRCW combine, on the
    device of the float32 tensors ``c``, ``A`` and ``b``."""
    n, d = int(A.shape[0]), int(A.shape[1])
    bases = combinations_array(n, d, device=A.device)   # (Q, d) static
    xs, feas, obj = _solve_bases(c, A, b, bases, feas_eps)
    addrs = torch.where(feas, 0, -1).to(torch.int32)
    res = _funnel_write_dense(addrs, obj,
                              torch.full((1,), math.inf, dtype=torch.float32,
                                         device=A.device),
                              torch.minimum, M, math.inf)
    k = torch.argmin(obj)
    return LPResult(x=xs[k], objective=res.memory[0], stats=res.stats)


def linear_program_nd(c, A, b, M: int = 64, *, engine=None,
                      cost: Optional[MRCost] = None, device="cuda"
                      ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Host wrapper with the seed's API: (x_opt, objective), or (None, None)
    when no candidate vertex is feasible.  ``engine=None`` runs the dense
    path on ``device`` (the card unless the caller asks for the CPU)."""
    A = torch.as_tensor(A, dtype=torch.float32)
    if engine is not None:
        plan = lp_plan(int(A.shape[0]), int(A.shape[1]), M)
        res = engine.compile(plan)(c, A, b)
        engine.require_no_drops(res.stats, what="fixed-dim LP")
    else:
        res = _lp_dense(*_lp_inputs(c, A, b, as_device(device, "lp")), M,
                        1e-5)
    if cost is not None:
        cost.absorb(res.stats)
    best = float(res.objective)
    if not math.isfinite(best):
        return None, None
    return res.x.cpu().numpy().astype(np.float64), best


def lp_round_bound(n: int, d: int, M: int) -> int:
    """Concrete ceiling for the LP's Min-funnel rounds: L + 1 with
    L = ceil(log_f C(n, d)), f = max(2, M/2) — the paper's O(log_M P)."""
    Q = math.comb(n, d)
    return tree_height(max(Q, 2), max(2, M // 2)) + 1
