"""Engine-native computational geometry (paper §1.4).

The paper's geometry applications, built from its own primitives and run
through the MREngine API:

- :func:`convex_hull_2d_mr` — 2-D hull as a pure round program (a batched
  monotone-chain reducer, one CUDA kernel call a round on the card, and a
  d-ary merge tree);
- :func:`convex_hull_3d_mr` — 3-D hull through the Theorem 3.2 CRCW
  simulation (invisible funnels over a parallel facet step);
- :func:`linear_program_mr` — fixed-dimensional LP by Min-CRCW combine.

Each has a host wrapper (trimmed arrays, no-drop enforcement, MRCost
adapter), a float64 oracle (:mod:`.oracles`), and a concrete round-count
ceiling realizing the paper's O(.) bound.
"""
from .chain import hull_of_runs, sort_dedup_runs
from .hull2d import (EngineHullResult, convex_hull_2d, convex_hull_2d_mr,
                     hull2d_plan, hull_round_bound)
from .hull3d import (Hull3DResult, convex_hull_3d, convex_hull_3d_mr,
                     hull3d_plan, hull3d_round_bound)
from .lp import (LPResult, linear_program_mr, linear_program_nd, lp_plan,
                 lp_round_bound)
from .oracles import (convex_hull_3d_oracle, convex_hull_oracle,
                      linear_program_oracle)

__all__ = [
    "hull_of_runs", "sort_dedup_runs",
    "EngineHullResult", "convex_hull_2d", "convex_hull_2d_mr",
    "hull2d_plan", "hull_round_bound",
    "Hull3DResult", "convex_hull_3d", "convex_hull_3d_mr",
    "hull3d_plan", "hull3d_round_bound",
    "LPResult", "linear_program_mr", "linear_program_nd", "lp_plan",
    "lp_round_bound",
    "convex_hull_oracle", "convex_hull_3d_oracle", "linear_program_oracle",
]
