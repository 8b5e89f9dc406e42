"""The paper's round machine in PyTorch: cost model, mailboxes and the
Shuffle, the engines, plans, and the paper's sorting, searching,
simulation and geometry algorithms (§2.1 prefix sums, §3.1 BSP, §3.2
funnels and CRCW, §4.1 multisearch, §4.2 queues, §4.3 sample sort, §1.4
2-D and 3-D convex hulls and fixed-dimensional LP).

``LocalEngine`` runs on the card unless given ``device="cpu"``; with
``shuffle_impl="kernel"`` (``get_engine("kernel")``) its Shuffle runs the
hand-written CUDA kernels of :mod:`repro_torch.kernels`.

``ShardedEngine`` runs the Shuffle across the ranks of a
``torch.distributed`` group the caller has started, with the collectives
of :mod:`repro_torch.core.distributed`.

The names match the JAX package's ``repro.core``; ``HardwareModel`` holds
one H100's figures (:mod:`.costmodel`)."""

from .costmodel import (CostAccum, HardwareModel, MRCost, RoundStats, log_M,
                        tree_height)
from .mrmodel import (Mailbox, ShuffleStats, empty_like, make_mailbox,
                      run_round, run_rounds, shuffle)
from .engine import (LocalEngine, MREngine, ReferenceEngine, RoundProgram,
                     ShardedEngine, default_engine, get_engine)
from .plan import (Plan, PlanStage, PlanState, account_stage, compute_stage,
                   custom_stage, entry_stage, execute_plan, round_stage)
from .api import (BoundedCache, CacheInfo, Executable, compile_plan,
                  pad_batch, sort_plan, multisearch_plan, prefix_plan,
                  PrefixResult, funnel_write_plan, bsp_plan, BSPResult,
                  hull2d_plan, hull3d_plan, lp_plan)
from .prefix import (tree_prefix_sum, prefix_sum_opt, random_indexing,
                     prefix_cost_bound, max_leaf_occupancy)
from .funnel import (funnel_write, funnel_read, funnel_read_accum,
                     scatter_combine_opt, FunnelResult, PRAMProgram,
                     simulate_crcw)
from .multisearch import (multisearch, multisearch_mr, multisearch_opt,
                          brute_force_multisearch, MultisearchResult,
                          EngineSearchResult)
from .sortmr import (EngineSortResult, brute_force_sort, quantile_splitters,
                     sample_sort, sample_sort_mr, sort_cost_bound, sort_opt,
                     sort_plan_escalating)
from .bsp import BSPProgram, run_bsp
from .queues import QueueState, make_queues, enqueue, dequeue, run_queued
from .geometry import (EngineHullResult, Hull3DResult, LPResult,
                       convex_hull_2d, convex_hull_2d_mr, convex_hull_3d,
                       convex_hull_3d_mr, convex_hull_3d_oracle,
                       convex_hull_oracle, hull3d_round_bound,
                       hull_round_bound, linear_program_mr,
                       linear_program_nd, linear_program_oracle,
                       lp_round_bound)

__all__ = [
    "CostAccum", "HardwareModel", "MRCost", "RoundStats", "log_M",
    "tree_height",
    "Mailbox", "ShuffleStats", "empty_like", "make_mailbox", "run_round",
    "run_rounds", "shuffle",
    "LocalEngine", "MREngine", "ReferenceEngine", "RoundProgram",
    "ShardedEngine", "default_engine", "get_engine",
    "Plan", "PlanStage", "PlanState", "account_stage", "compute_stage",
    "custom_stage", "entry_stage", "execute_plan", "round_stage",
    "BoundedCache", "CacheInfo", "Executable", "compile_plan", "pad_batch",
    "sort_plan", "multisearch_plan", "prefix_plan", "PrefixResult",
    "funnel_write_plan", "bsp_plan", "BSPResult",
    "hull2d_plan", "hull3d_plan", "lp_plan",
    "tree_prefix_sum", "prefix_sum_opt", "random_indexing",
    "prefix_cost_bound", "max_leaf_occupancy",
    "funnel_write", "funnel_read", "funnel_read_accum",
    "scatter_combine_opt", "FunnelResult", "PRAMProgram", "simulate_crcw",
    "multisearch", "multisearch_mr", "multisearch_opt",
    "brute_force_multisearch", "MultisearchResult", "EngineSearchResult",
    "EngineSortResult", "brute_force_sort", "quantile_splitters",
    "sample_sort", "sample_sort_mr", "sort_cost_bound", "sort_opt",
    "sort_plan_escalating",
    "BSPProgram", "run_bsp",
    "QueueState", "make_queues", "enqueue", "dequeue", "run_queued",
    "EngineHullResult", "Hull3DResult", "LPResult",
    "convex_hull_2d", "convex_hull_2d_mr", "convex_hull_3d",
    "convex_hull_3d_mr", "convex_hull_3d_oracle", "convex_hull_oracle",
    "hull3d_round_bound", "hull_round_bound", "linear_program_mr",
    "linear_program_nd", "linear_program_oracle", "lp_round_bound",
]
