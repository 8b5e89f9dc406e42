"""The paper's round machine in PyTorch: cost model, mailboxes and the
Shuffle, the engines, plans and the §4.3 sample sort.

``LocalEngine`` runs on the card unless given ``device="cpu"``; with
``shuffle_impl="kernel"`` (``get_engine("kernel")``) its Shuffle runs the
hand-written CUDA kernels of :mod:`repro_torch.kernels`."""

from .costmodel import CostAccum, MRCost, RoundStats, log_M, tree_height
from .mrmodel import (Mailbox, ShuffleStats, empty_like, make_mailbox,
                      run_round, run_rounds, shuffle)
from .engine import (LocalEngine, MREngine, ReferenceEngine, RoundProgram,
                     default_engine, get_engine)
from .plan import (Plan, PlanStage, PlanState, account_stage, compute_stage,
                   custom_stage, entry_stage, execute_plan, round_stage)
from .api import (BoundedCache, CacheInfo, Executable, compile_plan,
                  pad_batch, sort_plan)
from .sortmr import (EngineSortResult, brute_force_sort, quantile_splitters,
                     sample_sort_mr, sort_cost_bound, sort_opt,
                     sort_plan_escalating)

__all__ = [
    "CostAccum", "MRCost", "RoundStats", "log_M", "tree_height",
    "Mailbox", "ShuffleStats", "empty_like", "make_mailbox", "run_round",
    "run_rounds", "shuffle",
    "LocalEngine", "MREngine", "ReferenceEngine", "RoundProgram",
    "default_engine", "get_engine",
    "Plan", "PlanStage", "PlanState", "account_stage", "compute_stage",
    "custom_stage", "entry_stage", "execute_plan", "round_stage",
    "BoundedCache", "CacheInfo", "Executable", "compile_plan", "pad_batch",
    "sort_plan",
    "EngineSortResult", "brute_force_sort", "quantile_splitters",
    "sample_sort_mr", "sort_cost_bound", "sort_opt", "sort_plan_escalating",
]
