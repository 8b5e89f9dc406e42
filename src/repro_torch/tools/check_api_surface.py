"""API-surface guard: pinned ``__all__`` lists must match the port's modules.

The counterpart of the JAX package's ``tools/check_api_surface.py``.  It
pins ``repro_torch.core`` (the query surface), ``core.plan``,
``core.recovery``, ``obs`` and ``serve`` — the five surfaces the JAX tool
pins, each EXPECTED set the JAX one plus the port's extras, each extra
with its reason — and ``models`` and ``kernels``.  It fails when an
``__all__`` gains or loses names relative to the EXPECTED sets below, and
when an advertised name does not resolve.  A deliberate change updates
EXPECTED in the same commit.

    python -m repro_torch.tools.check_api_surface     # exit 0 when pinned
"""
import sys

EXPECTED_OBS = frozenset([
    # trace core
    "TraceEvent", "Tracer", "NullTracer", "NULL_TRACER",
    "plan_token", "round_event",
    # metrics registry
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    # exporters
    "write_jsonl", "read_jsonl", "to_chrome_trace", "write_chrome_trace",
    # aggregation
    "summarize", "format_table", "diff_summaries", "format_diff",
    # the port's: what a live tracer records while a batched round program
    # runs (route decisions kept, per-query records dropped, as the JAX
    # package's one jitted vmap drops them without a class of its own)
    "BatchTracer",
])

EXPECTED_SERVE = frozenset([
    # token-level continuous batching (decode slots)
    "ServeEngine", "Request", "ServeConfig",
    # query-level continuous batching over the plan cache
    "DispatchError", "QueryService", "Ticket", "QueueFull", "VirtualClock",
])

EXPECTED_RECOVERY = frozenset([
    # fault injection
    "FaultConfig", "FaultError", "FaultInjector", "FaultInjectingEngine",
    "ShardFailure", "with_faults",
    # round-boundary checkpointing
    "Checkpointer", "plan_digest",
    # recovery driver + elastic resume
    "RecoveryReport", "run_plan_with_recovery", "resume_plan",
    "realign_mailbox", "elastic_engine",
])

EXPECTED_PLAN = frozenset([
    "Plan", "PlanStage", "PlanState", "execute_plan",
    "account_stage", "compute_stage", "custom_stage",
    "entry_stage", "round_stage",
    # the port's: the plans run batch first (a stage sees (B, ...) leaves),
    # so a query is a batch of one and Executable.batch runs the batch
    # program (the JAX batch is jax.vmap of the single-query program)
    "execute_plan_batch", "run_plan", "batch_of_one", "row_of",
])

EXPECTED = frozenset([
    # cost model
    "MRCost", "CostAccum", "RoundStats", "HardwareModel",
    "log_M", "tree_height",
    # mailbox model
    "Mailbox", "ShuffleStats", "make_mailbox", "shuffle",
    "run_round", "run_rounds",
    # engines
    "MREngine", "RoundProgram", "ReferenceEngine", "LocalEngine",
    "ShardedEngine", "get_engine", "default_engine",
    # plan/compile/execute split
    "Plan", "PlanStage", "PlanState", "execute_plan",
    "account_stage", "compute_stage", "custom_stage",
    "entry_stage", "round_stage",
    "BoundedCache", "CacheInfo", "Executable", "compile_plan", "pad_batch",
    "sort_plan", "multisearch_plan", "prefix_plan", "PrefixResult",
    "funnel_write_plan", "bsp_plan", "BSPResult",
    "hull2d_plan", "hull3d_plan", "lp_plan",
    # prefix sums / random indexing
    "tree_prefix_sum", "prefix_sum_opt", "random_indexing",
    "prefix_cost_bound", "max_leaf_occupancy",
    # funnels / CRCW simulation
    "funnel_write", "funnel_read", "funnel_read_accum",
    "scatter_combine_opt", "FunnelResult",
    "PRAMProgram", "simulate_crcw",
    # multisearch
    "multisearch", "multisearch_mr", "multisearch_opt",
    "brute_force_multisearch", "MultisearchResult", "EngineSearchResult",
    # sorting
    "brute_force_sort", "sample_sort", "sample_sort_mr", "sort_opt",
    "quantile_splitters", "EngineSortResult",
    # BSP / queues
    "BSPProgram", "run_bsp",
    "QueueState", "make_queues", "enqueue", "dequeue", "run_queued",
    # geometry
    "EngineHullResult", "Hull3DResult", "LPResult",
    "convex_hull_2d", "convex_hull_2d_mr", "convex_hull_3d",
    "convex_hull_3d_mr", "convex_hull_3d_oracle",
    "hull_round_bound", "hull3d_round_bound",
    "linear_program_mr", "linear_program_nd", "linear_program_oracle",
    "lp_round_bound",
    "convex_hull_oracle",
    # the port's: an empty mailbox shaped like another
    "empty_like",
    # the port's: the sort's (rounds, communication) bound and the
    # escalating sort, which the JAX package keeps in repro.core.sortmr
    "sort_cost_bound", "sort_plan_escalating",
])

EXPECTED_MODELS = frozenset([
    # the family modules and their decode states (the JAX package exports
    # Model and build_model and no __all__; its Model of pure functions is
    # the port's nn.Module)
    "DecoderLM", "HybridLM", "RWKVLM", "EncDecLM", "KVDecodeState",
    "HybridDecodeState", "RWKVDecodeState", "EncDecState", "MoEOut",
    # the builders, the JAX package's names
    "build_model", "build_decoder_lm", "build_hybrid_lm", "build_rwkv_lm",
    "build_encdec",
    # the params nest of a config, and the class that serves it
    "init_params", "model_class",
    # the expert group an MoE layer routes over
    "use_expert_group", "expert_group",
])

EXPECTED_KERNELS = frozenset([
    # the JAX package's names; here the five kernel names are the kernel
    # modules, whose functions are ops.<name> and <module>.<name>
    "bincount", "bincount_tiles", "bitonic_sort", "flash_attention",
    "prefix_scan", "ssm_scan", "ops", "ref",
    # the port's: the 2-D hull's chain kernel (no Pallas counterpart)
    "chain",
])


def check_surface(module, expected) -> int:
    actual = set(module.__all__)
    missing = sorted(expected - actual)
    unexpected = sorted(actual - expected)
    broken = sorted(n for n in actual if not hasattr(module, n))
    mod = module.__name__
    for name in missing:
        print(f"{mod}.__all__ lost: {name}", file=sys.stderr)
    for name in unexpected:
        print(f"{mod}.__all__ gained (update "
              f"repro_torch/tools/check_api_surface.py if deliberate): "
              f"{name}", file=sys.stderr)
    for name in broken:
        print(f"{mod}.__all__ advertises unresolvable name: {name}",
              file=sys.stderr)
    ok = not (missing or unexpected or broken)
    print(f"check_api_surface: {mod} {len(actual)} names, "
          f"{'OK' if ok else 'DRIFT DETECTED'}")
    return 0 if ok else 1


def main() -> int:
    import repro_torch.core
    import repro_torch.core.plan
    import repro_torch.core.recovery
    import repro_torch.kernels
    import repro_torch.models
    import repro_torch.obs
    import repro_torch.serve

    rc = check_surface(repro_torch.core, EXPECTED)
    rc |= check_surface(repro_torch.core.plan, EXPECTED_PLAN)
    rc |= check_surface(repro_torch.core.recovery, EXPECTED_RECOVERY)
    rc |= check_surface(repro_torch.obs, EXPECTED_OBS)
    rc |= check_surface(repro_torch.serve, EXPECTED_SERVE)
    rc |= check_surface(repro_torch.models, EXPECTED_MODELS)
    rc |= check_surface(repro_torch.kernels, EXPECTED_KERNELS)
    return rc


if __name__ == "__main__":
    sys.exit(main())
