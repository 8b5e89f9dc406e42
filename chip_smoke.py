#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any mismatch raises and the script
exits non-zero:

1. device   — the card, and ``nvidia-smi``'s name and power limit;
2. build    — nvcc builds the kernels from src/repro_torch/kernels/csrc;
              build-kernels: registers, spills and shared memory of the
              kernels redesigned for Hopper (flash_wgmma_kernel,
              bitonic_regs, and the look-back kernels scan_tiles and
              count_groups), from the build log;
3. kernels  — each kernel against its plain PyTorch version, exactly, at
              the main path's shapes and at edge shapes (``bitonic_sort``
              at every width where its mechanism changes, up to 2^18,
              int32 and float32); ``bitonic_sort`` on tie-heavy rows
              (8 key values, both float zeros): keys sorted, (key, value)
              pairs unchanged; ``bincount_tiles`` at T = 1, G and G + 1
              where its group size G changes with V, both sides of its
              route boundary, and on ids all outside [0, V), whole tiles of
              one bucket and the two mixed, each call on its route; with a
              batch axis (B, T, tile_n) at a sort query's tiles with B 4, a
              group size that does not divide T and the global route, one
              launch each, each query's tables also equal to its own
              launch; what the network gives on tied, ``+inf`` and NaN
              keys, recorded;
4. shuffle  — the kernel shuffle against the dense shuffle at both calls of
              a main-path query: mailbox, validity and RoundStats identical;
5. main     — the §4.3 sample sort of n = 2^24 float32 keys at M = 8192
              through LocalEngine(shuffle_impl="kernel"): values equal
              torch.sort, no drops, CostAccum equal to the dense engine fed
              the same sample, every shuffle routed to the kernels, and both
              kernels launched, every ``bincount_tiles`` launch on its
              single-pass route; then a levels=2 query;
5b. batch-* — every plan family's ``exe.batch(B)`` on the kernel engine
              at this script's main sizes: B 4 for the sort of 2^24 keys,
              the search, the physical prefix of 2^24 (inclusive and
              exclusive), the bsp bucket sort of 2^23 keys and the 2-D hull
              of 2^24 points, B 2 for the funnel, the 3-D hull and the LP
              (below).  Each row of every output and stats field equals
              its single call, with no drops (the sort and the 2-D hull,
              whose entry capacity holds with high probability, record
              their drops and hold each row that does not drop to its
              answer); the launch counts and route
              log, set to 0 just before and read just after, equal one
              single query's (the batch is one program: one
              ``bincount_tiles`` and one ``bitonic_sort`` a round, the 2-D
              hull's ``monotone_chain`` once a chaining round), every
              shuffle on the kernels; host-clock medians of 5 (3 for the
              funnel, 3-D hull and LP) of the batch against B single
              calls in a row; the sort's and the 2-D
              hull's batch and single calls once each under torch.profiler;
6. timings  — CUDA-event medians of each kernel, its plain version and its
              library yardstick at the main path's inputs, beside the
              bound, per call; ``bincount_tiles`` also on tiles whose ids
              all name one bucket (every shared-memory atomic of a warp on
              one word) and on four sort queries' entry tiles in one
              launch, (4, 4096, 4096); and host-clock medians of whole sort
              queries;
7. lm-kernels — ``flash_attention`` against its plain version at TinyLlama's
              prefill shape (b 8, hq 32, hkv 4, s 2048, d 64, causal) in
              bfloat16 and float32, at the edge shapes of
              tests/test_kernels.py, at lengths off the wgmma tiles, every
              head dim, and d 128 causal at s 2048, within 2e-4 (f32) and
              2e-2 (bf16); the main paths' bf16 launches must all take the
              wgmma route;
8. lm-prefill — the dense serving path at TinyLlama-1.1B's full width and
              depth, params from a seeded generator: prefill of 8 prompts of
              2048 tokens (22 kernel launches), 32 greedy decode steps, then
              the ServeEngine draining 16 requests of 16 new tokens (cut
              from 32 for time; phase lm-serve); with the
              launch counts reset just before and read just after.  Then
              float32 prefill against token-by-token decode, and the bf16
              flash path against the plain attention path;
8b. lm-mesh — the same model served through ``MeshServe`` on a (1, 1, 1)
              NCCL mesh, parameters and decode state as the per-rank dry
              run lays them out: a prefill of the same prompts and 8 greedy
              decode steps give phase lm-prefill's tokens bit for bit, one
              flash launch a layer; then the dry run's counter over the
              mesh prefill (8 x 2048) and one decode step (a cache of 2080)
              on the card, held in phase roofline;
9. lm-timings — host-clock medians of prefill, a decode step and a serve
              drain; CUDA-event medians of flash_attention, its plain version
              and torch's SDPA at the prefill shape, beside the bound; then
              a prefill and 5 decode steps under torch.profiler (device time
              by kernel, launches, the device's busy share), and the decode
              step timed again after the profiler;
10. ssm-kernels — ``ssm_scan`` against its plain version at the zamba2 and
              RWKV6 prefill shapes and the edge shapes of
              tests/test_kernels.py, within 2e-4; ``prefix_scan`` (int32
              exactly; float32 against a float64 cumsum, within twice
              ``torch.cumsum``'s own error) and ``bincount`` (exactly) at
              the sort's shapes and the awkward ones; ``prefix_scan`` also
              across its look-back (a tile of 4096 less one, one, and one
              more; row tails 4 k + 1, 2, 3; a row of 4096 tiles) and on a
              float32 row of magnitudes 1e-6 .. 1e6, and each float32 main
              shape 5 times, the elements that differ between runs
              recorded; then one call of ``ops.prefix_scan`` and
              ``ops.bincount`` each, their main path;
11. hybrid-flash / hybrid-serve / hybrid-prefill — ``flash_attention``
              against its plain version at the shared block's prefill shape
              (b 8, hq 32, hkv 32, s 2048, d 64, causal), bf16 and float32,
              and timed there; then zamba2-1.2b at full width and depth
              (bf16 compute, ``attn_impl="flash"``): prefill of 8 x 2048
              tokens (38 ``ssm_scan`` and 7 ``flash_attention`` launches),
              32 greedy decode steps and a 16-request ServeEngine drain
              (none), launch counts reset just before and read just after;
              then float32 prefill of 8 x 64 tokens against 64 decode
              steps, logits and every state field within 2e-3, and layer
              0's block the same over 2 chunks + 1 token; the whole model
              over that length through the kernel against its plain
              version within 2e-4 (its drift from decode recorded by
              layer); the bf16 prefill against the same prefill with
              ``ssm_scan``'s plain version, as TinyLlama's flash path is
              held; then
              host-clock timings, a profiled prefill and a profiled
              window of 5 decode steps;
12. rwkv-serve / rwkv-prefill — the same for rwkv6-1.6b (24 ``ssm_scan``
              launches per prefill, no attention);
13. ssm-timings — CUDA-event medians of ``ssm_scan``, ``prefix_scan`` and
              ``bincount``, their plain versions and yardsticks, beside the
              bound, one row per shape, and the two models' timings and
              profiles;
13b. vlm-* / encdec-* / kimi-* / scout-* — before ssm-timings, the
              families the JAX package's other model modules hold, bf16
              compute, ``attn_impl="flash"``, launch counts reset just
              before and read just after each main path; first
              (<tag>-flash) the flash kernel against its plain version at
              the shapes each model's prefill gives it; internvl2-2b at
              full size (prefill of 8 x (256 patches + 1792 tokens), 32
              decode steps, a 16-request text drain; 24 launches), and
              whisper-base (8 x 1500 frames, a 32-token prompt, 32 decode
              steps; 18 launches: encoder, causal, cross), each bf16 flash
              and plain-attention prefill against the float32 plain model
              as TinyLlama's, whisper's float32 prefill against decode
              within 2e-3; kimi-k2 (1 of 61 layers) and llama4-scout
              (``moe_depth``: the deepest leaving 15 GB free) at full
              width: prefill 8 x 2048, 32 decode steps, a drain, layer 0's
              dropped fraction at prefill and decode, peak memory, the
              MoE layer in bf16 against a float32 loop over its experts
              with the same routes (and what the check reads on planted
              faults, each of which must fail it), the flash against the
              plain-attention model (routes that differ at 2048 tokens;
              logits on rows whose routes all agree, one at least, at 4
              tokens with a capacity that holds every choice), and
              (<tag>-shuffle) the ``shuffle`` dispatch
              over a one-rank NCCL expert group against the einsum one;
              moe-gloo: the dispatch on 2 gloo CPU ranks (host work
              started after phase build at the lowest CPU priority,
              joined here);
              families-timings: host-clock timings and a profiled prefill
              of each;
14. search  — ``multisearch_plan(65,536 queries, 1,024 pivots, M 64)``
              (its steady rounds shuffle 1060 nodes x 65,536 slots);
15. prefix-inclusive / prefix-exclusive — the physical
              ``prefix_plan(2^24, 16,384)``, int32;
16. funnel / crcw — ``funnel_write_plan(P 2^22, N 8, M 32,768, add)``,
              int32, 1/16 of the processors silent, with the host time of
              each level's slot fold; then ``simulate_crcw`` of a two-step
              parallel max at the same P, N and M;
17. bsp     — a two-superstep bucket sort of 2^23 float32 keys on 2048
              processors at M 8192 through ``bsp_plan``;
    Each of 14-17 runs on the kernel engine with the launch counts and the
              route log set to 0 just before and read just after (every
              shuffle on the kernels, each kernel once a shuffle, every
              ``bincount_tiles`` launch single-pass), then on the dense
              engine with the same draw: outputs and CostAccum equal, and
              the outputs equal a library answer (``torch.searchsorted``,
              ``torch.cumsum``, ``index_add_``, the max, ``torch.sort``);
18. queues  — 2^22 items into 2048 FIFO rings of 16,384 (one queue 4
              times the mean), drained by ``run_queued`` at M 2048 with a
              one-hop forwarding f; the order in which each queue absorbs
              equals a stable-sort answer; no kernel launches;
19. search-timings — host-clock medians of 5 of each query of 14-17 on
              the kernel engine, the dense engine and its library answer,
              with its launches and the CUDA-event medians of its kernels;
20. hull2d  — ``hull2d_plan(2^24, 8192)`` on standard-normal float32
              points (V 2048: the entry, merge-0 into one node, the
              finalize; ``monotone_chain`` once in each of the last two):
              output and CostAccum equal to the dense engine's, and the
              hull equal to ``scipy.spatial.ConvexHull``'s vertex set and,
              on the card in float64, strictly convex, CCW from the
              lex-min, made of input points and holding every input point;
21. geometry-chain — ``monotone_chain``'s CUDA-event ms at both calls of
              the query beside its bound, one call per event pair and back
              to back; then against its plain version (run on host copies),
              bit for bit, on 16 of merge-0's 2048 runs, the finalize's run,
              a run of 32,768 points that are all extreme, a chain deeper
              than the kernel's shared-memory window that one point pops to
              the bottom, and near-collinear runs (y = x / 3 in float32,
              some moved by an ulp); each call's serial floor (the turn
              tests of its longest chain, counted on the host, times 20
              cycles at the highest SM clock); last 2^20 points all
              extreme (``repro_torch.testing.extreme_run``), timed and
              checked without the plain version: every point kept, the hull
              equal to the run;
22. hull3d / lp — ``hull3d_plan(128, 8192)`` (C(128, 3) facet processors,
              three CRCW steps) against ``ConvexHull(points).vertices`` and
              ``convex_hull_3d_oracle``; ``lp_plan(256, 3, 8192)`` against
              ``scipy.optimize.linprog(method="highs")`` within 1e-4
              relative; each on the kernel engine (every shuffle on the
              kernels, counts set to 0 just before and read just after)
              and the dense engine: outputs and CostAccum equal; the
              geometry phase sets true float32 matmuls itself;
23. geometry-timings — host-clock medians of 5 of each geometry query on
              the kernel and the dense engine and of scipy's answer (the
              2-D hull's scipy call once), with launches, and
              ``monotone_chain``'s CUDA-event ms beside its bound.
24. recovery — the sort of 2^24 keys and the 2-D hull of 2^24 points
              through ``run_plan_with_recovery`` on the kernel engine, a
              shard failure injected at the second shuffle attempt (the
              local sort, merge-0) and recovered from checkpoints taken
              after every stage (the sort with synchronous and with
              asynchronous writes); the sort killed there and resumed on
              the dense engine from its newest checkpoint: outputs and
              CostAccum equal the fault-free run bit for bit, the launches
              of each run (the replay included), the bytes of each
              checkpoint, host ms of the fault-free and recovered sorts;
25. obs     — the same two queries under a recording ``Tracer`` on the
              kernel engine: the measured schedule equals the declared
              one, outputs and CostAccum equal the untraced query, the
              trace round-trips through JSON-lines and the Chrome trace;
              host ms per stage and traced against untraced query ms (the
              untraced sort within the noise of phase sort-timings);
26. query-service — the JAX package's observability demo on the card
              (48 queries, shard failures at attempts 3 and 11, max_batch
              4, Poisson arrivals at 800 qps on a virtual clock), traced
              and untraced, against ``run_sequential`` on the dense
              engine; a closed loop of the default traffic (192 queries,
              max_batch 16) on the wall clock; a device-bound mix (sort
              and 2-D hull of 2^22 at M 8192, multisearch of 65,536
              queries over 1,024 pivots at M 64; 32 queries, max_batch 4),
              each result equal to the sequential one, its launches
              counted (one shuffle a round for each batched dispatch); the
              service's queries/s beside sequential calls' for both;
26b. sharded — the sort of 2^24 keys, the 2-D hull of 2^24 points and
              the multisearch of 14 on ``ShardedEngine(shuffle_impl=
              "kernel")`` over a one-rank NCCL group this phase starts and
              destroys (a ``file://`` store in a temporary directory),
              overlapped and with ``overlap=False``, each against the
              kernel ``LocalEngine``: outputs and CostAccum equal bit for
              bit, no drops, launch counts and route logs set to 0 just
              before and read just after each run (every shuffle on the
              kernels, the launches of each query equal to the local
              engine's, the overlapped engine's rounds counted in
              ``route_log.overlapped``), host-clock medians of 5 of the
              three engines beside ``nvidia-smi``'s line, and one run of
              the local and the overlapped engine under torch.profiler
              (device ms and the costliest kernels); then
              sharded-gloo, host work started after phase build at the
              lowest CPU priority and joined here: ``python -m
              repro_torch.dist_check --world 4 --check`` with the round
              machine's cases, four CPU ranks over gloo at the tests'
              small sizes, every case equal on every rank and to the
              port's LocalEngine;
27. train-kernels — ``ssm_scan``'s backward kernel (through its autograd
              Function) against autograd through the plain version, da and
              dx for a seeded dh, at the zamba2 and rwkv6 training shapes
              (8, 16, 262144) and (8, 32, 131072), T = 1, T off the unroll,
              D off the block and bfloat16 inputs, within 2e-4 (float32)
              and 2e-2 (bfloat16); CUDA-event medians of the kernel and of
              the plain backward at the training shapes, beside the bound;
28. train-parity — zamba2-1.2b and rwkv6-1.6b at full width and 2 layers,
              float32 compute, TF32 off, one batch of 8 x 512: the loss and
              every gradient leaf through the kernels against the same
              model under ``plain_ssm_scan()`` (neither kernel launched
              there), loss within 1e-4 relative, each leaf within 1e-3 of
              its largest plain gradient;
29. train   — zamba2-1.2b at full width and depth through the port's
              ``Trainer`` (float32 params, bf16 compute, remat "full",
              AdamW, 8 x 2048 tokens, warmup 2), 8 steps with the launch
              counts reset just before and read just after (76 forward and
              38 backward ``ssm_scan`` launches a step, no flash); losses
              finite and the last below the first; host-clock ms of each
              step, tokens/s, peak device memory, then one more step under
              torch.profiler;
30. train-resume — zamba2-1.2b at full width and 2 layers: 4 steps
              against 2 steps, a checkpoint, a fresh ``Trainer`` resumed
              from it and 2 more, final losses within 1e-5 (checkpoints in
              a temporary directory, deleted afterwards);
31. train-mesh — the parallel-training slices' main path: the first 4
              steps of phase train's zamba2-1.2b run (its schedule of 8;
              cut from 8 steps for time) through the mesh ``Trainer`` on
              a (1, 1, 1) NCCL mesh (at one rank no axis splits a leaf and "model"
              has one rank, so the step is the one-device one with the
              mesh step's bookkeeping: the funnel's copies, the pod hop,
              the update in place; resident parameter and moment bytes
              recorded; the sharded-parameter path is phase
              mesh-paths'), in "auto" (losses equal phase train's within 1e-5
              relative) and "compressed" (the error-feedback int8 pod hop:
              its first 4 losses equal its plain version's within 1e-5
              relative, last loss below the first), launch counts reset
              just before and read just after each (76 + 38 ``ssm_scan`` a
              step, nothing else); step ms, peak memory, the hop's wire
              bytes, and compressed over auto loss at the last step
              (recorded, not held to a bound), beside two readings of its
              cause: the share of each stacked layer's elements that
              quantize to 0 at step 2, under the leaf's one scale and
              under one scale a layer, and the plain compressed step with
              one scale a layer run 4 steps (cut from 8 for time), its
              last loss over auto's at step 4; and one more auto step
              under the dry run's counter, held in phase roofline;
32. mesh-paths — the sharded-parameter code's collectives on the card, on
              a one-rank NCCL mesh: reduced qwen1.5-0.5b and zamba2-1.2b
              (float32, remat "full"), 3 steps, with every leaf that has
              a data dimension forced through ``LeafRef``: gathered (an
              NCCL all-gather) inside each layer's checkpointed function
              and again in its recompute, the gradient reduce-scattered
              into the region sink on autograd's device thread; losses
              within 1e-5 relative and params within 1e-5 (whole tree)
              of the same Trainer without a mesh; then the Megatron pair
              and the vocab-parallel cross-entropy under a checkpoint,
              and the sequence-parallel pair (an all-gather of the
              sequence in, a reduce-scatter out, and back), gradients
              within 1e-5 of those without the collectives;
33. moe-train — the reduced MoE on one NCCL rank: the ``shuffle``
              dispatch's gradients equal the ``einsum`` dispatch's within
              1e-4 (float32, no drops), a planted detached ``all_to_all``
              fails that check; reduced kimi-k2 (both dispatches, equal
              losses) and llama4-scout train 4 steps; then reduced kimi-k2
              (einsum) and llama4-scout (the ``shuffle`` dispatch over the
              mesh's "model" group) through the mesh ``Trainer`` on a
              (1, 1, 1) mesh, losses within 1e-5 of the same model's run
              without a mesh;
34. train-gloo — host work, started at the lowest CPU priority before
              phase train-kernels and run beside phases 27-33 (their
              steps are bound by the card):
              ``dist_check --cases train,elastic-train,pipeline,moe-grad,
              train-sp --check`` at 4 gloo CPU ranks (the mesh trainer on
              (1, 4, 1), (2, 2, 1), (1, 1, 4) and (1, 2, 2), and
              rwkv6-1.6b, whisper-base and internvl2-2b on (1, 2, 2) and
              (1, 1, 4): FSDP-3, Megatron tensor parallelism and MoE over
              the global batch against one device, resident parameter
              bytes; Megatron sequence parallelism on (1, 1, 4) and (1,
              2, 2) for qwen1.5-0.5b, zamba2-1.2b, rwkv6-1.6b, kimi-k2
              and whisper-base against the same layout without it and
              one device, and two planted faults that must fail);
35. families-train — internvl2-2b (8 x (256 patches + 1792 tokens)) and
              whisper-base (8 x 1500 frames, 448 tokens) at full size
              through the mesh ``Trainer``, 8 steps, losses finite and
              falling; internvl2-2b's batch halved only if 8 rows do not
              fit (recorded);
36. roofline — host work started after phase build at the lowest CPU
              priority: the dry run of all 40 (arch x shape) cells on the
              meta device (``repro_torch.launch.dryrun --all``; 8
              ``long_500k`` skips with JAX's reason) and of the two steps
              below; one line a cell of ``launch.roofline``'s terms
              (computed from shapes, not measured).  On the card: one
              ``bincount_tiles`` call on one tile (``HardwareModel``'s
              ``latency_s``); TinyLlama's prefill (8 x 2048) and
              zamba2-1.2b's training step (8 x 2048, the config's two
              microbatches) once under the dry run's counter, FLOPs, bytes
              and kernel calls equal to the dry run's, its peak within 10
              % of ``max_memory_allocated``, the bound beside phases
              lm-timings' and train's ms; the flash kernel at (1, 2, 1,
              32768, 32768, 64, causal) against its plain version; every
              assigned cell that the dry run fits in 80 GB run once at
              full width (seeded random params, inputs and cache, decode
              at the cache's last position), timed beside its bound, its
              peak within 10 % of the dry run's; a cell of
              ``ASSIGNED_CELLS`` over 80 GB is not run and its GB
              printed.  Per rank of a mesh, beside them on the host: the
              per-rank dry run (``--mesh``, a stand-in process group) of
              ``MESH_CELLS`` (kimi-k2 x train_4k on (2, 16, 16), a
              prefill, and decode with the KV heads, the head dimension
              and the sequence split), one line a cell: GB a rank, the
              terms, collective GB and count by op (computed from shapes,
              not measured); the ``--seq-shard`` records of
              ``MESH_SP_CELLS`` (tinyllama x train_4k and prefill_32k on
              (1, 16, 16), kimi-k2 x train_4k on (2, 16, 16)) beside the
              plain ones, GB a rank (and before the optimizer's update)
              and collective GB by op, each keeping less a rank
              (``roofline-mesh-sp``); and the (1, 1, 1) per-rank dry
              runs of phase train-mesh's step and phase lm-mesh's
              prefill and decode step, their FLOPs, bytes, kernel calls
              and (zero) collectives equal to the counts on the card.

The last three lines are the kernels summary, the ``nvidia-smi`` name and
power line, and ``{"ok": true, "device": {...}}``.  Every row of the
summary gives ``ms`` (one call per event pair) and ``b2b_ms`` (20 calls
between one event pair, over the calls, so that the host's gap before a
call drops out).  The summary's
``flash_attention`` row also gives its launches by route and by serving
path (one prefill of each model), the float32
route's time beside that route's bound and SDPA's float32 time, and the
``bincount_tiles`` and ``bitonic_sort`` rows their launches by path (the
sort, the batch-* runs, search, prefix, funnel, crcw, bsp, hull2d, hull3d
and lp runs, the recovery, obs and query-service runs, and the sharded
engine's sort, hull2d and multisearch; ``monotone_chain``'s row too).
``monotone_chain``'s row sums the kernel, its plain version (one call on
host copies: the slot loop takes seconds) and the bound over the checked
main-path inputs (16 of merge-0's runs, the finalize's run), with their
serial floor (``serial_floor_ms``), and gives the kernel's time at the
query's own two calls as ``main_path_ms`` (``main_path_b2b_ms``) and at
2^20 extreme points as ``worst_case_ms``.  The
``ssm_scan`` row's launches add the training paths' forward launches
(phases train and train-mesh) to the serving prefills'
(``launches_by_path``), and ``ssm_scan.bwd`` is the backward kernel's
row: its launches on the main path, phase train-mesh's auto run (phase
train's beside them), its times and bound
summed over the two training shapes.  A kernel's times and
bound in the summary are sums over one call at each main-path shape: the
two calls of a sort query, TinyLlama's and the hybrid's prefill attention,
the two ``ssm_scan`` and ``prefix_scan`` shapes; the sort's, ``ssm_scan``'s,
``prefix_scan``'s and ``bincount``'s rows also list each call
(``per_call``).  Without CUDA, or without
the rest of the repository beside it, the script fails before any result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()
N_MAIN = 1 << 24          # keys sorted by a main-path query
M_MAIN = 8192             # reducer I/O bound: V = 2048 reducers
SEEDS = (101, 202, 303)
REPS = 7
LM_ARCH = "tinyllama-1.1b"
LM_B, LM_S, LM_DECODE = 8, 2048, 32       # prefill batch and length, steps
#: new tokens a request of a serve drain (cut from 32 for time)
SERVE_NEW_TOKENS = 16
DECODE_WINDOW = 5                          # decode steps in a profiled window
#: flash_attention shapes (b, hq, hkv, s_q, s_k, d, causal): TinyLlama's
#: prefill, then the edge shapes of tests/test_kernels.py, one query
#: against a 512-key cache, lengths off the wgmma kernel's tiles (128
#: queries, 64 keys) at d 64 and 128, every head dim causal and ragged,
#: d 128 causal at s 2048, the padded head dims 16 (reduced configs)
#: and 112 (kimi-k2), and whisper-base's encoder (bidirectional over 1500
#: frames) and cross-attention (its 32-token prompt against the frames)
FLASH_MAIN = (LM_B, 32, 4, LM_S, LM_S, 64, True)
FLASH_EDGE = ((2, 4, 2, 128, 128, 64, True), (1, 2, 2, 200, 200, 32, False),
              (1, 8, 2, 256, 256, 64, True), (1, 2, 1, 100, 100, 48, True),
              (2, 4, 4, 64, 64, 128, False), (2, 4, 4, 1, 512, 64, False),
              (1, 4, 2, 300, 300, 128, True), (2, 4, 4, 200, 200, 64, False),
              (1, 2, 2, 77, 333, 128, False), (1, 4, 1, 129, 129, 32, True),
              (1, 4, 4, 65, 65, 48, False), (2, 16, 4, LM_S, LM_S, 128, True),
              (1, 4, 2, 100, 100, 16, True), (2, 8, 2, 300, 300, 112, True),
              (8, 8, 8, 1500, 1500, 64, False), (8, 8, 8, 32, 1500, 64, False))
#: bitonic_sort row widths that cross the kernel's mechanisms: one block
#: of 4096 elements holding many rows, the register chunks (16), the lane
#: and warp bits of a layout, a row per block (4096 to 16384), and the
#: global stages above 16384 up to the 2^18 contract
BITONIC_WIDTHS = (1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513, 4095, 4096,
                  4097, 16384, 16385, 1 << 18)
#: the sub-quadratic LMs: (arch, phase tag)
SSM_ARCHS = (("zamba2-1.2b", "hybrid"), ("rwkv6-1.6b", "rwkv"))
#: ssm_scan (b, t, d) of one prefill call: zamba2-1.2b (2048 / 128 chunks,
#: 64 heads x 64 x 64 channels), rwkv6-1.6b (2048 / 64 chunks, 32 x 64 x
#: 64); then the edge shapes of tests/test_kernels.py
SSM_MAIN = ((LM_B, 16, 262144), (LM_B, 32, 131072))
SSM_EDGE = ((2, 100, 16), (1, 513, 8), (3, 64, 32), (1, 16, 4))
#: prefix_scan (rows, n, dtype, exclusive): the local-sort count scan
#: (V rows x T tiles), a long float32 scan; then the awkward shapes of
#: tests/test_kernels.py in both dtypes and both modes
SCAN_MAIN = ((2048, 12288, "int32", True), (16, 1 << 20, "float32", False))
SCAN_EDGE = tuple((r, n, dt, ex) for r, n in ((2, 0), (1, 1), (3, 13),
                                             (2, 700))
                  for dt in ("int32", "float32") for ex in (False, True))
#: bincount_tiles bucket counts where its group size G changes (8 at 2048,
#: 7 at 2049, 1 from 8193), where the histograms fill exactly the 48 KB a
#: block gets without opting in (6144: G 2), and both sides of its route
#: boundary (kSmemBuckets of csrc/bincount_tiles.cu: single pass up to 48 Ki
#: buckets)
BT_EDGE_V = (2048, 2049, 6144, 8192, 8193, 48 * 1024, 48 * 1024 + 1)
#: prefix_scan (rows, n, dtype, exclusive) across its look-back: a tile of
#: 4096 less one, a tile, a tile and one; row tails of 4 k + 1, 2, 3; a row
#: of 4096 tiles (deeper than one warp's window of 32)
SCAN_TILE = 4096
SCAN_LOOKBACK = tuple(
    (r, n, dt, ex)
    for r, n in ((3, SCAN_TILE - 1), (3, SCAN_TILE), (3, SCAN_TILE + 1),
                 (2, 2 * SCAN_TILE + 1), (2, 2 * SCAN_TILE + 2),
                 (2, 2 * SCAN_TILE + 3), (1, SCAN_TILE * SCAN_TILE))
    for dt in ("int32", "float32") for ex in (False, True))
#: float32 runs of each main shape compared bit for bit (the look-back adds
#: in an order that depends on timing)
SCAN_REPEATS = 5
#: bincount (n, n_buckets): the sort's destinations; then the awkward
#: shapes of tests/test_kernels.py, and a histogram above shared memory
BINCOUNT_MAIN = (1 << 24, 2048)
#: batched bincount_tiles (B, T, tile_n, V): a sort query's tiles at B = 4
#: on the single-pass route and, with V above 48 Ki buckets, on the global
#: route; a group size G = 8 that does not divide T; and the global route
#: with two 64-row chunks of its column scan a query
BT_BATCH = ((4, 4096, 4096, 2048), (4, 4096, 4096, 1 << 16),
            (4, 13, 1024, 2048), (4, 70, 16, 1 << 16))
BINCOUNT_EDGE = ((0, 8), (13, 64), (31, 5), (6, 100), (1 << 20, 100000))
#: the searching and simulation paths, each on the kernel engine beside the
#: dense one: multisearch_plan(queries, pivots, M) (f 32, L 2, K 3, V 1060;
#: its steady rounds shuffle 1060 x 65,536 slots); prefix_plan(n, M,
#: physical=True) (d 8192: 2048 leaf-parents, then the root); the write
#: funnel (P, N, M) (d 16,384: level 0 is 2048 nodes x 16,384 slots, level
#: 1 8 nodes); the BSP bucket sort (processors, M, keys: 4096 a processor);
#: the FIFO queues (items, queues, ring capacity, M), no shuffle
SEARCH = (65_536, 1_024, 64)
PREFIX = (1 << 24, 16_384)
FUNNEL = (1 << 22, 8, 32_768)
BSP = (2_048, 8_192, 1 << 23)
QUEUES = (1 << 22, 2_048, 16_384, 2_048)
#: the hot queue's share: 4 times the mean
QUEUE_SKEW = 4
#: the geometry, each on the kernel engine beside the dense one, inputs from
#: numpy's generator: hull2d_plan(n, M) on standard-normal points (V 2048,
#: cap0 24,576, arity 4096: the entry, merge-0 into one node of 2^24 slots,
#: the finalize; monotone_chain runs in merge-0 and the finalize);
#: hull3d_plan(n, M) (P = C(128, 3) = 341,376 triples, write funnels of
#: d 4096 and L 2: level 0 is 84 x 128 = 10,752 nodes x 4096 slots; at
#: n 256 level 0 would have 172,800 nodes and go dense); lp_plan(n, d, M)
#: (C(256, 3) = 2,763,520 bases, min-funnel level 0 675 nodes x 4096)
HULL2D = (1 << 24, 8192)
HULL3D = (128, 8192)
LP = (256, 3, 8192)
LP_C = (1.0, -0.5, 0.25)
#: merge-0 runs the monotone_chain check holds against the plain version,
#: and the points of a run whose every point is extreme: x = sinh(t),
#: y = x^2 for t evenly spaced in [-20, 20], strictly convex in float32
#: (cut from 65,536 to keep the script within its time limit: the plain
#: version's slot loop on the host takes 0.4 ms a point)
CHAIN_CHECKED = 16
CHAIN_EXTREME = 32_768
#: the worst case of a chain call, timed and checked without the plain
#: version: 2^20 points that are all extreme in float32
#: (repro_torch.testing.extreme_run: x = sinh t stops being convex in
#: float32 above 2^16 points)
CHAIN_WORST = 1 << 20
#: near-collinear runs (y = x / 3 in float32, a quarter moved by an ulp):
#: runs x points, held to the plain version on host copies
CHAIN_NEAR_COLLINEAR = (4, 6000)
#: the dependent latency of one test-and-pop step of the chain, in SM
#: cycles, from SASS latencies: the FADD, FMUL, FFMA and FSETP of the turn
#: test and the branch on it, one after another, taken at 4 cycles each
#: (the FP32 pipeline's latency between dependent instructions; a branch
#: takes longer, so the floor is low), the register moves of the pop
#: running beside them
CHAIN_STEP_CYCLES = 20
#: calls between one pair of CUDA events for a back-to-back reading
B2B_CALLS = 20
#: the LP optimum against scipy's HiGHS in float64: float32 bases solved
#: and tested in float32 agree to a few float32 ulps of the vertex
LP_RTOL = 1e-4
#: the training slice: zamba2-1.2b trained at full width and depth on
#: batches of (global_batch, seq_len), TRAIN_STEPS steps; the 2-layer
#: kernel-vs-plain gradient check and the resume check
TRAIN_SHAPE = (8, 2048)
TRAIN_STEPS = 8
TRAIN_PARITY = (8, 512)
#: ssm_scan backward (b, t, d, a dtype, x dtype): the zamba2 and rwkv6
#: training shapes (8 x 2048 tokens: 16 chunks of 128, 32 of 64), then
#: T = 1, T off the kernel's unroll of 8, D off its block of 256, and
#: bfloat16 a, x or both
SSM_BWD_MAIN = ((LM_B, 16, 262144, "float32", "float32"),
                (LM_B, 32, 131072, "float32", "float32"))
SSM_BWD_EDGE = ((2, 1, 16, "float32", "float32"),
                (1, 13, 300, "float32", "float32"),
                (2, 100, 300, "float32", "float32"),
                (3, 64, 32, "bfloat16", "float32"),
                (1, 16, 4, "float32", "bfloat16"),
                (2, 33, 300, "bfloat16", "bfloat16"))


def bytes_ms(nbytes) -> float:
    """Milliseconds to move ``nbytes`` at the card's HBM rate
    (``repro_torch.core.costmodel.HBM_BW``, the H100 SXM data sheet)."""
    from repro_torch.core.costmodel import HBM_BW
    return nbytes / HBM_BW * 1e3


def ops_ms(nops, rate=None) -> float:
    """Milliseconds for ``nops`` operations at ``rate`` FLOP/s, by default
    the float32 rate outside the tensor cores
    (``repro_torch.core.costmodel.PEAK_FLOPS_F32``)."""
    from repro_torch.core.costmodel import PEAK_FLOPS_F32
    return nops / (rate or PEAK_FLOPS_F32) * 1e3


def bound_ms(nops, nbytes, rate=None) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over ``rate`` (:func:`ops_ms`)."""
    return max(bytes_ms(nbytes), ops_ms(nops, rate))


def bound_by(nops, nbytes, rate=None) -> str:
    return "bytes" if bytes_ms(nbytes) >= ops_ms(nops, rate) \
        else "operations"


def emit(**rec) -> None:
    """One phase's JSON line, with the script's seconds so far (host
    clock; the time limit bounds the whole script)."""
    rec.setdefault("script_s", round(time.perf_counter() - START, 3))
    print(json.dumps(rec), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str, names) -> list:
    """Registers, spills and static shared memory of each compiled entry
    whose name holds one of ``names``, from nvcc's ``-Xptxas -v`` output."""
    import re
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = next((n for n in names if n in m.group(1)), None)
            if entry:
                # the template arguments: Li<n>E, i (int), f (float)
                mangled = m.group(1).split(entry + "I", 1)[1]
                args = [("int", "float")["if".index(a)] if a else n
                        for n, a in re.findall(r"Li(\d+)E|^([if])", mangled)]
                rows.append({"kernel": f"{entry}<{','.join(args)}>"})
            continue
        if not entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(m.group(1)),
                            static_smem=int(smem.group(1)) if smem else 0)
            entry = None
    return rows


def event_ms(fn, torch, reps: int = REPS) -> float:
    """Median device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def b2b_ms(fn, torch, calls: int = B2B_CALLS, reps: int = 3) -> float:
    """Device ms of one call of fn() run back to back: ``calls`` calls
    between one pair of CUDA events, divided by ``calls`` (median of
    ``reps``), after a warm-up.  Unlike event_ms, the host's gap before a
    call hides behind the calls in flight."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def host_times(fn, torch, reps: int = 5) -> list:
    """Wall times of fn() ending in a synchronize, in ms, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def host_ms(fn, torch, reps: int = 5) -> float:
    """Median wall time of fn() ending in a synchronize, in ms."""
    return statistics.median(host_times(fn, torch, reps))


def profiled(fn, torch, top: int = 10, named=None) -> dict:
    """One run of fn() under torch.profiler: its wall ms, and the device
    time (ms) and count of the kernels it ran, with the costliest ones; and
    for each ``label: part`` of ``named``, the device ms and calls of the
    kernels whose name holds ``part``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU ops that launched them report the
    # same device time again
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    out = {"wall_ms": wall_ms,
           "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
           "launches": sum(e.count for e in kernels),
           "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total
                    / 1e3, "calls": e.count} for e in kernels[:top]]}
    for label, part in (named or {}).items():
        hits = [e for e in kernels if part in e.key]
        out[label] = {"ms": sum(e.self_device_time_total for e in hits) / 1e3,
                      "calls": sum(e.count for e in hits)}
    return out


def serve_requests(gen, vocab_size: int) -> list:
    """16 (uid, prompt) pairs, prompts of 16-64 tokens, from the numpy
    generator ``gen``."""
    return [(uid, gen.integers(0, vocab_size,
                               int(gen.integers(16, 65))).astype("int32"))
            for uid in range(16)]


def serve_drain(model, requests, clock=time.perf_counter):
    """A ServeEngine (max_batch 8, max_len 256) that drained ``requests``,
    SERVE_NEW_TOKENS new tokens each; ``eng.admitted`` holds the order in
    which they left the queue."""
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    eng = ServeEngine(model, ServeConfig(max_batch=8, max_len=256),
                      clock=clock)
    eng.admitted = []
    admit = eng._admit

    def recording_admit():
        waiting = [r.uid for r in eng.queue]
        admit()
        eng.admitted += waiting[:len(waiting) - len(eng.queue)]

    eng._admit = recording_admit
    for uid, p in requests:
        eng.submit(Request(uid=uid, prompt=p,
                           max_new_tokens=SERVE_NEW_TOKENS))
    eng.run_until_drained()
    return eng


def check_drain(eng, n: int) -> dict:
    """Every request finished with SERVE_NEW_TOKENS tokens, at most 8 in a
    round, in FIFO order; returns the engine's stats."""
    st = eng.stats()
    check(st["requests"] == n and len(eng.finished) == n,
          f"serve finished {st['requests']} of {n}")
    check(all(len(r.output) == SERVE_NEW_TOKENS for r in eng.finished),
          "serve outputs")
    check(eng.cost.max_reducer_io <= 8,
          f"max_reducer_io {eng.cost.max_reducer_io} > 8")
    check(eng.admitted == list(range(n)), f"admission {eng.admitted}")
    return st


def lm_host_timings(torch, model, prompt, requests, prefill_reps: int = 5,
                    **prefill_kw):
    """Host-clock timings of a served LM: prefill of ``prompt`` (median of
    ``prefill_reps``; ``prefill_kw`` passed on, the VLM's patch
    embeddings), one decode step against LM_S - 1 cached positions (15
    reps; each step starts from the same state) and a serve drain (the
    middle of three).  Returns them with the prefill and decode closures."""
    def prefill():
        return model.prefill(prompt, max_len=LM_S, **prefill_kw)

    prefill_runs = host_times(prefill, torch, reps=prefill_reps)
    prefill_ms = statistics.median(prefill_runs)
    _, state = model.prefill(prompt[:, :-1], max_len=LM_S, **prefill_kw)
    positions = int(state.pos[0]) + 1
    tok = prompt[:, -1]

    def decode():
        return model.decode_step(tok, state)

    decode_runs = host_times(decode, torch, reps=15)
    drains = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = serve_drain(model, requests).stats()
        torch.cuda.synchronize()
        drains.append((time.perf_counter() - t0, stats))
    drain_s, drain_stats = sorted(drains, key=lambda d: d[0])[1]
    timings = {
        "prefill_ms": prefill_ms, "prefill_ms_runs": prefill_runs,
        "prefill_tokens_per_s": prompt.shape[0] * positions
        / (prefill_ms / 1e3),
        "decode_step_ms": statistics.median(decode_runs),
        "decode_step_ms_runs": decode_runs, "decode_batch": prompt.shape[0],
        "serve_drain_s": drain_s,
        "serve_tokens_per_s": drain_stats["tokens"] / drain_s,
        "serve_mean_ttft_s": drain_stats["mean_ttft_s"],
        "serve_mean_latency_s": drain_stats["mean_latency_s"],
        "serve_rounds": drain_stats["rounds"]}
    return timings, prefill, decode


class Recorder:
    """Stands in for the kernel module of kshuffle or of the 2-D hull's
    chain: records each kernel call's inputs, then forwards to the real
    dispatch."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = []

    def bincount_tiles(self, tiles, n_buckets):
        self.calls.append(("bincount_tiles", tiles, n_buckets))
        return self.ops.bincount_tiles(tiles, n_buckets)

    def bitonic_sort(self, keys, values):
        self.calls.append(("bitonic_sort", keys, values))
        return self.ops.bitonic_sort(keys, values)

    def monotone_chain(self, pts, counts):
        self.calls.append(("monotone_chain", pts, counts))
        return self.ops.monotone_chain(pts, counts)


def rel_close(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol * |want| everywhere (rtol = atol = tol)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def flash_inputs(torch, dev, shape, dtype, seed):
    b, hq, hkv, sq, sk, d, _ = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn(b, hq, sq, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, hkv, sk, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, hkv, sk, d, device=dev, generator=gen).to(dtype)
    return q, k, v


def flash_check(torch, dev, shape, seed: int) -> list:
    """flash_attention against its plain version at ``shape`` in bfloat16
    (within 2e-2) and float32 (within 2e-4); one row per dtype."""
    from repro_torch.kernels import flash_attention as flash
    rows = []
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        q, k, v = flash_inputs(torch, dev, shape, dtype, seed)
        got = flash.flash_attention_cuda(q, k, v, shape[-1])
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k, v, shape[-1])
        check(got.dtype == dtype and got.shape == want.shape,
              f"flash_attention {shape}: {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        check(rel_close(got, want, tol), f"flash_attention {shape} "
              f"{dtype}: max abs err {err} over tolerance {tol}")
        rows.append([*shape[:-1], int(shape[-1]), str(dtype), err])
        del q, k, v, got, want
    return rows


def flash_timing(torch, dev, shape) -> dict:
    """CUDA-event medians of flash_attention (bf16 and f32), its plain
    version and torch's SDPA at a causal ``shape``, beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    q, k, v = flash_inputs(torch, dev, shape, torch.bfloat16, 7)
    kern_ms = event_ms(lambda: flash.flash_attention_cuda(q, k, v, True),
                       torch)
    kern_b2b = b2b_ms(lambda: flash.flash_attention_cuda(q, k, v, True),
                      torch)
    plain_ms = event_ms(lambda: flash.flash_attention_plain(q, k, v, True),
                        torch)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    check(rel_close(flash.flash_attention_cuda(q, k, v, True), sdpa(), 2e-2),
          f"SDPA yardstick disagrees with the kernel at {shape}")
    sdpa_ms = event_ms(sdpa, torch)
    q32, k32, v32 = (a.float() for a in (q, k, v))
    kern32_ms = event_ms(lambda: flash.flash_attention_cuda(q32, k32, v32,
                                                            True), torch)
    sdpa32 = lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True)
    # the float32 yardstick's distance from the kernel, recorded beside
    # its time (the kernel itself is held to its plain version)
    sdpa32_err = (flash.flash_attention_cuda(q32, k32, v32, True)
                  - sdpa32()).abs().max().item()
    sdpa32_ms = event_ms(sdpa32, torch)
    del q32, k32, v32
    from repro_torch.core.costmodel import PEAK_FLOPS_BF16
    b, hq, hkv, s, _, d, _ = shape
    flops, nbytes = flash.flash_attention_work(b, hq, hkv, s, s, d, True,
                                               torch.bfloat16)
    return {"shape": list(shape), "flash_ms": kern_ms,
            "flash_b2b_ms": kern_b2b,
            "flash_f32_ms": kern32_ms, "plain_ms": plain_ms,
            "sdpa_ms": sdpa_ms, "sdpa_f32_ms": sdpa32_ms,
            "sdpa_f32_max_abs_err": sdpa32_err,
            "flops": flops, "bytes": nbytes,
            "bytes_ms": bytes_ms(nbytes),
            "flops_ms_bf16": ops_ms(flops, PEAK_FLOPS_BF16),
            "flops_ms_f32": ops_ms(flops)}


def lm_phases(torch, dev) -> dict:
    """Phases 7-9: the dense serving path of TinyLlama-1.1B.  Returns the
    flash_attention launches, max error and timing at TinyLlama's shape."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM, build_model

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 is float32
    torch.backends.cudnn.allow_tf32 = False

    # -- 7. flash_attention against its plain version -----------------------
    checked = [row for i, shape in enumerate((FLASH_MAIN,) + FLASH_EDGE)
               for row in flash_check(torch, dev, shape, 100 + i)]
    max_abs = max(row[-1] for row in checked)
    emit(phase="lm-kernels", checked=checked, max_abs_err=max_abs,
         columns="b hq hkv s_q s_k d causal dtype max_abs_err")

    # -- 8. the main path: prefill, greedy decode, serve --------------------
    cfg = get_config(LM_ARCH, attn_impl="flash")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    model.compute_params()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    prompt = torch.from_numpy(gen.integers(0, cfg.vocab_size, (LM_B, LM_S))
                              .astype(np.int32)).to(dev)
    requests = serve_requests(gen, cfg.vocab_size)

    ops.reset_launches()
    per_prefill = []
    logits, state = model.prefill(prompt, max_len=LM_S + LM_DECODE)
    torch.cuda.synchronize()
    per_prefill.append(ops.launches()["flash_attention"])
    tokens = [logits.argmax(-1)]
    for _ in range(LM_DECODE):
        logits, state = model.decode_step(tokens[-1], state)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_finite = bool(torch.isfinite(logits.float()).all())
    eng = serve_drain(model, requests)
    torch.cuda.synchronize()
    launches = ops.launches()
    routes = dict(flash.route_launches)
    check(per_prefill == [cfg.n_layers] and
          launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launches {per_prefill}, {launches}: expected "
          f"{cfg.n_layers} per prefill and none in decode")
    check(routes == {"wgmma": cfg.n_layers, "cuda_core": 0},
          f"flash_attention routes {routes}: the bf16 prefill runs wgmma")
    check(launches["bincount_tiles"] == launches["bitonic_sort"] == 0,
          f"sort kernels launched on the LM path: {launches}")
    check(decode_finite, "decode logits not finite")
    check(state.pos.tolist() == [LM_S + LM_DECODE] * LM_B,
          f"decode pos {state.pos.tolist()}")
    st = check_drain(eng, len(requests))
    emit(phase="lm-serve", stats=st, cost=dataclasses.asdict(eng.cost),
         admitted=eng.admitted,
         finished=[r.uid for r in eng.finished][:8])

    # checks: logits finite; f32 prefill equals decode; flash vs plain
    logits, _ = model.prefill(prompt, max_len=LM_S)
    check(bool(torch.isfinite(logits.float()).all()), "prefill logits")
    params = model.param_tree()
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"),
                    params)
    short = prompt[:, :64]
    lp, sp = m32.prefill(short, max_len=64)
    sd = m32.init_decode_state(LM_B, 64)
    for i in range(64):
        ld, sd = m32.decode_step(short[:, i], sd)
    f32_err = (lp - ld).abs().max().item()
    f32_cache_err = (sp.k - sd.k).abs().max().item()
    check(rel_close(ld, lp, 2e-3) and rel_close(sd.k, sp.k, 2e-3),
          f"f32 prefill vs decode: logits {f32_err}, cache {f32_cache_err}")
    del sp, sd
    m_xla = DecoderLM(dataclasses.replace(cfg, attn_impl="xla"), params)
    lx, _ = m_xla.prefill(prompt, max_len=LM_S)
    del m_xla
    m_ref = DecoderLM(dataclasses.replace(cfg, attn_impl="xla",
                                          compute_dtype="float32"), params)
    lr, _ = m_ref.prefill(prompt, max_len=LM_S)
    del m_ref
    torch.cuda.synchronize()
    err_fx = (logits.float() - lx.float()).abs().max().item()
    err_f = (logits.float() - lr).abs().max().item()
    err_x = (lx.float() - lr).abs().max().item()
    rms_f = (logits.float() - lr).pow(2).mean().sqrt().item()
    rms_x = (lx.float() - lr).pow(2).mean().sqrt().item()
    # Both bf16 paths round the same function, which the float32 model
    # computes.  Tolerance: the two may differ by twice the plain path's
    # own bf16 error against the float32 model (max abs over all logits),
    # and the kernel path's rms error may exceed the plain path's by 25 %.
    check(err_fx <= 2 * err_x and rms_f <= 1.25 * rms_x,
          f"bf16 flash vs plain path: max {err_fx} (tolerance {2 * err_x}); "
          f"rms error vs the f32 model {rms_f}, plain {rms_x}")
    emit(phase="lm-prefill", arch=LM_ARCH, batch=LM_B, seq=LM_S,
         decode_steps=LM_DECODE, build_s=build_s,
         launches_per_prefill=per_prefill[0], main_path_launches=launches,
         greedy_tokens_slot0=[int(t[0]) for t in tokens[:8]],
         f32_prefill_vs_decode_max_abs=f32_err,
         f32_cache_max_abs=f32_cache_err,
         bf16_flash_vs_plain_max_abs=err_fx,
         bf16_vs_f32_model={"flash_max": err_f, "plain_max": err_x,
                            "flash_rms": rms_f, "plain_rms": rms_x},
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    del lx, lr, m32

    # -- 9. timings ---------------------------------------------------------
    # Host-clock timings first: a profiler session may leave overhead
    # behind, so the profiled windows come after them, and the decode step
    # is timed again after the windows to show whether it does.
    timings, prefill, decode = lm_host_timings(torch, model, prompt,
                                               requests)
    prefill_ms, decode_ms = timings["prefill_ms"], timings["decode_step_ms"]
    flash_t = flash_timing(torch, dev, FLASH_MAIN)
    prof_prefill = profiled(prefill, torch)
    prof_decode = profiled(lambda: [decode() for _ in range(DECODE_WINDOW)],
                           torch)
    for key in ("wall_ms", "device_ms", "launches"):
        prof_decode[key] /= DECODE_WINDOW
    prof_prefill["busy_share"] = prof_prefill["device_ms"] / prefill_ms
    prof_decode["busy_share"] = prof_decode["device_ms"] / decode_ms
    decode_after = host_times(decode, torch, reps=15)
    emit(phase="lm-timings", arch=LM_ARCH, **timings,
         decode_step_ms_after_profiler=statistics.median(decode_after),
         decode_step_ms_runs_after_profiler=decode_after, **flash_t,
         flash_share_of_prefill=(cfg.n_layers * flash_t["flash_ms"]
                                 / prefill_ms),
         profile={"prefill": prof_prefill, "decode_step": prof_decode,
                  "note": f"torch.profiler, one prefill and a window of "
                          f"{DECODE_WINDOW} decode steps (per step); "
                          f"busy_share = device ms over the unprofiled "
                          f"median wall ms"})
    return {"launches": launches["flash_attention"], "routes": routes,
            "max_abs_err": max_abs, "timing": flash_t,
            "prefill_ms": prefill_ms,
            "tokens": torch.stack(tokens[:MESH_DECODE + 1])}


def scan_input(torch, dev, gen, rows, n, dtype):
    if dtype == "int32":       # full int32 range: the sums wrap
        return torch.randint(-(1 << 30), 1 << 30, (rows, n),
                             dtype=torch.int32, device=dev, generator=gen)
    return torch.randn(rows, n, device=dev, generator=gen)


def ssm_kernel_phase(torch, dev) -> dict:
    """Phase ssm-kernels: ssm_scan, prefix_scan and bincount against their
    plain versions, then one run of prefix_scan's and bincount's entry
    points (their main path).  Returns max errors and launch counts."""
    from repro_torch.kernels import bincount, ops, prefix_scan, ssm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    err = {"ssm_scan": 0.0, "prefix_scan": 0.0, "bincount": 0.0}
    checked = []
    for shape in SSM_MAIN + SSM_EDGE:
        a = 0.5 + 0.5 * torch.rand(shape, device=dev, generator=gen)
        x = torch.randn(shape, device=dev, generator=gen)
        got = ssm_scan.ssm_scan_cuda(a, x)
        torch.cuda.synchronize()
        want = ssm_scan.ssm_scan_plain(a, x)
        check(got.dtype == x.dtype and got.shape == want.shape,
              f"ssm_scan {shape}: {got.dtype} {tuple(got.shape)}")
        e = (got - want).abs().max().item()
        err["ssm_scan"] = max(err["ssm_scan"], e)
        check(rel_close(got, want, 2e-4),
              f"ssm_scan {shape}: max abs err {e} over tolerance 2e-4")
        checked.append(["ssm_scan", *shape, e])
        del a, x, got, want
    # the look-back's shapes and the mixed-magnitude row draw from a
    # generator of their own, so the other checks' inputs stay as they were
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(14)
    mag = 10.0 ** (12 * torch.rand(4, 1 << 18, device=dev, generator=gen_s)
                   - 6)
    sign = torch.randint(0, 2, mag.shape, device=dev, generator=gen_s) * 2 - 1
    mixed = (mag * sign).float()       # magnitudes 1e-6 .. 1e6, both signs
    del mag, sign
    cases = ([(shape, scan_input(torch, dev, gen, *shape[:2], shape[2]))
              for shape in SCAN_MAIN + SCAN_EDGE]
             + [(shape, scan_input(torch, dev, gen_s, *shape[:2], shape[2]))
                for shape in SCAN_LOOKBACK]
             + [((*mixed.shape, "float32", ex), mixed) for ex in (False, True)])
    for (rows, n, dt, ex), x in cases:
        got = prefix_scan.prefix_scan_cuda(x, ex)
        torch.cuda.synchronize()
        want = prefix_scan.prefix_scan_plain(x, ex)
        check(got.dtype == x.dtype and got.shape == x.shape,
              f"prefix_scan {rows, n, dt}: {got.dtype} {tuple(got.shape)}")
        if dt == "int32":
            check(torch.equal(got, want), f"prefix_scan {rows, n, dt, ex}: "
                                          f"differs from the plain version")
            e = 0.0
        else:
            # against a float64 cumsum, within twice torch.cumsum's own
            # float32 error, plus two ulps of the largest prefix
            exact = torch.cumsum(x.double(), -1) - (x.double() if ex else 0)
            e = (got.double() - exact).abs().max().item() if n else 0.0
            own = (want.double() - exact).abs().max().item() if n else 0.0
            floor = 2.0 ** -22 * (exact.abs().max().item() if n else 0.0)
            check(e <= 2 * own + floor, f"prefix_scan {rows, n, dt, ex}: "
                  f"error {e} against float64, cumsum's own {own}")
        err["prefix_scan"] = max(err["prefix_scan"], e)
        checked.append(["prefix_scan", rows, n, dt, ex, e]
                       + ([own] if dt == "float32" else []))
    del cases, mixed
    # float32 run to run: the look-back adds in an order that depends on
    # timing; how many elements differ from the first of SCAN_REPEATS runs
    # (recorded, not held)
    f32_repeats = []
    for rows, n, dt, ex in SCAN_MAIN:
        if dt != "float32":
            continue
        x = scan_input(torch, dev, gen_s, rows, n, dt)
        first = prefix_scan.prefix_scan_cuda(x, ex)
        differ = [int((prefix_scan.prefix_scan_cuda(x, ex) != first).sum())
                  for _ in range(SCAN_REPEATS - 1)]
        f32_repeats.append({"shape": [rows, n, dt, ex], "runs": SCAN_REPEATS,
                            "elements": x.numel(),
                            "differing_from_first": differ})
    all_dropped = torch.tensor([-1] * 20 + [7] * 20, dtype=torch.int32,
                               device=dev)
    for n, V in (BINCOUNT_MAIN,) + BINCOUNT_EDGE + ((0, 7),):
        ids = (torch.randint(-3, V + 3, (n,), dtype=torch.int32, device=dev,
                             generator=gen) if n else all_dropped)
        got = bincount.bincount_cuda(ids, V)
        torch.cuda.synchronize()
        want = bincount.bincount_plain(ids, V)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"bincount {n, V}: differs from the plain version")
        checked.append(["bincount", ids.numel(), V])
    # the entry points as a user calls them
    counts = torch.randint(0, 64, SCAN_MAIN[0][:2], dtype=torch.int32,
                           device=dev, generator=gen)
    xf = torch.randn(SCAN_MAIN[1][:2], device=dev, generator=gen)
    ids = torch.randint(0, BINCOUNT_MAIN[1], (BINCOUNT_MAIN[0],),
                        dtype=torch.int32, device=dev, generator=gen)
    ops.reset_launches()
    outs = (ops.prefix_scan(counts, exclusive=True), ops.prefix_scan(xf),
            ops.bincount(ids, BINCOUNT_MAIN[1]))
    torch.cuda.synchronize()
    launches = ops.launches()
    check(launches["prefix_scan"] == 2 and launches["bincount"] == 1,
          f"entry-point launches {launches}")
    check(torch.equal(outs[0], prefix_scan.prefix_scan_plain(counts, True)),
          "ops.prefix_scan exclusive")
    check(int(outs[2].sum()) == BINCOUNT_MAIN[0], "ops.bincount total")
    emit(phase="ssm-kernels", checked=checked, max_abs_err=err,
         prefix_scan_f32_run_to_run=f32_repeats,
         entry_point_launches={k: launches[k] for k in ("prefix_scan",
                                                        "bincount")},
         columns="ssm_scan b t d err | prefix_scan rows n dtype exclusive "
                 "err (float32: against float64, then torch.cumsum's own) | "
                 "bincount n n_buckets")
    return {"max_abs_err": err, "launches": launches}


@contextlib.contextmanager
def plain_ssm_scan():
    """Within the block, the models' ``ops.ssm_scan`` calls run its plain
    version, and autograd differentiates it; fails if the forward or the
    backward kernel was launched there all the same."""
    from repro_torch.kernels import ops, ssm_scan
    keys = ("ssm_scan", "ssm_scan.bwd")
    kernel = ops.ssm_scan
    before = {k: ops.launches()[k] for k in keys}
    ops.ssm_scan = ssm_scan.ssm_scan_plain
    try:
        yield
    finally:
        ops.ssm_scan = kernel
    after = {k: ops.launches()[k] for k in keys}
    check(after == before, f"an ssm_scan kernel ran where its plain version "
                           f"should have: {before} -> {after}")


def block_prefill_vs_decode(torch, dev, cfg, lp, chunk: int) -> dict:
    """Layer 0's sequence block (Mamba2, or RWKV6 time mixing) at full
    width in float32, b LM_B, over two whole chunks and one token of seeded
    inputs: its prefill output and final state against token-by-token
    decode, within 2e-3.  That crosses the ssm_scan kernel's carry between
    chunks, the decay spread over channels and the padding that carries
    the final state.  Returns the max abs errors and the length."""
    from repro_torch.models import rwkv, ssm
    n = 2 * chunk + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    x = torch.randn(LM_B, n, cfg.d_model, device=dev, generator=gen)
    if cfg.family == "hybrid":
        p = lp["mamba"]
        y_p, st_p = ssm.apply_mamba(p, cfg, x, return_state=True)
        st = ssm.init_mamba_state(cfg, LM_B, device=dev)
        step = ssm.mamba_decode_step
    else:
        p = lp["time"]
        y_p, (S, x_last) = rwkv.apply_rwkv_time(p, cfg, x, chunk=chunk,
                                                return_state=True)
        st_p = {"S": S, "x_time": x_last}
        st = rwkv.init_rwkv_state(cfg, LM_B, device=dev)
        step = rwkv.rwkv_time_decode
    ys = []
    for t in range(n):
        y, st = step(p, cfg, x[:, t:t + 1], st)
        ys.append(y)
    pairs = {"y": (y_p, torch.cat(ys, 1))}
    pairs.update((k, (a, getattr(st, k))) for k, a in
                 (st_p._asdict() if hasattr(st_p, "_asdict")
                  else st_p).items())
    err = {"tokens": n, "chunk": chunk}
    for k, (a, b) in pairs.items():
        err[k] = (a.float() - b.float()).abs().max().item()
        check(rel_close(b, a, 2e-3), f"{cfg.name}: layer 0 block, f32 "
              f"prefill vs decode over {n} tokens: {k} max abs {err[k]}")
    return err


def ssm_lm_phase(torch, dev, arch: str, tag: str) -> dict:
    """Phases <tag>-serve and <tag>-prefill: the serving path of a
    sub-quadratic LM at full width and depth (prefill of 8 x 2048 tokens,
    32 greedy decode steps, a serve drain, launch counts); a float32
    prefill against token-by-token decode, and layer 0's block the same
    over three chunks, the last one partial; the bf16 prefill against the
    same prefill with ssm_scan's plain version; then host-clock timings, a
    profiled prefill and a profiled window of decode steps.  The hybrid
    first checks and times flash_attention at its shared block's prefill
    shape (phase <tag>-flash).  Returns the launches, the timings and the
    flash check."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, model_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, attn_impl="flash")
    # the hybrid's shared block runs at every shared_attn_period-th layer
    n_flash = (len(range(0, cfg.n_layers, cfg.shared_attn_period))
               if cfg.family == "hybrid" else 0)
    flash = None
    if n_flash:
        # the shape the shared block gives flash_attention in prefill
        shape = (LM_B, cfg.n_heads, cfg.n_kv_heads, LM_S, LM_S, cfg.hd, True)
        checked = flash_check(torch, dev, shape, 200)
        flash = {"max_abs_err": max(row[-1] for row in checked),
                 "timing": flash_timing(torch, dev, shape)}
        emit(phase=f"{tag}-flash", arch=arch, checked=checked, **flash,
             columns="b hq hkv s_q s_k d causal dtype max_abs_err")
    # the scan's chunk (RWKV6's is at most 64), as the model sets it
    chunk = cfg.ssm_chunk if cfg.family == "hybrid" else min(cfg.ssm_chunk,
                                                             64)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    model.compute_params()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    prompt = torch.from_numpy(gen.integers(0, cfg.vocab_size, (LM_B, LM_S))
                              .astype(np.int32)).to(dev)
    requests = serve_requests(gen, cfg.vocab_size)

    # -- the main path: counts reset just before, read just after ----------
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    logits, state = model.prefill(prompt, max_len=LM_S + LM_DECODE)
    torch.cuda.synchronize()
    per_prefill = ops.launches()
    tokens = [logits.argmax(-1)]
    for _ in range(LM_DECODE):
        logits, state = model.decode_step(tokens[-1], state)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_finite = bool(torch.isfinite(logits.float()).all())
    eng = serve_drain(model, requests)
    torch.cuda.synchronize()
    launches = ops.launches()
    routes = dict(flash_kernel.route_launches)
    check(routes == {"wgmma": n_flash, "cuda_core": 0},
          f"{arch}: flash_attention routes {routes}")
    want = {"ssm_scan": cfg.n_layers, "flash_attention": n_flash}
    for name, n in want.items():
        check(per_prefill[name] == n and launches[name] == n,
              f"{arch}: {name} launches {per_prefill[name]} in prefill, "
              f"{launches[name]} in all: expected {n} per prefill and none "
              f"in decode or serving")
    # route counts ("kernel.route") belong to their kernel
    others = {k: v for k, v in launches.items()
              if k.split(".")[0] not in want and v}
    check(not others, f"{arch}: other kernels launched: {others}")
    check(decode_finite, f"{arch}: decode logits not finite")
    check(state.pos.tolist() == [LM_S + LM_DECODE] * LM_B,
          f"{arch}: decode pos {state.pos.tolist()}")
    st = check_drain(eng, len(requests))
    emit(phase=f"{tag}-serve", arch=arch, stats=st,
         cost=dataclasses.asdict(eng.cost), admitted=eng.admitted,
         finished=[r.uid for r in eng.finished][:8])
    peak = torch.cuda.max_memory_allocated(dev)
    del state, eng

    # -- checks: float32 prefill equals token-by-token decode: the whole
    # model over 64 tokens, and layer 0's block over two chunks and a token
    params = model.param_tree()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = model_class(cfg)(c32, params)
    short = prompt[:, :64]
    lp, sp = m32.prefill(short, max_len=64)
    sd = m32.init_decode_state(LM_B, 64)
    for i in range(64):
        ld, sd = m32.decode_step(short[:, i], sd)
    f32_err = {"logits": (lp - ld).abs().max().item()}
    ok = rel_close(ld, lp, 2e-3)
    for name, a, b in zip(sp._fields, sp, sd):
        f32_err[name] = (a.float() - b.float()).abs().max().item()
        ok = ok and (torch.equal(a, b) if name == "pos"
                     else rel_close(b, a, 2e-3))
    check(ok, f"{arch}: f32 prefill vs decode {f32_err}")
    block_err = block_prefill_vs_decode(torch, dev, c32,
                                        m32.compute_params()[1][0], chunk)
    # the whole model over the block's length: the prefill through the
    # kernel against the same prefill through the plain scan, within 2e-4;
    # and its drift from token-by-token decode, recorded (float32 rounding
    # that grows with depth; ratio > 1 is outside the 2e-3 rule)
    n = block_err["tokens"]
    lk, sk = m32.prefill(prompt[:, :n], max_len=n)
    with plain_ssm_scan():
        lq, sq = m32.prefill(prompt[:, :n], max_len=n)
    sd = m32.init_decode_state(LM_B, n)
    for i in range(n):
        ld, sd = m32.decode_step(prompt[:, i], sd)
    drift = {"tokens": n, "kernel_vs_plain": {}, "vs_decode": {},
             "vs_decode_ratio": {}}
    for name, a, q, d in zip(("logits",) + sk._fields, (lk,) + sk,
                             (lq,) + sq, (ld,) + sd):
        if name == "pos":
            continue
        e = (a - q).abs().max().item()
        drift["kernel_vs_plain"][name] = e
        check(rel_close(a, q, 2e-4), f"{arch}: f32 prefill over {n} tokens,"
              f" kernel vs plain scan: {name} max abs {e}")
        drift["vs_decode"][name] = (a - d).abs().max().item()
        drift["vs_decode_ratio"][name] = ((a - d).abs()
                                          / (2e-3 + 2e-3 * a.abs())
                                          ).max().item()
    drift["vs_decode_by_layer"] = [(a - d).abs().max().item()
                                   for a, d in zip(sk[0], sd[0])]
    del m32, sp, sd, sk, sq

    # the bf16 prefill through the kernel against the same prefill with
    # ssm_scan's plain version, both against a float32 plain-path model
    logits, _ = model.prefill(prompt, max_len=LM_S)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{arch}: prefill logits")
    with plain_ssm_scan():
        lx, _ = model.prefill(prompt, max_len=LM_S)
        m_ref = model_class(cfg)(dataclasses.replace(
            cfg, attn_impl="xla", compute_dtype="float32"), params)
        lr, _ = m_ref.prefill(prompt, max_len=LM_S)
        del m_ref
    torch.cuda.synchronize()
    err_kx = (logits.float() - lx.float()).abs().max().item()
    err_k = (logits.float() - lr).abs().max().item()
    err_x = (lx.float() - lr).abs().max().item()
    rms_k = (logits.float() - lr).pow(2).mean().sqrt().item()
    rms_x = (lx.float() - lr).pow(2).mean().sqrt().item()
    # as for TinyLlama's flash path: the two bf16 prefills may differ by
    # twice the plain one's own bf16 error against the float32 model, and
    # the kernel's rms error may exceed the plain one's by 25 %
    check(err_kx <= 2 * err_x and rms_k <= 1.25 * rms_x,
          f"{arch}: bf16 ssm_scan kernel vs plain prefill: max {err_kx} "
          f"(tolerance {2 * err_x}); rms error vs the f32 model {rms_k}, "
          f"plain {rms_x}")
    del logits, lx, lr
    emit(phase=f"{tag}-prefill", arch=arch, batch=LM_B, seq=LM_S,
         decode_steps=LM_DECODE, build_s=build_s,
         launches_per_prefill={k: per_prefill[k] for k in want},
         main_path_launches=launches,
         greedy_tokens_slot0=[int(t[0]) for t in tokens[:8]],
         f32_prefill_vs_decode_max_abs=f32_err,
         f32_block_prefill_vs_decode=block_err, f32_long_prefill=drift,
         bf16_kernel_vs_plain_scan_max_abs=err_kx,
         bf16_vs_f32_model={"kernel_max": err_k, "plain_max": err_x,
                            "kernel_rms": rms_k, "plain_rms": rms_x},
         peak_mem_bytes=peak)

    # -- timings: host clock first, then a profiled prefill and decode window
    timings, prefill, decode = lm_host_timings(torch, model, prompt,
                                               requests, prefill_reps=3)
    # kernel names in csrc/ssm_scan.cu and csrc/flash_attention.cu
    prof = profiled(prefill, torch, named={"ssm_scan": "ssm_scan_kernel",
                                           "flash_attention":
                                               "flash_wgmma_kernel"})
    prof["busy_share"] = prof["device_ms"] / timings["prefill_ms"]
    prof["ssm_scan_share"] = prof["ssm_scan"]["ms"] / prof["device_ms"]
    prof_decode = profiled(lambda: [decode() for _ in range(DECODE_WINDOW)],
                           torch)
    for key in ("wall_ms", "device_ms", "launches"):
        prof_decode[key] /= DECODE_WINDOW
    prof_decode["busy_share"] = (prof_decode["device_ms"]
                                 / timings["decode_step_ms"])
    return {"launches": launches, "routes": routes, "flash": flash,
            "timings": {"arch": arch, **timings, "profiled_prefill": prof,
                        "profiled_decode_step": prof_decode}}


def ssm_timings_phase(torch, dev, lm_timings) -> list:
    """Phase ssm-timings: CUDA-event medians of ssm_scan, prefix_scan and
    bincount, their plain versions and yardsticks at the main shapes,
    beside the bound, with the models' host-clock timings.  Returns the
    per-kernel totals of the summary line."""
    from repro_torch.kernels import bincount, prefix_scan, ssm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    per_call = []

    def row(name, shape, kern, plain, library, nbytes, nops, run):
        per_call.append({"kernel": name, "shape": shape, "ms": kern,
                         "b2b_ms": b2b_ms(run, torch),
                         "plain_ms": plain, "library_ms": library,
                         "bytes": nbytes, "ops": nops,
                         "bytes_ms": bytes_ms(nbytes),
                         "ops_ms": ops_ms(nops),
                         "bound_ms": bound_ms(nops, nbytes)})

    for shape in SSM_MAIN:
        a = torch.rand(shape, device=dev, generator=gen)
        x = torch.randn(shape, device=dev, generator=gen)
        row("ssm_scan", list(shape),
            event_ms(lambda: ssm_scan.ssm_scan_cuda(a, x), torch),
            event_ms(lambda: ssm_scan.ssm_scan_plain(a, x), torch), None,
            *ssm_scan.ssm_scan_work(*shape, a.dtype, x.dtype)[::-1],
            lambda: ssm_scan.ssm_scan_cuda(a, x))
        del a, x
    for rows, n, dt, ex in SCAN_MAIN:
        x = scan_input(torch, dev, gen, rows, n, dt)
        row("prefix_scan", [rows, n, dt, ex],
            event_ms(lambda: prefix_scan.prefix_scan_cuda(x, ex), torch),
            event_ms(lambda: prefix_scan.prefix_scan_plain(x, ex), torch),
            event_ms(lambda: torch.cumsum(x, -1, dtype=x.dtype), torch),
            *prefix_scan.prefix_scan_work(rows, n, x.dtype)[::-1],
            lambda: prefix_scan.prefix_scan_cuda(x, ex))
    n, V = BINCOUNT_MAIN
    ids = torch.randint(0, V, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    check(torch.equal(bincount.bincount_cuda(ids, V),
                      torch.bincount(ids, minlength=V).to(torch.int32)),
          "bincount yardstick disagrees with the kernel")
    row("bincount", [n, V], event_ms(lambda: bincount.bincount_cuda(ids, V),
                                     torch),
        event_ms(lambda: bincount.bincount_plain(ids, V), torch),
        event_ms(lambda: torch.bincount(ids, minlength=V), torch),
        *bincount.bincount_work(n, V)[::-1],
        lambda: bincount.bincount_cuda(ids, V))
    emit(phase="ssm-timings", per_call=per_call, models=lm_timings,
         note=f"kernel rows: CUDA-event medians of {REPS} after a warm-up; "
              "models: host-clock medians ending in a synchronize, one "
              "profiled prefill and a profiled window of "
              f"{DECODE_WINDOW} decode steps (per step); busy_share = "
              "device ms over the unprofiled median wall ms")
    totals = {}
    for r in per_call:
        t = totals.setdefault(r["kernel"], {"ms": 0.0, "b2b_ms": 0.0,
                                            "plain_ms": 0.0,
                                            "library_ms": 0.0,
                                            "bytes_ms": 0.0, "ops_ms": 0.0})
        for k in ("ms", "b2b_ms", "plain_ms", "bytes_ms", "ops_ms"):
            t[k] += r[k]
        t["library_ms"] = (None if r["library_ms"] is None
                           else t["library_ms"] + r["library_ms"])
        t.setdefault("per_call", []).append(
            {k: r[k] for k in ("shape", "ms", "b2b_ms", "plain_ms",
                               "bound_ms", "library_ms")})
    return totals


# ---------------------------------------------------------------------------
# The MoE, VLM and enc-dec serving paths
# ---------------------------------------------------------------------------

#: the MoE configurations served, (arch, phase tag); each is cut to the
#: deepest whose params and compute copy leave MOE_HEADROOM bytes of the
#: card's free memory: kimi-k2 keeps 1 layer (a layer's 384 experts take
#: 33.8 GB in bf16), llama4-scout a few (13.2 GB a layer in float32 and
#: bf16)
MOE_ARCHS = (("kimi-k2-1t-a32b", "kimi"), ("llama4-scout-17b-a16e", "scout"))
MOE_HEADROOM = 15e9
VLM_ARCH, ENCDEC_ARCH = "internvl2-2b", "whisper-base"
ENCDEC_PROMPT, ENCDEC_MAX_LEN = 32, 448
#: the MoE layer's check: rows of LM_B tokens of this length
MOE_CHECK_S = 512
#: the shuffle dispatch's runs, (tokens a row, capacity factor), LM_B rows:
#: its buffers hold n_ep cap = t k cf items of d a (sender, receiver) pair,
#: and c_loc = n_ep cap cf / e_loc an expert, so they grow as cf^2 (at
#: kimi-k2's 8 x 2048 tokens and cf 1.25, about 20 GB); the cf 8.0 run,
#: where nothing drops, is the shorter
MOE_SHUFFLE = ((64, 8.0), (512, 1.25))
#: a short prompt at which the flash and plain-attention MoE models have
#: rows whose routes all agree, at a capacity that holds every choice (so
#: that rows do not couple through it): at LM_S, or at 32 tokens and the
#: published capacity, a flipped route in every row is seen
MOE_SHORT_S = 4
#: bf16 against a computation of the same routes and weights in float32
#: (or in bf16 another way): the error's rms within BF16_TOL of the
#: reference's rms, and each element within BF16_TOL of itself plus
#: 6 BF16_TOL of that rms.  bf16's unit roundoff is 2^-9; the bf16 path
#: rounds gate, up, their product, the expert output, the weighted combine
#: and the shared expert, each relative to the element or, for the inner
#: sums, to the output's scale: 2e-2 is about ten roundings, and six
#: standard deviations the tail of 10^7 to 10^8 elements' errors.  On an
#: H100 80GB HBM3 (700 W) the MoE layers' sound bf16 output reads rms
#: 0.43 % and 0.33 %, max 0.060 rms; the nearest planted fault the check
#: fails (MOE_FAULTS) reads rms 4.6 %, max 0.26 rms (PERF.md §6)
BF16_TOL = 2e-2
#: the bf16 flash MoE model against the bf16 plain-attention one, on rows
#: whose routes all agree: |got - want| <= tol (1 + |want|).  The two
#: round attention differently; over 22 layers TinyLlama's bf16 flash and
#: plain logits (unit rms) differ by up to 0.094 on an H100 (phase
#: lm-prefill); a fault in the path moves logits by their own size
MOE_MODEL_TOL = 0.1


@contextlib.contextmanager
def recorded_routes():
    """Every MoE routing inside the block, in call order: the einsum
    dispatch's ``Routes`` (ids, keep, weights, each (groups, group, k))."""
    from repro_torch.models import moe
    calls = []
    route = moe._route_tokens

    def recording(*args, **kw):
        calls.append(route(*args, **kw))
        return calls[-1]

    moe._route_tokens = recording
    try:
        yield calls
    finally:
        moe._route_tokens = route


@contextlib.contextmanager
def configured(model, **changes):
    """The model with ``cfg`` fields changed inside the block (the compute
    copy of its weights kept: the compute dtype must stay)."""
    import dataclasses
    cfg = model.cfg
    check(changes.get("compute_dtype", cfg.compute_dtype) ==
          cfg.compute_dtype, "configured: the compute dtype must stay")
    model.cfg = dataclasses.replace(cfg, **changes)
    try:
        yield model
    finally:
        model.cfg = cfg


def layer_error(got, want) -> dict:
    err = got.float() - want
    return {"max_abs_err": err.abs().max().item(),
            "rms_err": err.pow(2).mean().sqrt().item(),
            "rms_want": want.pow(2).mean().sqrt().item()}


def dropped(keep) -> float:
    return 1.0 - keep.float().mean().item()


def moe_depth(torch, dev, cfg) -> dict:
    """The deepest cut of ``cfg`` whose params and compute-dtype copy leave
    MOE_HEADROOM bytes of the card's free memory, with the bytes counted."""
    def nbytes(name):
        return torch.finfo(getattr(torch, name)).bits // 8
    pb = nbytes(cfg.param_dtype)
    copy = 0 if cfg.param_dtype == cfg.compute_dtype \
        else nbytes(cfg.compute_dtype)
    d, hd, e = cfg.d_model, cfg.hd, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    cast = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + 3 * d * f * (e + int(cfg.shared_expert)))
    layer = cast * (pb + copy) + d * e * 4 + 2 * d * pb
    rest = 2 * cfg.padded_vocab * d * (pb + copy) + d * pb
    free = torch.cuda.mem_get_info(dev)[0]
    depth = max(1, min(cfg.n_layers,
                       int((free - MOE_HEADROOM - rest) // layer)))
    return {"layers": depth, "of": cfg.n_layers, "layer_bytes": layer,
            "embed_head_bytes": rest, "free_bytes": free,
            "headroom_bytes": MOE_HEADROOM}


def token_rows(t):
    """(groups, group, k) -> (tokens, k): the einsum dispatch groups the
    tokens in their flattened (row, token) order."""
    return t.reshape(-1, t.shape[-1])


def route_agreement(calls_a, calls_b, b: int, s: int) -> dict:
    """Routes of two runs of the same prompts (B rows of s tokens, the
    groups whole rows or within one): (token, choice) routes whose expert
    or keep differ, by layer, and each row's agreement over all layers."""
    import torch
    differ, row_ok = [], None
    for (ia, ka), (ib, kb) in zip(calls_a, calls_b):
        diff = ((ia != ib) | (ka != kb)).reshape(b, s, -1)
        differ.append(int(diff.sum()))
        ok = ~diff.flatten(1).any(1)
        row_ok = ok if row_ok is None else row_ok & ok
    return {"routes": int(calls_a[0][0].numel()) * len(calls_a),
            "differ_by_layer": differ, "rows_agree": row_ok}


def plain_in_rows(model, prompt, rows: int, **kw):
    """Prefill logits of the plain-attention path, ``rows`` prompts at a
    time (its scores take b h s^2 float32), and the routes of each part,
    concatenated by layer.  The einsum dispatch groups tokens in the
    flattened (row, token) order, so parts of whole groups route as the
    whole batch does."""
    import torch
    logits, parts = [], []
    with configured(model, attn_impl="xla"):
        for i in range(0, prompt.shape[0], rows):
            with recorded_routes() as calls:
                lg, _ = model.prefill(prompt[i:i + rows], **kw)
            logits.append(lg)
            parts.append(calls)
    calls = [tuple(torch.cat([token_rows(getattr(p[l], f)) for p in parts])
                   for f in ("ids", "keep"))
             for l in range(len(parts[0]))]
    return torch.cat(logits), calls


def moe_model_check(torch, model, prompt, compare: bool, **changes) -> dict:
    """The bf16 flash model against the bf16 plain-attention model on the
    same prompts, both with the config ``changes``: routes that differ,
    and if ``compare`` the logits on the rows whose routes all agree
    (within MOE_MODEL_TOL), of which there must be one at least."""
    b, s = prompt.shape
    with configured(model, **changes):
        with recorded_routes() as flash_calls:
            lf, _ = model.prefill(prompt)
        flash_calls = [(token_rows(r.ids), token_rows(r.keep))
                       for r in flash_calls]
        # at LM_S, 2 rows a part are 8 whole groups of 512 tokens; a short
        # prompt's batch is one group, run whole
        lp, plain_calls = plain_in_rows(model, prompt,
                                        2 if s >= 512 else b)
    agree = route_agreement(flash_calls, plain_calls, b, s)
    rows = agree.pop("rows_agree")
    out = {"rows": b, "tokens": s, **changes, **agree,
           "rows_agree": int(rows.sum()), "logits_compared": compare}
    if compare:
        check(out["rows_agree"] > 0, f"{model.cfg.name}: no row's routes "
              f"agree between the flash and plain models: {out}")
        vocab = model.cfg.vocab_size              # the padded tail: -1e30
        got, want = lf[rows, :vocab].float(), lp[rows, :vocab].float()
        out["agreeing_max_abs"] = (got - want).abs().max().item()
        out["agreeing_rms"] = (got - want).pow(2).mean().sqrt().item()
        check(rel_close(got, want, MOE_MODEL_TOL),
              f"{model.cfg.name}: bf16 flash vs plain logits on agreeing "
              f"rows: {out}")
    return out


def bf16_vs_f32_rule(torch, name: str, vocab: int, flash, plain,
                     ref) -> dict:
    """TinyLlama's rule on the logits of the ``vocab`` real tokens (the
    padded tail holds -1e30 in both dtypes): the bf16 flash and
    plain-attention outputs may differ by twice the plain one's own error
    against the float32 plain model (max abs), and the flash one's rms
    error may exceed the plain one's by 25 %."""
    flash, plain, ref = (t[..., :vocab] for t in (flash, plain, ref))
    err_fx = (flash.float() - plain.float()).abs().max().item()
    err_f = (flash.float() - ref).abs().max().item()
    err_x = (plain.float() - ref).abs().max().item()
    rms_f = (flash.float() - ref).pow(2).mean().sqrt().item()
    rms_x = (plain.float() - ref).pow(2).mean().sqrt().item()
    check(err_fx <= 2 * err_x and rms_f <= 1.25 * rms_x,
          f"{name}: bf16 flash vs plain path: max {err_fx} (tolerance "
          f"{2 * err_x}); rms error vs the f32 model {rms_f}, plain {rms_x}")
    return {"flash_vs_plain_max": err_fx, "flash_max": err_f,
            "plain_max": err_x, "flash_rms": rms_f, "plain_rms": rms_x}


def main_path(torch, ops, flash_kernel, name: str, run, n_flash: int):
    """``run()`` with the launch counts reset just before and read just
    after: its flash_attention launches must be ``n_flash``, all wgmma, and
    no other kernel may launch.  Returns run()'s result and the counts."""
    ops.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = ops.launches()
    routes = dict(flash_kernel.route_launches)
    check(launches["flash_attention"] == n_flash
          and routes == {"wgmma": n_flash, "cuda_core": 0},
          f"{name}: flash_attention launches {launches}, routes {routes}: "
          f"expected {n_flash}, all wgmma")
    others = {k: v for k, v in launches.items()
              if k.split(".")[0] != "flash_attention" and v}
    check(not others, f"{name}: other kernels launched: {others}")
    return out, launches, routes


def moe_shuffle_phase(torch, dev, model, tag: str) -> dict:
    """Phase <tag>-shuffle: layer 0's MoE through ``_moe_shuffle`` over a
    one-rank NCCL expert group (started here, destroyed at the end) against
    ``_moe_einsum`` on the same bf16 input: at cf 8.0 the outputs (within
    BF16_TOL, both without drops), at the published cf both dropped
    fractions; CUDA-event ms of each dispatch."""
    import dataclasses
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.models import moe, use_expert_group
    from repro_torch.testing import scaled_close
    cfg = model.cfg
    p = model.compute_params()[1][0]["moe"]
    allocated = torch.cuda.memory_allocated(dev)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    runs = []
    try:
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        for s, cf in MOE_SHUFFLE:
            c = dataclasses.replace(cfg, capacity_factor=cf)
            x = torch.randn(LM_B, s, cfg.d_model, device=dev,
                            generator=gen).to(torch.bfloat16)
            with use_expert_group(dist.group.WORLD):
                sh = moe._moe_shuffle(p, c, x)
                shuffle_ms = event_ms(lambda: moe._moe_shuffle(p, c, x),
                                      torch, reps=3)
            ein = moe._moe_einsum(p, c, x)
            einsum_ms = event_ms(lambda: moe._moe_einsum(p, c, x), torch,
                                 reps=3)
            run = {"tokens": [LM_B, s], "capacity_factor": cf,
                   "dropped_shuffle": sh.dropped_frac.item(),
                   "dropped_einsum": ein.dropped_frac.item(),
                   "shuffle_ms": shuffle_ms, "einsum_ms": einsum_ms,
                   "max_abs_diff": (sh.y.float() - ein.y.float()).abs()
                   .max().item()}
            if cf == 8.0:
                check(run["dropped_shuffle"] == run["dropped_einsum"] == 0
                      and scaled_close(sh.y, ein.y, BF16_TOL),
                      f"{tag}-shuffle: shuffle vs einsum dispatch {run}")
            runs.append(run)
            del x, sh, ein
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase=f"{tag}-shuffle", arch=cfg.name, world_size=1, runs=runs,
         allocated_before_bytes=allocated,
         tolerance=f"rms(shuffle - einsum) <= {BF16_TOL} rms(einsum), "
                   f"|shuffle - einsum| <= {BF16_TOL} |einsum| + "
                   f"{6 * BF16_TOL} rms(einsum) at cf 8.0, where neither "
                   "drops; ms: CUDA-event medians of 3")
    return {"runs": runs}


def family_flash_check(torch, dev, tag: str, arch: str, shapes) -> dict:
    """Phase <tag>-flash: flash_attention against its plain version
    (flash_check) at the shapes a model's prefill gives it, the cache
    emptied after.  Returns the rows and their largest error."""
    checked = [row for i, shape in enumerate(shapes)
               for row in flash_check(torch, dev, shape, 300 + i)]
    gc.collect()
    torch.cuda.empty_cache()
    out = {"checked": checked, "max_abs_err": max(row[-1] for row in checked)}
    emit(phase=f"{tag}-flash", arch=arch, **out,
         columns="b hq hkv s_q s_k d causal dtype max_abs_err")
    return out


def moe_serve_phase(torch, dev, arch: str, tag: str) -> dict:
    """Phases <tag>-flash, <tag>-serve, <tag>-prefill, <tag>-shuffle: the
    flash kernel against its plain version at the model's prefill shape;
    an MoE LM at full
    width, cut in depth by moe_depth (bf16 compute, ``attn_impl="flash"``,
    einsum dispatch): prefill of 8 x 2048 tokens, 32 greedy decode steps,
    a 16-request drain, launch counts reset just before and read just
    after, layer 0's dropped fraction at prefill and at each decode step,
    peak memory; the MoE layer in bf16 against a float32 loop over its
    experts with the same routes, and what that check reads on planted
    faults; the flash model against the plain-attention model (routes that
    differ at LM_S; logits on agreeing rows of a short prompt);
    host-clock timings and a profiled prefill; then the shuffle dispatch.
    Returns the launches and timings."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    from repro_torch.testing import MOE_FAULTS, moe_layer_f32, scaled_close

    t_phase = time.perf_counter()
    full = get_config(arch, attn_impl="flash")
    # the kernel at the shape prefill gives it, before the model takes the
    # card (the plain version's float32 scores take up to 3 x 8.6 GB)
    flash = family_flash_check(torch, dev, tag, arch, [
        (LM_B, full.n_heads, full.n_kv_heads, LM_S, LM_S, full.hd, True)])
    cut = moe_depth(torch, dev, full)
    L = cut["layers"]
    cfg = dataclasses.replace(full, n_layers=L)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    model.compute_params()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    prompt = torch.from_numpy(gen.integers(0, cfg.vocab_size, (LM_B, LM_S))
                              .astype(np.int32)).to(dev)
    requests = serve_requests(gen, cfg.vocab_size)

    # -- the main path: counts reset just before, read just after ----------
    def run():
        with recorded_routes() as calls:
            logits, state = model.prefill(prompt, max_len=LM_S + LM_DECODE)
            torch.cuda.synchronize()
            per_prefill = ops.launches()["flash_attention"]
            tokens = [logits.argmax(-1)]
            for _ in range(LM_DECODE):
                logits, state = model.decode_step(tokens[-1], state)
                tokens.append(logits.argmax(-1))
            main = [r.keep for r in calls]
            return per_prefill, tokens, logits, state, main, serve_drain(
                model, requests)

    torch.cuda.reset_peak_memory_stats(dev)
    (per_prefill, tokens, logits, state, keeps, eng), launches, routes = \
        main_path(torch, ops, flash_kernel, arch, run, L)
    peak = torch.cuda.max_memory_allocated(dev)
    check(per_prefill == L, f"{arch}: {per_prefill} flash launches per "
          f"prefill, expected {L}")
    check(len(keeps) == L * (1 + LM_DECODE),
          f"{arch}: {len(keeps)} MoE routings")
    check(bool(torch.isfinite(logits.float()).all()),
          f"{arch}: decode logits not finite")
    check(state.pos.tolist() == [LM_S + LM_DECODE] * LM_B,
          f"{arch}: decode pos {state.pos.tolist()}")
    drop_prefill = dropped(keeps[0])
    drop_decode = [dropped(keeps[L * (1 + i)]) for i in range(LM_DECODE)]
    st = check_drain(eng, len(requests))
    emit(phase=f"{tag}-serve", arch=arch, stats=st,
         cost=dataclasses.asdict(eng.cost), admitted=eng.admitted,
         finished=[r.uid for r in eng.finished][:8])
    del state, eng, keeps

    # -- the MoE layer at full width: bf16 against a float32 expert loop ---
    p0 = model.compute_params()[1][0]["moe"]
    gx = torch.Generator(device=dev)
    gx.manual_seed(11)
    x = torch.randn(LM_B, MOE_CHECK_S, cfg.d_model, device=dev,
                    generator=gx).to(torch.bfloat16)
    with recorded_routes() as seen:
        y = moe._moe_einsum(p0, cfg, x).y
    r = seen[0]
    want = moe_layer_f32(p0, cfg, x, r)
    layer_check = {"tokens": [LM_B, MOE_CHECK_S],
                   "dropped": dropped(r.keep), **layer_error(y, want)}
    check(torch.isfinite(y.float()).all() and scaled_close(y, want,
                                                           BF16_TOL),
          f"{arch}: bf16 MoE layer vs the float32 expert loop "
          f"{layer_check}")
    # what the same check reads on a layer with a planted fault, rounded
    # to bf16 as the path's output is.  A lost expert or choice must fail
    # it, and so must weights left out where top_k > 1 (at 1 the
    # renormalised weight is 1).  The shared expert's loss is recorded
    # only: the reference draws the routed experts' weights with the
    # expert count as fan-in, so at random init the shared expert carries
    # a few per cent of the output or less
    planted = {}
    for fault in MOE_FAULTS:
        bad = moe_layer_f32(p0, cfg, x, r, fault=fault).to(torch.bfloat16)
        planted[fault] = {**layer_error(bad, want),
                          "passes": scaled_close(bad, want, BF16_TOL)}
        del bad
    layer_check["planted_faults"] = planted
    caught = ("last_choice", "expert0") + (("unweighted",)
                                           if cfg.top_k > 1 else ())
    check(not any(planted[f]["passes"] for f in caught),
          f"{arch}: the MoE layer check passes a planted fault: {planted}")
    del x, y, want, seen, r

    # -- the flash model against the plain-attention model -----------------
    # at LM_S routes flip in every row, so the logits are compared on the
    # short prompt, where rows agree
    model_check = [moe_model_check(torch, model, prompt, compare=False),
                   moe_model_check(torch, model, prompt[:, :MOE_SHORT_S],
                                   compare=True,
                                   capacity_factor=cfg.n_experts
                                   / cfg.top_k)]
    emit(phase=f"{tag}-prefill", arch=arch, batch=LM_B, seq=LM_S,
         decode_steps=LM_DECODE, cut=cut, build_s=build_s,
         launches_per_prefill=per_prefill,
         main_path_launches=launches,
         greedy_tokens_slot0=[int(t[0]) for t in tokens[:8]],
         layer0_dropped_prefill=drop_prefill,
         layer0_dropped_decode=drop_decode,
         layer0_dropped_decode_mean=sum(drop_decode) / len(drop_decode),
         flash_max_abs_err=flash["max_abs_err"],
         moe_layer_vs_f32=layer_check, flash_vs_plain=model_check,
         tolerances={"moe_layer": f"rms(bf16 - f32) <= {BF16_TOL} "
                                  f"rms(f32), |bf16 - f32| <= {BF16_TOL} "
                                  f"|f32| + {6 * BF16_TOL} rms(f32); same "
                                  "routes",
                     "model": f"|flash - plain| <= {MOE_MODEL_TOL} (1 + "
                              "|plain|) on rows whose routes all agree, at "
                              "least one (the short prompt); the full "
                              "prompt's routes are reported"},
         peak_mem_bytes=peak)

    # -- timings: host clock, then a profiled prefill -----------------------
    timings, prefill, _ = lm_host_timings(torch, model, prompt, requests,
                                          prefill_reps=3)
    prof = profiled(prefill, torch, named={"flash_attention":
                                           "flash_wgmma_kernel"})
    prof["busy_share"] = prof["device_ms"] / timings["prefill_ms"]
    shuffle = moe_shuffle_phase(torch, dev, model, tag)
    del model
    return {"tag": tag, "launches": launches, "routes": routes,
            "per_prefill": L, "seconds": time.perf_counter() - t_phase,
            "flash": flash,
            "timings": {"arch": arch, "layers": L, **timings,
                        "peak_mem_bytes": peak,
                        "layer0_dropped_prefill": drop_prefill,
                        "layer0_dropped_decode_mean":
                            sum(drop_decode) / len(drop_decode),
                        "profiled_prefill": prof},
            "shuffle": shuffle}


def vlm_phase(torch, dev) -> dict:
    """Phases vlm-flash, vlm-serve and vlm-prefill: the flash kernel
    against its plain version at the prefill's shape; internvl2-2b at full
    width and depth (bf16 compute, ``attn_impl="flash"``): prefill of 8 x (256
    patches + 1792 tokens), 32 greedy decode steps and a 16-request text
    drain, launch counts reset just before and read just after; the bf16
    flash and plain-attention prefills each against the float32 plain
    model; host-clock timings and a profiled prefill."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM, build_model

    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH, attn_impl="flash")
    # the prefill runs over the patches and the text, LM_S positions
    flash = family_flash_check(torch, dev, "vlm", VLM_ARCH, [
        (LM_B, cfg.n_heads, cfg.n_kv_heads, LM_S, LM_S, cfg.hd, True)])
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    model.compute_params()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    s_text = LM_S - cfg.n_patches
    prompt = torch.from_numpy(gen.integers(0, cfg.vocab_size, (LM_B, s_text))
                              .astype(np.int32)).to(dev)
    gp = torch.Generator(device=dev)
    gp.manual_seed(17)
    patches = torch.randn(LM_B, cfg.n_patches, cfg.d_model, device=dev,
                          generator=gp)
    requests = serve_requests(gen, cfg.vocab_size)
    L = cfg.n_layers

    torch.cuda.reset_peak_memory_stats(dev)

    def run():
        logits, state = model.prefill(prompt, max_len=LM_S + LM_DECODE,
                                      patch_embeds=patches)
        torch.cuda.synchronize()
        per_prefill = ops.launches()["flash_attention"]
        tokens = [logits.argmax(-1)]
        for _ in range(LM_DECODE):
            logits, state = model.decode_step(tokens[-1], state)
            tokens.append(logits.argmax(-1))
        return per_prefill, tokens, logits, state, serve_drain(model,
                                                               requests)

    (per_prefill, tokens, logits, state, eng), launches, routes = \
        main_path(torch, ops, flash_kernel, VLM_ARCH, run, L)
    peak = torch.cuda.max_memory_allocated(dev)
    check(per_prefill == L, f"{VLM_ARCH}: {per_prefill} flash launches "
          f"per prefill, expected {L}")
    check(bool(torch.isfinite(logits.float()).all()),
          f"{VLM_ARCH}: decode logits not finite")
    check(state.pos.tolist() == [LM_S + LM_DECODE] * LM_B,
          f"{VLM_ARCH}: decode pos {state.pos.tolist()}")
    st = check_drain(eng, len(requests))
    emit(phase="vlm-serve", arch=VLM_ARCH, stats=st,
         cost=dataclasses.asdict(eng.cost), admitted=eng.admitted,
         finished=[r.uid for r in eng.finished][:8])
    del state, eng

    lf, _ = model.prefill(prompt, max_len=LM_S, patch_embeds=patches)
    with configured(model, attn_impl="xla"):
        lx, _ = model.prefill(prompt, max_len=LM_S, patch_embeds=patches)
    m_ref = DecoderLM(dataclasses.replace(cfg, attn_impl="xla",
                                          compute_dtype="float32"),
                      model.param_tree())
    lr, _ = m_ref.prefill(prompt, max_len=LM_S, patch_embeds=patches)
    del m_ref
    rule = bf16_vs_f32_rule(torch, VLM_ARCH, cfg.vocab_size, lf, lx, lr)
    del lf, lx, lr
    emit(phase="vlm-prefill", arch=VLM_ARCH, batch=LM_B,
         patches=cfg.n_patches, text=s_text, decode_steps=LM_DECODE,
         build_s=build_s, launches_per_prefill=per_prefill,
         main_path_launches=launches,
         greedy_tokens_slot0=[int(t[0]) for t in tokens[:8]],
         flash_max_abs_err=flash["max_abs_err"],
         bf16_vs_f32_model=rule, peak_mem_bytes=peak)
    timings, prefill, _ = lm_host_timings(torch, model, prompt, requests,
                                          prefill_reps=3,
                                          patch_embeds=patches)
    prof = profiled(prefill, torch, named={"flash_attention":
                                           "flash_wgmma_kernel"})
    prof["busy_share"] = prof["device_ms"] / timings["prefill_ms"]
    del model
    return {"tag": "vlm", "launches": launches, "routes": routes,
            "per_prefill": L, "seconds": time.perf_counter() - t_phase,
            "flash": flash,
            "timings": {"arch": VLM_ARCH, **timings, "peak_mem_bytes": peak,
                        "profiled_prefill": prof}}


def encdec_phase(torch, dev) -> dict:
    """Phases encdec-flash, encdec-serve and encdec-prefill: the flash
    kernel against its plain version at the decoder's self-attention shape
    (the encoder's and the cross-attention's are in FLASH_EDGE);
    whisper-base at full width and depth (bf16 compute, ``attn_impl="flash"``): 8 x 1500 frames, a
    32-token prompt (max_len 448), 32 greedy decode steps, launch counts
    reset just before and read just after (the flash kernel in the
    encoder, the decoder's self-attention and its cross-attention, none in
    decode); the bf16 flash and plain-attention prefills each against the
    float32 plain model; float32 prefill against token-by-token decode
    from the prefill's cross K/V within 2e-3; encode, prefill and
    decode-step ms and the generation's tokens/s on the host clock."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import ops
    from repro_torch.models import EncDecLM, build_model

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH, attn_impl="flash")
    flash = family_flash_check(torch, dev, "encdec", ENCDEC_ARCH, [
        (LM_B, cfg.n_heads, cfg.n_kv_heads, ENCDEC_PROMPT, ENCDEC_PROMPT,
         cfg.hd, True)])
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    model.compute_params()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    prompt = torch.from_numpy(gen.integers(0, cfg.vocab_size,
                                           (LM_B, ENCDEC_PROMPT))
                              .astype(np.int32)).to(dev)
    gf = torch.Generator(device=dev)
    gf.manual_seed(19)
    frames = torch.randn(LM_B, cfg.n_frames, cfg.d_model, device=dev,
                         generator=gf)
    n_flash = cfg.enc_layers + 2 * cfg.n_layers

    def generate():
        logits, state = model.prefill(prompt, frames, ENCDEC_MAX_LEN)
        tokens = [logits.argmax(-1)]
        for _ in range(LM_DECODE):
            logits, state = model.decode_step(tokens[-1], state)
            tokens.append(logits.argmax(-1))
        return tokens, logits, state

    torch.cuda.reset_peak_memory_stats(dev)
    (tokens, logits, state), launches, routes = main_path(
        torch, ops, flash_kernel, ENCDEC_ARCH, generate, n_flash)
    peak = torch.cuda.max_memory_allocated(dev)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{ENCDEC_ARCH}: decode logits not finite")
    check(state.pos.tolist() == [ENCDEC_PROMPT + LM_DECODE] * LM_B
          and state.cross_k.shape[2] == cfg.n_frames,
          f"{ENCDEC_ARCH}: decode pos {state.pos.tolist()}")
    emit(phase="encdec-serve", arch=ENCDEC_ARCH, frames=cfg.n_frames,
         prompt=ENCDEC_PROMPT, max_len=ENCDEC_MAX_LEN,
         decode_steps=LM_DECODE, main_path_launches=launches,
         greedy_tokens_slot0=[int(t[0]) for t in tokens[:8]])
    del state

    lf, _ = model.prefill(prompt, frames, ENCDEC_MAX_LEN)
    with configured(model, attn_impl="xla"):
        lx, _ = model.prefill(prompt, frames, ENCDEC_MAX_LEN)
    c32 = dataclasses.replace(cfg, attn_impl="xla", compute_dtype="float32")
    m32 = EncDecLM(c32, model.param_tree())
    lr, sp = m32.prefill(prompt, frames, ENCDEC_MAX_LEN)
    rule = bf16_vs_f32_rule(torch, ENCDEC_ARCH, cfg.vocab_size, lf, lx,
                            lr)
    sd = m32.init_decode_state(LM_B, ENCDEC_MAX_LEN)._replace(
        cross_k=sp.cross_k, cross_v=sp.cross_v)
    for i in range(ENCDEC_PROMPT):
        ld, sd = m32.decode_step(prompt[:, i], sd)
    f32_err = {"logits": (lr - ld).abs().max().item(),
               "self_k": (sp.self_k - sd.self_k).abs().max().item()}
    check(rel_close(ld, lr, 2e-3) and rel_close(sd.self_k, sp.self_k, 2e-3),
          f"{ENCDEC_ARCH}: f32 prefill vs decode {f32_err}")
    del m32, sp, sd, lf, lx, lr
    emit(phase="encdec-prefill", arch=ENCDEC_ARCH, batch=LM_B,
         build_s=build_s, launches_per_prefill=launches["flash_attention"],
         flash_max_abs_err=flash["max_abs_err"],
         bf16_vs_f32_model=rule, f32_prefill_vs_decode_max_abs=f32_err,
         peak_mem_bytes=peak)

    # -- timings: encode, prefill (encode included), a decode step, and the
    # generation (prefill + 32 steps) as served tokens/s
    encode_runs = host_times(lambda: model.encode(frames), torch)
    prefill_runs = host_times(
        lambda: model.prefill(prompt, frames, ENCDEC_MAX_LEN), torch)
    _, state = model.prefill(prompt, frames, ENCDEC_MAX_LEN)
    tok = prompt[:, -1]
    decode_runs = host_times(lambda: model.decode_step(tok, state), torch,
                             reps=15)
    gen_runs = host_times(generate, torch, reps=3)
    gen_s = statistics.median(gen_runs) / 1e3
    prof = profiled(lambda: model.prefill(prompt, frames, ENCDEC_MAX_LEN),
                    torch, named={"flash_attention": "flash_wgmma_kernel"})
    timings = {"arch": ENCDEC_ARCH,
               "encode_ms": statistics.median(encode_runs),
               "encode_ms_runs": encode_runs,
               "prefill_ms": statistics.median(prefill_runs),
               "prefill_ms_runs": prefill_runs,
               "decode_step_ms": statistics.median(decode_runs),
               "decode_step_ms_runs": decode_runs, "decode_batch": LM_B,
               "generate_s": gen_s,
               "serve_tokens_per_s": LM_B * LM_DECODE / gen_s,
               "serve_note": f"prefill + {LM_DECODE} greedy steps of {LM_B} "
                             "requests "
                             "(EncDecLM.prefill, decode_step), median of 3",
               "peak_mem_bytes": peak, "profiled_prefill": prof}
    prof["busy_share"] = prof["device_ms"] / timings["prefill_ms"]
    del model, state
    return {"tag": "encdec", "launches": launches, "routes": routes,
            "per_prefill": n_flash, "seconds": time.perf_counter() - t_phase,
            "flash": flash,
            "timings": timings}


def gloo_start(tag: str, world: int, cases, timeout: int):
    """Start ``python -m repro_torch.dist_check --world WORLD --cases CASES
    --check`` on gloo CPU ranks, host work beside the card's phases: at
    the lowest CPU priority, in a session of its own, into a directory of
    its own.  ``gloo_join`` waits for it; ``gloo_stop`` (also at exit)
    ends what is left."""
    import atexit
    import os
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist_check", "--world",
         str(world), "--out", str(tmp), "--cases", ",".join(cases),
         "--check", "--timeout", str(timeout)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, preexec_fn=lambda: os.nice(19),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    job = (tmp, world, proc, tag)
    atexit.register(gloo_stop, job)
    return job


def gloo_stop(job) -> None:
    import os
    import shutil
    import signal
    tmp, _, proc, _ = job
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def gloo_join(job, timeout: int = 300):
    """(the launcher's JSON line, each rank's results) of a job of
    ``gloo_start``, which must have passed; its directory removed."""
    from repro_torch import dist_check
    tmp, world, proc, tag = job
    try:
        out, err = proc.communicate(timeout=timeout)
        check(proc.returncode == 0, f"{tag}: {out[-2000:]} {err[-4000:]}")
        ranks = dist_check.load_ranks(tmp, world)
    finally:
        gloo_stop(job)
    return json.loads(out.strip().splitlines()[-1]), ranks


def moe_gloo_phase(job) -> dict:
    """Phase moe-gloo, host work started after the build (``gloo_start``):
    ``python -m repro_torch.dist_check --cases moe --check`` at 2 gloo CPU
    ranks (phase sharded-gloo runs the case at SHARDED_GLOO_WORLD among
    the others), the reduced kimi-k2 layer of ``dist_check.moe_inputs``
    in float32: every rank's aux and dropped fraction equal (``--check``),
    and each rank's shuffle output equal to rank 0's einsum output within
    2e-4 where nothing drops (cf 8.0)."""
    import numpy as np
    from repro_torch import dist_check
    rec, ranks = gloo_join(job)
    want = ranks[0]["moe-8.0/einsum/0"]
    err = [float(np.abs(r["moe-8.0/per-rank/0"] - want).max())
           for r in ranks]
    check(all(np.allclose(r["moe-8.0/per-rank/0"], want, rtol=2e-4,
                          atol=2e-4) for r in ranks),
          f"moe-gloo: shuffle vs einsum at cf 8.0, max abs {err}")
    rec.update(shuffle_vs_einsum_max_abs=err,
               dropped={str(cf): float(ranks[0][f"moe-{cf}/shuffle/1"])
                        for cf in dist_check.MOE_CFS})
    emit(phase="moe-gloo", kind="host work (CPU ranks, gloo)", **rec)
    return rec


def family_phases(torch, dev, moe_gloo) -> list:
    """The VLM, enc-dec and MoE phases, each model freed before the next;
    phase moe-gloo (joining ``moe_gloo``, started by ``gloo_start``); then
    phase families-timings.  Returns each path's result."""
    paths = []
    for phase, args in ([(vlm_phase, ()), (encdec_phase, ())]
                        + [(moe_serve_phase, a) for a in MOE_ARCHS]):
        paths.append(phase(torch, dev, *args))
        gc.collect()
        torch.cuda.empty_cache()
    moe_gloo_phase(moe_gloo)
    emit(phase="families-timings",
         seconds={p["tag"]: p["seconds"] for p in paths},
         models=[p["timings"] for p in paths],
         note="host-clock medians ending in a synchronize (prefill of 3, "
              "decode step of 15, the middle of 3 drains); one profiled "
              "prefill each; busy_share = device ms over the unprofiled "
              "median wall ms")
    return paths


def same_accum(torch, a, b, ctx: str) -> None:
    """Every CostAccum field equal, bit for bit."""
    for name, x, y in zip(a._fields, a, b):
        check(torch.equal(x, y), f"{ctx}: CostAccum.{name} {x} vs {y}")


def accum_dict(a) -> dict:
    return {k: float(v) for k, v in a._asdict().items()}


SHUFFLE_KERNELS = ("bincount_tiles", "bitonic_sort",
                   "bincount_tiles.single_pass")


def kernel_query(torch, ops, engine, run, n_shuffles: int, ctx: str,
                 others=None):
    """``run(engine)`` once, with the launch counts and the engine's route
    log set to 0 just before it and read just after: every shuffle routed
    to the kernels, each kernel launched once a shuffle, every
    ``bincount_tiles`` launch single-pass, and no other kernel but those
    of ``others`` (name: launches), each exactly that often.  Returns the
    result and the launches of the two shuffle kernels and of ``others``.
    ``n_shuffles`` and ``others`` may be functions of the result, for runs
    whose shuffles are known only after the run (batched dispatches)."""
    ops.reset_launches()
    engine.route_log.reset()
    res = run(engine)
    torch.cuda.synchronize()
    if callable(n_shuffles):
        n_shuffles = n_shuffles(res)
    others = dict((others(res) if callable(others) else others) or {})
    launches = ops.launches()
    route = engine.route_log.snapshot()
    check(route == (n_shuffles, 0),
          f"{ctx}: routes {route}, want ({n_shuffles}, 0)")
    for name in SHUFFLE_KERNELS:
        check(launches[name] == n_shuffles,
              f"{ctx}: {name} launched {launches[name]} times for "
              f"{n_shuffles} shuffles")
    other = {k: v for k, v in launches.items()
             if (v or k in others)
             and not k.startswith(("bincount_tiles", "bitonic_sort"))}
    check(other == others, f"{ctx}: other kernels launched: {other}, "
                           f"want {others}")
    return res, {**{k: launches[k] for k in SHUFFLE_KERNELS}, **others}


def n_plan_shuffles(plan) -> int:
    return sum(s.rounds for s in plan.stages if s.shuffles)


def search_phases(torch, dev, ops, engine, dense):
    """Phases search, prefix, funnel, crcw, bsp and queues: the paper's
    searching and simulation algorithms at full size on the kernel engine
    and the dense one, with the same draw.  Returns the queries to time,
    and the launches of the CRCW path (not timed)."""
    from repro_torch.core import (BSPProgram, PRAMProgram, bsp_plan,
                                  dequeue, enqueue, funnel_write_plan,
                                  make_queues, multisearch_plan, prefix_plan,
                                  run_queued, simulate_crcw)
    from repro_torch.core import funnel
    from repro_torch.core.mrmodel import fifo_rank
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    queries = []

    def plan_query(name, plan, args, key, library, outputs, n_shuffles=None,
                   **rec):
        # kernel engine, then the dense engine on the same draw: outputs,
        # CostAccum and the library answer all equal
        exe, dense_exe = engine.compile(plan), dense.compile(plan)
        if n_shuffles is None:
            n_shuffles = n_plan_shuffles(plan)
        t0 = time.perf_counter()
        res, launches = kernel_query(
            torch, ops, engine, lambda e: exe(*args, key=key), n_shuffles,
            name)
        first_s = time.perf_counter() - t0
        ref = dense_exe(*args, key=key)
        want = library()
        torch.cuda.synchronize()
        for label, got, dns, lib in outputs(res, ref, want):
            check(torch.equal(got, dns), f"{name}: {label} kernel vs dense")
            check(torch.equal(got, lib), f"{name}: {label} vs the library "
                                         f"answer")
        same_accum(torch, res.stats, ref.stats, name)
        check(int(res.stats.dropped) == 0, f"{name}: dropped "
                                           f"{int(res.stats.dropped)}")
        emit(phase=name, schedule=[list(r) for r in plan.schedule()],
             shuffles=n_shuffles, launches=launches,
             route_log=[n_shuffles, 0], stats=accum_dict(res.stats),
             first_query_s=first_s, **rec)
        queries.append({"name": name, "exe": exe, "dense_exe": dense_exe,
                        "args": args, "key": key, "library": library,
                        "launches": launches})
        return res

    # -- search: Theorem 4.1 ---------------------------------------------
    nq, m, M = SEARCH
    q = torch.randn(nq, device=dev, generator=gen)
    piv = torch.randn(m, device=dev, generator=gen)
    plan = multisearch_plan(nq, m, M)
    plan_query(
        "search", plan, (q, piv), 5,
        lambda: torch.searchsorted(torch.sort(piv).values, q,
                                   side="left").to(torch.int32),
        lambda r, d, w: [("buckets", r.buckets, d.buckets, w)],
        n_queries=nq, n_pivots=m, M=M, V=plan.n_nodes,
        answer="torch.searchsorted(torch.sort(pivots), queries)")

    # -- prefix: Lemma 2.2, physical, int32 ------------------------------
    n, M = PREFIX
    x = torch.randint(-100, 100, (n,), dtype=torch.int32, device=dev,
                      generator=gen)
    for inclusive in (True, False):
        tag = "inclusive" if inclusive else "exclusive"
        plan_query(
            f"prefix-{tag}", prefix_plan(n, M, physical=True,
                                         inclusive=inclusive), (x,), None,
            (lambda inc=inclusive: torch.cumsum(x, 0, dtype=torch.int32)
             - (0 if inc else x)),
            lambda r, d, w: [("values", r.values, d.values, w)],
            n=n, M=M, answer="torch.cumsum")

    # -- funnel: Theorem 3.2, write funnel and two CRCW steps -------------
    P, N, M = FUNNEL
    addrs = torch.randint(0, N, (P,), dtype=torch.int32, device=dev,
                          generator=gen)
    silent = torch.rand(P, device=dev, generator=gen) < 1 / 16
    addrs = torch.where(silent, -1, addrs)
    vals = torch.randint(-1000, 1000, (P,), dtype=torch.int32, device=dev,
                         generator=gen)
    mem0 = torch.randint(-1000, 1000, (N,), dtype=torch.int32, device=dev,
                         generator=gen)
    live = addrs >= 0
    combine_s = []
    fold = funnel._combine_mailbox_slots

    def timed_fold(payload, valid, op):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fold(payload, valid, op)
        torch.cuda.synchronize()
        combine_s.append({"slots": list(payload.shape),
                          "s": time.perf_counter() - t0})
        return out

    fplan = funnel_write_plan(P, N, M, torch.add, identity=0,
                              dtype=torch.int32)
    # one shuffle a funnel level; the root stage applies, it does not move
    levels = sum(s.name.startswith("funnel-level") for s in fplan.stages)
    funnel._combine_mailbox_slots = timed_fold
    try:
        plan_query(
            "funnel", fplan, (addrs, vals, mem0), None,
            lambda: mem0.clone().index_add_(0, addrs[live].long(),
                                            vals[live]),
            lambda r, d, w: [("memory", r.memory, d.memory, w)],
            n_shuffles=levels, P=P, N=N, M=M, silent=int(silent.sum()),
            answer="index_add_")
    finally:
        funnel._combine_mailbox_slots = fold
    emit(phase="funnel-combine", levels=combine_s[:levels],
         note="host seconds of _combine_mailbox_slots (one loop step a "
              "slot), kernel engine, ending in a synchronize")

    # the two-step parallel max of tests/test_paper_algorithms.py:172:
    # step 0 writes every value to cell 0, step 1 reads the max and
    # writes max - value
    zeros = torch.zeros((P,), dtype=torch.int32, device=dev)
    prog = PRAMProgram(read_addr=lambda s, t: zeros,
                       compute=lambda s, v, t: (s, zeros,
                                                s if t == 0 else v - s))
    state = torch.randn(P, device=dev, generator=gen)
    memory = torch.full((N,), -1e30, device=dev)
    crcw = {}
    for label, eng in (("kernel", engine), ("dense", dense)):
        def run(e):
            return simulate_crcw(prog, state, memory, 2, M, torch.maximum,
                                 engine=e, with_accum=True)
        if label == "kernel":
            t0 = time.perf_counter()
            out, launches = kernel_query(torch, ops, eng, run, 2 * levels,
                                         "crcw")
            crcw_s = time.perf_counter() - t0
        else:
            out = run(eng)
        crcw[label] = out
    top = state.max()
    want = memory.clone()
    want[0] = torch.maximum(top, top - state.min())
    check(torch.equal(crcw["kernel"][1], crcw["dense"][1]),
          "crcw: memory kernel vs dense")
    check(torch.equal(crcw["kernel"][1], want), "crcw: memory vs the max")
    same_accum(torch, crcw["kernel"][2], crcw["dense"][2], "crcw")
    emit(phase="crcw", P=P, N=N, M=M, steps=2, launches=launches,
         route_log=[2 * levels, 0], stats=accum_dict(crcw["kernel"][2]),
         query_s=crcw_s)
    paths = {"crcw": launches}
    del crcw

    # -- bsp: Theorem 3.1, a two-superstep bucket sort -------------------
    Pp, M, n = BSP
    keys = torch.rand(Pp, n // Pp, device=dev, generator=gen)
    inf = torch.tensor(float("inf"), device=dev)

    def superstep(t, ids, st, inbox, ok):
        if t == 0:      # each key to processor floor(key * P)
            dests = (st["keys"] * Pp).to(torch.int32).clamp_max(Pp - 1)
            return st, dests, st["keys"]
        # sort the inbox locally, send nothing
        local = torch.sort(torch.where(ok, inbox, inf), dim=1).values
        return ({"keys": local, "count": ok.sum(1)},
                torch.full((Pp, 1), -1, dtype=torch.int32, device=dev),
                torch.zeros((Pp, 1), device=dev))

    def concat(r):
        st = r.proc_state
        slot = torch.arange(M, device=dev)[None, :]
        return st["keys"][slot < st["count"][:, None]]

    def bsp_outputs(r, d, w):
        check(r.dropped_per_step.tolist() == [0, 0],
              f"bsp: dropped {r.dropped_per_step.tolist()}")
        check(torch.equal(r.proc_state["count"], d.proc_state["count"]),
              "bsp: counts kernel vs dense")
        return [("keys", concat(r), concat(d), w)]

    plan_query("bsp", bsp_plan(BSPProgram(superstep), 2, M, Pp,
                               torch.tensor(0.0)),
               ({"keys": keys},), None,
               lambda: torch.sort(keys.reshape(-1)).values, bsp_outputs,
               processors=Pp, M=M, keys=n, answer="torch.sort")

    # -- queues: Theorem 4.2, no shuffle ---------------------------------
    n, V, cap, M = QUEUES
    dests0 = torch.randint(1, V, (n,), dtype=torch.int32, device=dev,
                           generator=gen)
    hot = torch.randperm(n, device=dev, generator=gen)[:QUEUE_SKEW * (n // V)]
    dests0[hot] = 0
    fwd = torch.randint(0, V, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    tmpl = {"id": torch.tensor(0, dtype=torch.int32),
            "hop": torch.tensor(0, dtype=torch.int32)}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qs = make_queues(V, cap, tmpl, device=dev)
    qs, overflow = enqueue(qs, dests0, {"id": ids, "hop": torch.zeros_like(
        ids)})
    sizes = qs.size.clone()
    sink = []

    def forward(r, node_ids, items, ok):
        # originals hop once to fwd[id]; arrivals are absorbed, in order
        hop = items["hop"]
        sink.append((items["id"].clone(), ok & (hop == 1)))
        dest = torch.where(ok & (hop == 0), fwd[items["id"].long()], -1)
        return dest, {"id": items["id"], "hop": torch.ones_like(hop)}

    qs = run_queued(forward, qs, M, n_rounds=64)
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0
    check(int(overflow) == 0 and int(qs.size.sum()) == 0,
          f"queues: overflow {int(overflow)}, left {int(qs.size.sum())}")
    check(int(sizes[0]) == QUEUE_SKEW * (n // V),
          f"queues: hot queue {int(sizes[0])}")
    got_ids = torch.stack([s[0] for s in sink])
    absorbed = torch.stack([s[1] for s in sink])
    r_idx, v_idx, s_idx = torch.nonzero(absorbed, as_tuple=True)
    order = torch.argsort(v_idx, stable=True)     # (node, round, slot)
    got = got_ids[r_idx, v_idx, s_idx][order]
    # the stable-sort answer: an original of rank p in its first queue
    # leaves in round p // M from slot p % M; each node absorbs its
    # arrivals in the order they were enqueued: by round, source, slot
    rank, _ = fifo_rank(dests0, V)
    rank = rank.long()
    key = (((fwd.long() * (cap // M + 1) + rank // M) * V + dests0.long())
           * M + rank % M)
    want = ids[torch.argsort(key, stable=True)]
    check(torch.equal(got, want), "queues: FIFO order of the absorbed items")
    check(torch.equal(v_idx[order].to(torch.int32), fwd[want.long()]),
          "queues: absorbed at the wrong node")
    _, _, left = dequeue(qs, M)
    check(not bool(left.any()), "queues: items left after the drain")
    launches = {k: v for k, v in ops.launches().items() if v}
    check(not launches, f"queues launched kernels: {launches}")
    emit(phase="queues", items=n, queues=V, capacity=cap, M=M,
         hot_queue=int(sizes[0]), mean_queue=n / V,
         max_other=int(sizes[1:].max()), rounds=len(sink),
         host_s=queue_s, fifo="equal to the stable-sort answer")
    return queries, paths


def search_timings(torch, queries) -> list:
    """Phase search-timings: host-clock medians of 5 after a warm-up of
    each query on the kernel engine, on the dense engine and for its
    library answer; its kernels' launches, and the CUDA-event medians of
    those launches (the calls of one query recorded, then timed)."""
    from repro_torch.core import kshuffle
    from repro_torch.kernels import bincount, bitonic_sort, ops
    rows = []
    for qd in queries:
        exe, dense_exe, args, key = (qd["exe"], qd["dense_exe"], qd["args"],
                                     qd["key"])
        recorder = Recorder(ops)
        kshuffle._kops = recorder
        try:
            exe(*args, key=key)
        finally:
            kshuffle._kops = ops
        torch.cuda.synchronize()
        kern = {"bincount_tiles": 0.0, "bitonic_sort": 0.0}
        for name, a, b in recorder.calls:
            fn = (bincount.bincount_tiles_cuda if name == "bincount_tiles"
                  else bitonic_sort.bitonic_sort_cuda)
            kern[name] += event_ms(lambda: fn(a, b), torch)
        del recorder
        row = {"query": qd["name"],
               "kernel_engine_ms": host_ms(lambda: exe(*args, key=key),
                                           torch),
               "dense_engine_ms": host_ms(lambda: dense_exe(*args, key=key),
                                          torch),
               "library_ms": host_ms(qd["library"], torch),
               "launches": qd["launches"], "kernel_event_ms": kern}
        rows.append(row)
        emit(phase="search-timings", **row)
    return rows


def chain_work(pts, counts, h):
    """Bytes and operations ``monotone_chain`` needs on these inputs
    (``kernels.chain.monotone_chain_work``): about 4 c - h turn tests for a
    run of c points whose hull has h (each chain tests once a push and
    once a pop)."""
    from repro_torch.kernels.chain import monotone_chain_work
    V, L, _ = pts.shape
    nops, nbytes = monotone_chain_work(
        V, L, int(counts.sum()),
        int((4 * counts.long() - h.long()).clamp_min(0).sum()))
    return nbytes, nops


def chain_longest(pts, counts) -> int:
    """Turn tests of the longest chain of one ``monotone_chain`` call: each
    run's lower chain walked forward and upper chain backward on the host,
    counting every test (one a pop, one that stops the pops), with the
    kernel's arithmetic (float32 differences and second product, the first
    product fused, subnormals flushed), so that it pops what the kernel
    pops.  For the serial floor."""
    import numpy as np
    tiny = 2.0 ** -126

    def f32(v):
        v = float(np.float32(v))
        return 0.0 if abs(v) < tiny else v

    def turn(a, b, p):
        q = f32(f32(b[1] - a[1]) * f32(p[0] - a[0]))
        r = f32(b[0] - a[0]) * f32(p[1] - a[1]) - q
        return 0.0 if abs(r) < tiny else r

    P = pts.cpu().numpy().astype(np.float64)
    C = counts.cpu().numpy().clip(0, P.shape[1])
    longest = 0
    for v in range(len(C)):
        run = [tuple(p) for p in P[v, :C[v]]]
        for order in (run, run[::-1]):
            stack, tests = [], 0
            for p in order:
                while len(stack) >= 2:
                    tests += 1
                    if turn(stack[-2], stack[-1], p) > 0:
                        break
                    stack.pop()
                stack.append(p)
            longest = max(longest, tests)
    return longest


def geometry_phases(torch, dev, ops, engine, dense):
    """Phases hull2d, geometry-chain, hull3d and lp: the paper's geometry
    at full size on the kernel engine and the dense one, with the same
    draw, each answer held against scipy in float64 on the host; and
    ``monotone_chain`` against its plain version at the 2-D hull's two
    calls and on a run whose every point is extreme.  Returns the queries
    to time, the chain's summary row and the launches of each path."""
    import numpy as np
    from scipy.optimize import linprog
    from scipy.spatial import ConvexHull
    from repro_torch.core import (convex_hull_3d_oracle, hull2d_plan,
                                  hull3d_plan, lp_plan, tree_height)
    from repro_torch.core.geometry import chain as geo_chain
    from repro_torch.kernels import chain as chain_kernel
    # the 3-D hull's facet test and the LP's feasibility product are
    # float32 matmuls: true float32, set here rather than by earlier phases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(23)
    queries = []

    def geometry_query(name, plan, args, key, n_shuffles, chain_launches,
                       outputs, answer, run=None, **rec):
        # kernel engine, then the dense engine on the same draw: outputs
        # and CostAccum equal; then the answer against scipy
        exe, dense_exe = engine.compile(plan), dense.compile(plan)
        t0 = time.perf_counter()
        res, launches = kernel_query(
            torch, ops, engine, run or (lambda e: exe(*args, key=key)),
            n_shuffles, name, others={"monotone_chain": chain_launches})
        first_s = time.perf_counter() - t0
        ref = dense_exe(*args, key=key)
        torch.cuda.synchronize()
        for label, got, dns in outputs(res, ref):
            check(torch.equal(got, dns), f"{name}: {label} kernel vs dense")
        same_accum(torch, res.stats, ref.stats, name)
        check(int(res.stats.dropped) == 0, f"{name}: dropped "
                                           f"{int(res.stats.dropped)}")
        t0 = time.perf_counter()
        found = answer(res)
        scipy_answer = found.pop("scipy")
        emit(phase=name, schedule=[list(r) for r in plan.schedule()],
             shuffles=n_shuffles, launches=launches,
             route_log=[n_shuffles, 0], stats=accum_dict(res.stats),
             first_query_s=first_s, answer_s=time.perf_counter() - t0,
             **found, **rec)
        queries.append({"name": name, "exe": exe, "dense_exe": dense_exe,
                        "args": args, "key": key, "launches": launches,
                        "scipy": scipy_answer})
        return res

    # -- hull2d: §1.4 + §4.3, 2^24 points --------------------------------
    n, M = HULL2D
    pts_np = rng.standard_normal((n, 2), dtype=np.float32)
    pts = torch.from_numpy(pts_np).to(dev)
    plan = hull2d_plan(n, M)
    # the rounds that chain: merge-0 and the finalize at full size
    chain_stages = [st.name for st in plan.stages
                    if st.name.startswith(("merge-", "finalize"))]
    recorder = Recorder(ops)

    def run_recorded(e):
        geo_chain.ops = recorder
        try:
            return e.compile(plan)(pts, key=5)
        finally:
            geo_chain.ops = ops

    def hull2d_answer(res):
        # a certificate on the card in float64, then scipy's vertex set
        h = int(res.count)
        hull = res.points[:h].double()
        p64 = pts.double()
        nxt, nxt2 = hull.roll(-1, 0), hull.roll(-2, 0)
        turn = ((nxt[:, 0] - hull[:, 0]) * (nxt2[:, 1] - nxt[:, 1])
                - (nxt[:, 1] - hull[:, 1]) * (nxt2[:, 0] - nxt[:, 0]))
        check(h >= 3 and bool((turn > 0).all()),
              "hull2d: the hull is not strictly convex and counter-clockwise")
        rest = hull[1:]
        check(bool(((rest[:, 0] > hull[0, 0]) | ((rest[:, 0] == hull[0, 0])
                                                 & (rest[:, 1] > hull[0, 1])))
                   .all()), "hull2d: the hull does not start at its lex-min")
        for v in hull:
            check(bool((p64 == v).all(1).any()),
                  f"hull2d: vertex {v.tolist()} is not an input point")
        outside = min(float(((b[0] - a[0]) * (p64[:, 1] - a[1])
                             - (b[1] - a[1]) * (p64[:, 0] - a[0])).min())
                      for a, b in zip(hull, nxt))
        check(outside >= 0, f"hull2d: an input point lies outside the hull "
                            f"(cross {outside})")
        t0 = time.perf_counter()
        ch = ConvexHull(pts_np.astype(np.float64))
        scipy_ms = (time.perf_counter() - t0) * 1e3
        want = pts_np[ch.vertices].astype(np.float64)
        got = hull.cpu().numpy()
        check(np.array_equal(got[np.lexsort(got.T[::-1])],
                             want[np.lexsort(want.T[::-1])]),
              "hull2d: vertex set differs from scipy's ConvexHull")
        return {"vertices": h, "min_inside_cross": outside,
                "scipy": {"ms": scipy_ms, "calls": 1},
                "answer": "scipy.spatial.ConvexHull's vertex set (float64); "
                          "on the card in float64: strictly convex, CCW "
                          "from the lex-min, every vertex an input point, "
                          "every input point inside"}

    geometry_query(
        "hull2d", plan, (pts,), 5, n_plan_shuffles(plan), len(chain_stages),
        lambda r, d: [("points", r.points, d.points),
                      ("count", r.count, d.count)],
        hull2d_answer, run=run_recorded, n=n, M=M, V=plan.n_nodes)
    paths = {"hull2d": queries[-1]["launches"]}

    # -- monotone_chain against its plain version ------------------------
    # The kernel's time at each call of the query above (merge-0: 2048
    # runs; the finalize: one run) beside its bound, one call per event pair
    # and back to back.  Then the kernel against its plain version, bit for
    # bit, on CHAIN_CHECKED of merge-0's runs, on every later call, on one
    # run whose every point is extreme (the lower chain keeps them all, the
    # upper chain pops at every step), on a chain deeper than the kernel's
    # shared-memory window that one point pops to the bottom, and on
    # near-collinear runs.  The plain loop runs on host copies: each of its
    # steps is a few dozen small tensor operations and a host read, which
    # cost more as launches on the card than on the host.  Last the worst
    # case, 2^20 points all extreme, timed and checked without the plain
    # version.  The serial floor of a call: the turn tests of its longest
    # chain (counted on the host, chain_longest) times CHAIN_STEP_CYCLES at
    # the card's highest SM clock.
    from repro_torch import testing
    calls = [c[1:] for c in recorder.calls]
    check(len(calls) == len(chain_stages),
          f"hull2d: {len(calls)} monotone_chain calls recorded")
    step_ns = CHAIN_STEP_CYCLES / sm_clock_mhz() * 1e3

    def timed(label, cp, cc, h, longest=None):
        nbytes, nops = chain_work(cp, cc, h)
        run = lambda: chain_kernel.monotone_chain_cuda(cp, cc)
        rec = {"call": label, "shape": list(cp.shape),
               "live_points": int(cc.sum()), "hull_points": int(h.sum()),
               "ms": event_ms(run, torch), "b2b_ms": b2b_ms(run, torch),
               "bytes": nbytes, "ops": nops,
               "bound_ms": bound_ms(nops, nbytes)}
        if longest is not None:
            rec.update(longest_chain_tests=longest,
                       serial_floor_ms=longest * step_ns / 1e6)
        return rec

    main_calls = [timed(label, cp, cc,
                        chain_kernel.monotone_chain_cuda(cp, cc)[1])
                  for label, (cp, cc) in zip(chain_stages, calls)]
    pick = torch.linspace(0, calls[0][0].shape[0] - 1, CHAIN_CHECKED,
                          device=dev).long()
    t = torch.linspace(-20, 20, CHAIN_EXTREME, dtype=torch.float64,
                       device=dev)
    x = torch.sinh(t).float()
    window = chain_kernel.kernel_shape(1, 1 << 14)["window"]
    deep = testing.pack_runs([testing.deep_pop_run(
        window + window // 2 + 3, "lower")])
    rng_c = np.random.default_rng(29)
    near = testing.pack_runs([testing.near_collinear_run(
        CHAIN_NEAR_COLLINEAR[1], rng_c)
        for _ in range(CHAIN_NEAR_COLLINEAR[0])])
    on_dev = lambda pc: tuple(torch.from_numpy(a).to(dev) for a in pc)
    checked = ([(f"{chain_stages[0]}, {CHAIN_CHECKED} of its runs",
                 (calls[0][0][pick].contiguous(), calls[0][1][pick]))]
               + list(zip(chain_stages[1:], calls[1:]))
               + [("all-extreme",
                   (torch.stack([x, x * x], 1)[None].contiguous(),
                    torch.tensor([CHAIN_EXTREME], dtype=torch.int32,
                                 device=dev))),
                  ("deep-pop", on_dev(deep)),
                  ("near-collinear", on_dev(near))])
    max_err = 0.0
    per_call = []
    for label, (cp, cc) in checked:
        got = chain_kernel.monotone_chain_cuda(cp, cc)
        got = [g.cpu() for g in got]
        t0 = time.perf_counter()
        want = chain_kernel.monotone_chain_plain(cp.cpu(), cc.cpu())
        plain_ms = (time.perf_counter() - t0) * 1e3
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"monotone_chain {label}: shape/dtype")
            if g.numel():
                max_err = max(max_err,
                              (g.double() - w.double()).abs().max().item())
            check(torch.equal(g, w),
                  f"monotone_chain {label}: differs from the plain version")
        if label == "all-extreme":
            check(int(got[1][0]) == CHAIN_EXTREME,
                  f"monotone_chain: {int(got[1][0])} of {CHAIN_EXTREME} "
                  f"points kept on the all-extreme run")
        if label == "deep-pop":
            check(got[1].tolist() == [3], f"monotone_chain deep-pop: hull "
                                          f"of {got[1].tolist()} points")
        per_call.append({**timed(label, cp, cc, got[1].to(dev),
                                 chain_longest(cp, cc)),
                         "plain_host_ms": plain_ms})
    # the worst case: every point of 2^20 extreme, so the lower chain
    # pushes every point and the upper chain pops at every step (n - 2
    # tests each)
    wp = torch.from_numpy(testing.extreme_run(CHAIN_WORST))[None].to(dev)
    wc = torch.tensor([CHAIN_WORST], dtype=torch.int32, device=dev)
    hull, h = chain_kernel.monotone_chain_cuda(wp, wc)
    check(int(h[0]) == CHAIN_WORST and torch.equal(hull, wp),
          f"monotone_chain worst case: {int(h[0])} of {CHAIN_WORST} points "
          f"kept, hull equal to the run: {torch.equal(hull, wp)}")
    nbytes, nops = chain_work(wp, wc, h)
    worst = {"call": "all-extreme, 2^20", "shape": list(wp.shape),
             "live_points": CHAIN_WORST, "hull_points": CHAIN_WORST,
             "ms": event_ms(lambda: chain_kernel.monotone_chain_cuda(wp, wc),
                            torch, reps=3),
             "bytes": nbytes, "ops": nops,
             "bound_ms": bound_ms(nops, nbytes),
             "longest_chain_tests": CHAIN_WORST - 2,
             "serial_floor_ms": (CHAIN_WORST - 2) * step_ns / 1e6}
    del wp, hull
    emit(phase="geometry-chain", main_path=main_calls, checked=per_call,
         worst_case=worst, max_abs_err=max_err,
         kernel_shape={"merge": chain_kernel.kernel_shape(
             *calls[0][0].shape[:2]), "one run": chain_kernel.kernel_shape(
                 *calls[-1][0].shape[:2])},
         step_cycles=CHAIN_STEP_CYCLES, step_ns=step_ns,
         note="kernel ms: CUDA-event medians of 7 after a warm-up, one call "
              f"per event pair; b2b_ms: {B2B_CALLS} calls between one event "
              "pair, over the calls; plain_host_ms: one call of the plain "
              "version on host copies of the inputs, host clock; equal bit "
              "for bit; serial_floor_ms: the longest chain's turn tests "
              f"times {CHAIN_STEP_CYCLES} cycles at the highest SM clock")
    # the summary row: kernel, plain version and bound on the same inputs,
    # the checked calls of the main path; the kernel at the query's own
    # calls beside it as main_path_ms
    rows = per_call[:len(chain_stages)]
    nbytes = sum(r["bytes"] for r in rows)
    nops = sum(r["ops"] for r in rows)
    chain_row = {
        "name": "monotone_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/monotone_chain.cu",
        "replaces": "src/repro/core/geometry/chain.py:60",
        "replaces_note": "no Pallas kernel: the JAX package computes the "
                         "chain as this lax.scan, outside any kernel",
        "launches": paths["hull2d"]["monotone_chain"],
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in rows),
        "b2b_ms": sum(r["b2b_ms"] for r in rows),
        "plain_ms": sum(r["plain_host_ms"] for r in rows),
        "bound_ms": bound_ms(nops, nbytes),
        "bound_by": bound_by(nops, nbytes),
        "serial_floor_ms": sum(r["serial_floor_ms"] for r in rows),
        "library_ms": None,
        "inputs": [r["call"] for r in rows],
        "plain_note": "plain version on host copies, host clock, one call",
        "main_path_ms": sum(r["ms"] for r in main_calls),
        "main_path_b2b_ms": sum(r["b2b_ms"] for r in main_calls),
        "main_path_bound_ms": bound_ms(sum(r["ops"] for r in main_calls),
                                       sum(r["bytes"] for r in main_calls)),
        "worst_case_ms": worst["ms"],
        "per_call": [{k: r.get(k) for k in ("call", "shape", "ms", "b2b_ms",
                                             "plain_host_ms", "bound_ms",
                                             "serial_floor_ms")}
                     for r in main_calls + per_call + [worst]]}
    del pts

    # -- hull3d: Theorem 3.2 on C(128, 3) facet processors ----------------
    n3, M3 = HULL3D
    p3_np = rng.standard_normal((n3, 3), dtype=np.float32)
    p3 = torch.from_numpy(p3_np).to(dev)
    plan3 = hull3d_plan(n3, M3)
    levels3 = tree_height(math.comb(n3, 3), max(2, M3 // 2))

    def hull3d_answer(res):
        got = np.flatnonzero(res.mask.cpu().numpy())
        p64 = p3_np.astype(np.float64)
        check(np.array_equal(got, np.sort(ConvexHull(p64).vertices)),
              "hull3d: vertices differ from scipy's ConvexHull")
        t0 = time.perf_counter()
        check(np.array_equal(got, convex_hull_3d_oracle(p3_np)),
              "hull3d: vertices differ from convex_hull_3d_oracle")
        return {"vertices": int(got.size),
                "oracle_s": time.perf_counter() - t0,
                "scipy": {"fn": lambda: ConvexHull(p64), "calls": 5},
                "answer": "scipy.spatial.ConvexHull(points).vertices and "
                          "convex_hull_3d_oracle, float64"}

    geometry_query(
        "hull3d", plan3, (p3,), None, 3 * levels3, 0,
        lambda r, d: [("mask", r.mask, d.mask)], hull3d_answer,
        n=n3, M=M3, processors=math.comb(n3, 3), funnel_levels=levels3)
    paths["hull3d"] = queries[-1]["launches"]

    # -- lp: fixed-dimensional LP by Min-CRCW over C(256, 3) bases --------
    nl, dl, Ml = LP
    A_np = rng.standard_normal((nl, dl), dtype=np.float32)
    b_np = rng.uniform(1, 2, nl).astype(np.float32)
    c_np = np.asarray(LP_C, np.float32)
    args = tuple(torch.from_numpy(v).to(dev) for v in (c_np, A_np, b_np))
    plan_lp = lp_plan(nl, dl, Ml)
    levels_lp = tree_height(math.comb(nl, dl), max(2, Ml // 2))

    def highs():
        return linprog(c_np.astype(np.float64), A_ub=A_np.astype(np.float64),
                       b_ub=b_np.astype(np.float64),
                       bounds=[(None, None)] * dl, method="highs")

    def lp_answer(res):
        ref = highs()
        check(ref.status == 0, f"lp: HiGHS status {ref.status}")
        obj = float(res.objective)
        check(abs(obj - ref.fun) <= LP_RTOL * abs(ref.fun),
              f"lp: objective {obj} vs HiGHS {ref.fun}")
        return {"objective": obj, "highs_objective": float(ref.fun),
                "x": res.x.tolist(), "highs_x": ref.x.tolist(),
                "scipy": {"fn": highs, "calls": 5},
                "answer": f"scipy.optimize.linprog(method='highs'), float64, "
                          f"objective within {LP_RTOL} relative"}

    geometry_query(
        "lp", plan_lp, args, None, levels_lp, 0,
        lambda r, d: [("x", r.x, d.x), ("objective", r.objective,
                                        d.objective)],
        lp_answer, n=nl, d=dl, M=Ml, bases=math.comb(nl, dl),
        funnel_levels=levels_lp)
    paths["lp"] = queries[-1]["launches"]
    return queries, chain_row, paths


def geometry_timings(torch, queries, chain_row) -> list:
    """Phase geometry-timings: host-clock medians of 5 after a warm-up of
    each query on the kernel engine and the dense engine, and of scipy's
    answer on the host (the 2-D hull's scipy call is timed once, in its
    check: a few seconds a call); the launches of each query, and for the
    2-D hull ``monotone_chain``'s CUDA-event ms at its two calls beside
    their bound."""
    rows = []
    for qd in queries:
        exe, dense_exe, args, key = (qd["exe"], qd["dense_exe"], qd["args"],
                                     qd["key"])
        sp = qd["scipy"]
        row = {"query": qd["name"],
               "kernel_engine_ms": host_ms(lambda: exe(*args, key=key),
                                           torch),
               "dense_engine_ms": host_ms(lambda: dense_exe(*args, key=key),
                                          torch),
               "scipy_ms": sp["ms"] if "ms" in sp
               else statistics.median(host_times(sp["fn"], torch)),
               "scipy_calls": sp["calls"], "launches": qd["launches"]}
        if qd["name"] == "hull2d":
            row["monotone_chain"] = {
                "ms": chain_row["main_path_ms"],
                "bound_ms": chain_row["main_path_bound_ms"],
                "launches": chain_row["launches"]}
        rows.append(row)
        emit(phase="geometry-timings", **row)
    return rows


#: the recovery, obs and query-service phases: the sort and 2-D hull of
#: the main path (N_MAIN, M_MAIN and HULL2D), the splitter seeds
#: batch sizes of the batch phases: four queries of the device-bound
#: families, two of the host-bound funnel, 3-D hull and LP
BATCH_DEVICE, BATCH_HOST = 4, 2
#: host-clock repetitions of the batch timings of the families that run a
#: host loop a round (funnel, 3-D hull, LP: seconds a batch), cut from 5 to
#: keep the script within its time limit
BATCH_HOST_REPS = 3
#: the sort's batch: SEEDS and one more seed
BATCH_SEEDS = SEEDS + (404,)


def batch_query(torch, ops, engine, name, plan, inputs, keys, shuffles: int,
                others=None, whp: bool = False, answer=None,
                profile: bool = False, reps: int = 5, **rec):
    """Phase batch-<name>: ``exe.batch(B)`` of B stacked queries on the
    kernel engine against B single calls.  The launch counts and the route
    log are set to 0 just before one single call and read just after, then
    the same for the batch: the batch launches each kernel exactly as often
    as the one query (``shuffles`` shuffles; ``others``: the kernels
    besides the shuffle's, with their launches a query), every shuffle on
    the kernel route, every ``bincount_tiles`` launch single-pass.  Every
    row of every output leaf and every stats field equals its single call,
    with no drops.  Then host-clock medians of ``reps`` of the batch and
    of B single calls in a row, and with ``profile`` one run of each under
    torch.profiler (device ms by kernel, launches).

    The sort's and the 2-D hull's entry capacity holds with high
    probability only (3 n / V slots a bucket between a random sample's
    splitters, the JAX package's rule; ROADMAP Queue C).  For them
    (``whp``) a row may drop, as its single call does bit for bit: the
    drops are recorded, and ``answer(i, single)`` holds each row that
    does not drop to its library answer."""
    from repro_torch._tree import tree_leaves, tree_map
    B = len(keys)
    exe = engine.compile(plan)

    def row(i):
        return tree_map(lambda a: a[i], tuple(inputs))

    def counted(run):
        ops.reset_launches()
        engine.route_log.reset()
        out = run()
        torch.cuda.synchronize()
        return out, ops.launches(), engine.route_log.snapshot()

    single0, one, route_one = counted(lambda: exe(*row(0), key=keys[0]))
    out, launched, route = counted(lambda: exe.batch(B)(*inputs, keys=keys))
    check(route == route_one == (shuffles, 0),
          f"batch-{name}: routes {route}, one query {route_one}, want "
          f"({shuffles}, 0)")
    check(launched == one, f"batch-{name}: the batch launched {launched}, "
                           f"one query {one}")
    for k in SHUFFLE_KERNELS:
        check(one[k] == route[0], f"batch-{name}: {k} launched {one[k]} "
                                  f"times for {route[0]} shuffles")
    other = {k: v for k, v in one.items()
             if v and not k.startswith(("bincount_tiles", "bitonic_sort"))}
    check(other == dict(others or {}),
          f"batch-{name}: other kernels {other}, want {others}")
    leaves = tree_leaves(out)
    dropped = []
    for i in range(B):
        single = single0 if i == 0 else exe(*row(i), key=keys[i])
        for j, (g, w) in enumerate(zip(leaves, tree_leaves(single))):
            check(g.shape[1:] == w.shape and torch.equal(g[i], w),
                  f"batch-{name}: row {i} leaf {j} differs from its "
                  f"single call")
        drops = int(single.stats.dropped)
        dropped.append(drops)
        check(whp or drops == 0, f"batch-{name}: row {i} dropped {drops}")
        if answer is not None and drops == 0:
            check(answer(i, single),
                  f"batch-{name}: row {i} differs from its library answer")
        del single
    del out, leaves, single0
    batch_ms = host_ms(lambda: exe.batch(B)(*inputs, keys=keys), torch, reps)
    seq_ms = host_ms(lambda: [exe(*row(i), key=keys[i]) for i in range(B)],
                     torch, reps)
    if profile:
        rec["profile"] = {
            "batch": profiled(lambda: exe.batch(B)(*inputs, keys=keys),
                              torch, top=8),
            "sequential": profiled(
                lambda: [exe(*row(i), key=keys[i]) for i in range(B)],
                torch, top=8)}
    launched = {k: v for k, v in launched.items() if v}
    emit(phase=f"batch-{name}", B=B, shuffles=route[0], launches=launched,
         route_log=list(route), dropped=dropped, batch_ms=batch_ms,
         sequential_ms=seq_ms, sequential_over_batch=seq_ms / batch_ms,
         queries_per_s=B / (batch_ms / 1e3),
         sequential_queries_per_s=B / (seq_ms / 1e3),
         timing=f"host-clock medians of {reps} after a warm-up, each "
                f"ending in a synchronize: batch({B}) against {B} single "
                f"calls",
         **rec)
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def batch_phases(torch, dev, ops, engine) -> dict:
    """Phases batch-*: every plan family's ``exe.batch(B)`` at chip_smoke's
    main sizes on the kernel engine (see :func:`batch_query`).  Inputs are
    drawn from a generator of their own.  Returns the launches of each
    batch."""
    import numpy as np
    from repro_torch.core import (BSPProgram, bsp_plan, funnel_write_plan,
                                  hull2d_plan, hull3d_plan, lp_plan,
                                  multisearch_plan, prefix_plan, sort_plan,
                                  tree_height)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    Bd, Bh = BATCH_DEVICE, BATCH_HOST
    paths = {}

    x = torch.randn(Bd, N_MAIN, device=dev, generator=gen)
    plan = sort_plan(N_MAIN, M_MAIN)
    paths["batch-sort"] = batch_query(
        torch, ops, engine, "sort", plan, (x,), list(BATCH_SEEDS),
        n_plan_shuffles(plan), n=N_MAIN, M=M_MAIN, whp=True, profile=True,
        answer=lambda i, r: torch.equal(r.values, torch.sort(x[i]).values))
    del x

    nq, m, M = SEARCH
    q = torch.randn(Bd, nq, device=dev, generator=gen)
    piv = torch.randn(Bd, m, device=dev, generator=gen)
    plan = multisearch_plan(nq, m, M)
    paths["batch-search"] = batch_query(
        torch, ops, engine, "search", plan, (q, piv), [5, 6, 7, 8],
        n_plan_shuffles(plan), n_queries=nq, n_pivots=m, M=M, V=plan.n_nodes,
        slots_a_query=plan.n_nodes * nq)
    del q, piv

    n, M = PREFIX
    xi = torch.randint(-100, 100, (Bd, n), dtype=torch.int32, device=dev,
                       generator=gen)
    for inclusive in (True, False):
        tag = "inclusive" if inclusive else "exclusive"
        plan = prefix_plan(n, M, physical=True, inclusive=inclusive)
        paths[f"batch-prefix-{tag}"] = batch_query(
            torch, ops, engine, f"prefix-{tag}", plan, (xi,), [None] * Bd,
            n_plan_shuffles(plan), n=n, M=M)
    del xi

    Pp, M, n = BSP
    keys = torch.rand(Bd, Pp, n // Pp, device=dev, generator=gen)
    inf = torch.tensor(float("inf"), device=dev)

    def superstep(t, ids, st, inbox, ok):
        # one query's bucket sort; a batch runs it under torch.func.vmap
        if t == 0:
            dests = (st["keys"] * Pp).to(torch.int32).clamp_max(Pp - 1)
            return st, dests, st["keys"]
        local = torch.sort(torch.where(ok, inbox, inf), dim=1).values
        return ({"keys": local, "count": ok.sum(1)},
                torch.full((Pp, 1), -1, dtype=torch.int32, device=dev),
                torch.zeros((Pp, 1), device=dev))

    plan = bsp_plan(BSPProgram(superstep), 2, M, Pp, torch.tensor(0.0))
    paths["batch-bsp"] = batch_query(
        torch, ops, engine, "bsp", plan, ({"keys": keys},), [None] * Bd,
        n_plan_shuffles(plan), processors=Pp, M=M, n_keys=n)
    del keys

    n, M = HULL2D
    pts = torch.randn(Bd, n, 2, device=dev, generator=gen)
    plan = hull2d_plan(n, M)
    chain = sum(st.name.startswith(("merge-", "finalize"))
                for st in plan.stages)
    paths["batch-hull2d"] = batch_query(
        torch, ops, engine, "hull2d", plan, (pts,), [5, 6, 7, 8],
        n_plan_shuffles(plan), others={"monotone_chain": chain}, whp=True,
        profile=True, n=n, M=M)
    del pts

    P, N, M = FUNNEL
    addrs = torch.randint(0, N, (Bh, P), dtype=torch.int32, device=dev,
                          generator=gen)
    addrs = torch.where(torch.rand(Bh, P, device=dev, generator=gen)
                        < 1 / 16, -1, addrs)
    vals = torch.randint(-1000, 1000, (Bh, P), dtype=torch.int32,
                         device=dev, generator=gen)
    mem0 = torch.randint(-1000, 1000, (Bh, N), dtype=torch.int32,
                         device=dev, generator=gen)
    plan = funnel_write_plan(P, N, M, torch.add, identity=0,
                             dtype=torch.int32)
    # one shuffle a funnel level; the root stage applies, it does not move
    levels = sum(s.name.startswith("funnel-level") for s in plan.stages)
    paths["batch-funnel"] = batch_query(
        torch, ops, engine, "funnel", plan, (addrs, vals, mem0), [None] * Bh,
        levels, reps=BATCH_HOST_REPS, P=P, N=N, M=M)
    del addrs, vals, mem0

    n3, M3 = HULL3D
    p3 = torch.randn(Bh, n3, 3, device=dev, generator=gen)
    paths["batch-hull3d"] = batch_query(
        torch, ops, engine, "hull3d", hull3d_plan(n3, M3), (p3,),
        [None] * Bh, 3 * tree_height(math.comb(n3, 3), max(2, M3 // 2)),
        reps=BATCH_HOST_REPS, n=n3, M=M3, processors=math.comb(n3, 3))
    del p3

    nl, dl, Ml = LP
    A = torch.randn(Bh, nl, dl, device=dev, generator=gen)
    b = torch.rand(Bh, nl, device=dev, generator=gen) + 1
    c = torch.tensor(np.asarray(LP_C, np.float32), device=dev).expand(Bh, -1)
    paths["batch-lp"] = batch_query(
        torch, ops, engine, "lp", lp_plan(nl, dl, Ml), (c, A, b),
        [None] * Bh, tree_height(math.comb(nl, dl), max(2, Ml // 2)),
        reps=BATCH_HOST_REPS, n=nl, d=dl, M=Ml, bases=math.comb(nl, dl))
    return paths


SERVICE_SEEDS = (101, 5)
#: the device-bound query mix: the service's sort, multisearch and 2-D hull
#: families at chip_smoke's own sizes, four queries a dispatch
SERVICE_MIX = dict(families=("sort", "multisearch", "hull2d"), n_queries=32,
                   sort_n=1 << 22, sort_M=8192, hull_n=1 << 22, hull_M=8192,
                   ms_queries=65_536, ms_pivots=1_024, ms_M=64)
#: the JAX package's observability demo (examples/obs_demo.py): its
#: traffic, its faults, Poisson arrivals at 800 qps, a 2 ms sort tier
DEMO_TRAFFIC = dict(n_queries=48, seed=7)
DEMO_FAULTS = dict(fail_at=(3, 11), seed=7)


def _ckpt_bytes(ck) -> list:
    """Bytes of each durable checkpoint of ``ck``, by round."""
    return [[r, sum(p.stat().st_size for p in
                    (ck.root / f"step_{r:08d}").glob("*.npy"))]
            for r in ck.rounds()]


def recovery_phase(torch, dev, ops, engine, dense, tmp):
    """Phase recovery: the main-path sort and the 2-D hull through
    ``run_plan_with_recovery`` on the kernel engine, a shard failure
    injected at their second shuffle attempt (the sort's local sort, the
    hull's merge-0) and recovered from round-boundary checkpoints (every
    stage; synchronous, then asynchronous writes for the sort); then the
    sort killed on the kernel engine and resumed on the dense one from its
    newest checkpoint.  Outputs and CostAccum equal the fault-free run bit
    for bit; launches counted per run (the replay included); host ms of
    the fault-free and recovered runs; bytes of each checkpoint."""
    import numpy as np
    from repro_torch.core import execute_plan, hull2d_plan, sort_plan
    from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                           ShardFailure, resume_plan,
                                           run_plan_with_recovery)
    from repro_torch._tree import tree_leaves
    sort_seed, hull_seed = SERVICE_SEEDS
    gen = torch.Generator(device=dev)
    gen.manual_seed(sort_seed)
    x = torch.randn(N_MAIN, device=dev, generator=gen)
    pts = torch.from_numpy(np.random.default_rng(hull_seed).standard_normal(
        (HULL2D[0], 2), dtype=np.float32)).to(dev)
    queries = {"sort": (sort_plan(N_MAIN, M_MAIN), x, sort_seed),
               "hull2d": (hull2d_plan(*HULL2D), pts, hull_seed)}
    rec = {"n": N_MAIN, "M": M_MAIN, "hull2d": list(HULL2D)}
    launches = {}

    def same(got, want, ctx):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            check(g.device == w.device and torch.equal(g, w),
                  f"{ctx}: differs from the fault-free run")

    for name, (plan, data, key) in queries.items():
        chain = sum(st.name.startswith(("merge-", "finalize"))
                    for st in plan.stages)
        n_shuffles = n_plan_shuffles(plan)
        want, fault_free = kernel_query(
            torch, ops, engine, lambda e: execute_plan(plan, e, (data,),
                                                       key=key),
            n_shuffles, f"recovery {name} fault-free",
            others={"monotone_chain": chain} if chain else None)
        check(int(want.stats.dropped) == 0, f"recovery {name}: dropped")
        modes = {"sync": False, "async": True} if name == "sort" else \
            {"sync": False}
        for mode, async_save in modes.items():
            ck = Checkpointer(tmp / f"{name}-{mode}", plan=plan, every=1,
                              async_save=async_save)
            # the failed attempt shuffles nothing; merge-0's reducer has
            # run its chain before the shuffle fails, so the replay runs it
            # once more
            (got, rep), recovered = kernel_query(
                torch, ops, engine, lambda e: run_plan_with_recovery(
                    plan, e, (data,), key=key,
                    faults=FaultConfig(fail_at=(1,)), checkpointer=ck),
                n_shuffles, f"recovery {name} {mode}",
                others={"monotone_chain": chain + 1} if chain else None)
            same(got, want, f"recovery {name} {mode}")
            check((rep.restarts, rep.failures_injected, rep.rounds_replayed)
                  == (1, 1, 0), f"recovery {name} {mode}: {rep}")
            check(rep.checkpoints_written == len(plan.stages),
                  f"recovery {name} {mode}: {rep.checkpoints_written} "
                  f"checkpoints")
            rec[f"{name}_{mode}"] = {
                "report": vars(rep), "checkpoint_bytes": _ckpt_bytes(ck),
                "launches": recovered}
            launches[f"{name}_{mode}"] = recovered
        launches[f"{name}_fault_free"] = fault_free
    # killed on the kernel engine at the local sort, no restarts allowed;
    # resumed from the newest checkpoint (after the entry) on the dense one
    plan, data, key = queries["sort"]
    ck = Checkpointer(tmp / "sort-resume", plan=plan, every=1)
    try:
        run_plan_with_recovery(plan, engine, (data,), key=key,
                               faults=FaultConfig(fail_at=(1,)),
                               checkpointer=ck, max_restarts=0)
        check(False, "recovery resume: the injected fault did not fire")
    except ShardFailure:
        pass
    last = ck.latest()
    want = execute_plan(plan, engine, (data,), key=key)
    got, rep = resume_plan(plan, dense, (data,), key=key, checkpointer=ck)
    same(got, want, "recovery resume on the dense engine")
    check(rep.resumed_at_round == last and rep.restarts == 0,
          f"recovery resume: {rep}")
    rec["sort_resume_dense"] = {"resumed_at_round": last,
                                "report": vars(rep)}
    # host ms: fault-free, recovered with synchronous and with asynchronous
    # checkpoint writes (a fresh directory each run)
    runs = iter(range(10 ** 6))

    def recovered(async_save):
        ck = Checkpointer(tmp / f"timed-{next(runs)}", plan=plan, every=1,
                          async_save=async_save)
        run_plan_with_recovery(plan, engine, (data,), key=key,
                               faults=FaultConfig(fail_at=(1,)),
                               checkpointer=ck)

    rec["sort_host_ms"] = {
        "fault_free": host_ms(lambda: execute_plan(plan, engine, (data,),
                                                   key=key), torch),
        "recovered_sync": host_ms(lambda: recovered(False), torch, reps=3),
        "recovered_async": host_ms(lambda: recovered(True), torch, reps=3)}
    emit(phase="recovery", launches=launches, **rec)
    return {"sort": launches["sort_sync"], "hull2d": launches["hull2d_sync"]}


def obs_phase(torch, dev, ops, engine, sort_query_ms, tmp):
    """Phase obs: the main-path sort and 2-D hull queries with a recording
    Tracer on the kernel engine: the schedule measured from the trace
    equals the declared one, outputs and CostAccum equal the untraced
    query, the trace round-trips through JSON-lines and the Chrome trace;
    host ms per stage (median of 5 traced queries; each stage span ends in
    the host read of its measured rounds, so it holds its device work) and
    traced against untraced query ms.  The untraced query stays within the
    noise of phase sort-timings."""
    import numpy as np
    from repro_torch._tree import tree_leaves
    from repro_torch.core import get_engine, hull2d_plan, sort_plan
    from repro_torch.obs import (Tracer, read_jsonl, summarize,
                                 write_chrome_trace, write_jsonl)
    sort_seed, hull_seed = SERVICE_SEEDS
    gen = torch.Generator(device=dev)
    gen.manual_seed(sort_seed)
    x = torch.randn(N_MAIN, device=dev, generator=gen)
    pts = torch.from_numpy(np.random.default_rng(hull_seed).standard_normal(
        (HULL2D[0], 2), dtype=np.float32)).to(dev)
    out, launches = {}, {}
    for name, plan, data, key in (("sort", sort_plan(N_MAIN, M_MAIN), x,
                                   sort_seed),
                                  ("hull2d", hull2d_plan(*HULL2D), pts,
                                   hull_seed)):
        chain = sum(st.name.startswith(("merge-", "finalize"))
                    for st in plan.stages)
        tr = Tracer()
        traced_engine = get_engine("kernel", device=dev, tracer=tr)
        traced_exe = traced_engine.compile(plan)
        exe = engine.compile(plan)
        want = exe(data, key=key)
        got, launches[name] = kernel_query(
            torch, ops, traced_engine, lambda e: traced_exe(data, key=key),
            n_plan_shuffles(plan), f"obs {name}",
            others={"monotone_chain": chain} if chain else None)
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            check(torch.equal(g, w), f"obs {name}: traced output differs")
        s = summarize(tr)
        check(s["schedule_ok"] and s["routes"]["dense"] == 0,
              f"obs {name}: {s['stages']} {s['routes']}")
        n = write_jsonl(tr, tmp / f"{name}.jsonl")
        back = read_jsonl(tmp / f"{name}.jsonl")
        check(n == len(back) == len(tr)
              and [e.signature() for e in back] == tr.signatures(),
              f"obs {name}: JSON-lines round trip")
        m = write_chrome_trace(tr, tmp / f"{name}.perfetto.json")
        doc = json.loads((tmp / f"{name}.perfetto.json").read_text())
        check(m == len(tr) == sum(r["ph"] != "M" for r in doc["traceEvents"]),
              f"obs {name}: Chrome trace")
        # per-stage host ms, median over 5 traced queries after the one
        # above
        stage_ms = {r["stage"]: [] for r in s["stages"]}
        for _ in range(5):
            tr.clear()
            traced_exe(data, key=key)
            torch.cuda.synchronize()
            for r in summarize(tr)["stages"]:
                stage_ms[r["stage"]].append(r["wall_s"] * 1e3)
        out[name] = {
            "stages": [{"stage": r["stage"],
                        "declared_rounds": r["declared_rounds"],
                        "measured_rounds": r["measured_rounds"],
                        "items_sent": r["items_sent"],
                        "host_ms": statistics.median(stage_ms[r["stage"]])}
                       for r in s["stages"]],
            "events": len(back), "chrome_trace_events": m,
            "traced_ms": host_ms(lambda: traced_exe(data, key=key), torch),
            "untraced_ms": host_ms(lambda: exe(data, key=key), torch)}
    untraced = out["sort"]["untraced_ms"]
    check(abs(untraced - sort_query_ms) <= max(3.0, 0.25 * sort_query_ms),
          f"obs: untraced sort {untraced:.3f} ms against sort-timings "
          f"{sort_query_ms:.3f} ms")
    emit(phase="obs", sort_timings_ms=sort_query_ms, launches=launches,
         **out)
    return launches


def query_service_phase(torch, dev, ops, engine, dense):
    """Phase query-service: the JAX package's observability demo on the
    card (its 48-query traffic, shard failures at shuffle attempts 3 and
    11, max_batch 4, a 5 ms deadline with a 2 ms sort tier, Poisson
    arrivals at 800 qps on a VirtualClock), traced and untraced: results
    equal each other and run_sequential on the dense engine, both failures
    in the trace, every stage on its schedule.  Then a closed loop of the
    default traffic (192 queries, max_batch 16) on the wall clock against
    run_sequential; then the device-bound mix SERVICE_MIX at max_batch 4,
    each result equal to the sequential one, with its launches."""
    from repro_torch.core import get_engine
    from repro_torch.core.recovery import FaultConfig, with_faults
    from repro_torch.obs import Tracer, summarize
    from repro_torch.serve import QueryService, VirtualClock
    from repro_torch.serve import loadgen
    rec = {}

    def demo(traced):
        clock = VirtualClock()
        tr = Tracer(clock=clock) if traced else None
        eng = with_faults(get_engine("kernel", device=dev, tracer=tr),
                          FaultConfig(**DEMO_FAULTS))
        svc = QueryService(eng, max_batch=4, max_wait_ms=5.0, max_retries=2,
                           clock=clock)
        cfg = loadgen.TrafficConfig(**DEMO_TRAFFIC)
        suite = loadgen.make_suite(eng, cfg)
        wl = loadgen.make_workload(suite, cfg)
        svc.register(suite["sort"][0], max_wait_ms=2.0)
        t0 = time.perf_counter()
        row = loadgen.run_open_loop(svc, wl, offered_qps=800.0, clock=clock,
                                    process="poisson", seed=cfg.seed)
        torch.cuda.synchronize()
        row["wall_s"] = time.perf_counter() - t0
        results = {t.uid - 1: t.value for t in svc.finished if not t.failed}
        return row, results, tr, wl

    row, traced, tr, wl = demo(True)
    plain_row, plain, _, _ = demo(False)
    loadgen.assert_results_equal(traced, plain, "demo traced vs untraced")
    seq, _, _ = loadgen.run_sequential(dense, wl)
    loadgen.assert_results_equal(traced, seq, "demo vs sequential (dense)")
    s = summarize(tr)
    check(s["schedule_ok"] and s["recovery"]["failures"] == 2
          and s["serve"]["completed"] == 48 and s["routes"]["dense"] == 0,
          f"demo: {s['recovery']} {s['serve']} {s['routes']}")
    row.pop("metrics")
    rec["demo"] = {"row": row, "untraced_row": plain_row,
                   "dispatches": s["serve"]["dispatches"],
                   "causes": s["serve"]["causes"],
                   "requeued": s["serve"]["requeued"],
                   "recovery": s["recovery"], "routes": s["routes"]}

    # closed loop on the wall clock against sequential calls
    cfg = loadgen.TrafficConfig()
    wl = loadgen.make_workload(loadgen.make_suite(engine, cfg), cfg)
    seq, seq_s, _ = loadgen.run_sequential(engine, wl)
    svc = QueryService(engine, max_batch=16)
    results, wall = loadgen.run_closed_loop(svc, wl)
    loadgen.assert_results_equal(results, seq, "closed loop vs sequential")
    st = svc.stats()
    rec["closed_loop"] = {
        "queries": len(wl), "max_batch": 16, "dispatches": st["dispatches"],
        "mean_occupancy": st["mean_occupancy"], "wall_s": wall,
        "queries_per_s": len(wl) / wall, "sequential_s": seq_s,
        "sequential_queries_per_s": len(wl) / seq_s}

    # the device-bound mix: every result equal to the sequential one
    cfg = loadgen.TrafficConfig(**SERVICE_MIX)
    wl = loadgen.make_workload(loadgen.make_suite(engine, cfg), cfg)
    seq, seq_s, _ = loadgen.run_sequential(engine, wl)
    svc = QueryService(engine, max_batch=4)
    plans = {q.plan.name: q.plan for q in wl}
    chain = (sum(st.name.startswith(("merge-", "finalize"))
                 for st in plans["hull2d"].stages) if "hull2d" in plans
             else 0)

    def dispatched():
        # each dispatch is one batched program: its queries' outputs are
        # views of one stacked tensor
        return {(t.plan_name, t.value.stats.rounds.untyped_storage()
                 .data_ptr()) for t in svc.finished}

    def mix_shuffles(res):
        return sum(n_plan_shuffles(plans[name]) for name, _ in dispatched())

    def mix_chain(res):
        hulls = sum(name == "hull2d" for name, _ in dispatched())
        return {"monotone_chain": hulls * chain} if hulls else None

    t0 = time.perf_counter()
    (results, _), launches = kernel_query(
        torch, ops, engine, lambda e: loadgen.run_closed_loop(svc, wl),
        mix_shuffles, "query-service mix", others=mix_chain)
    wall = time.perf_counter() - t0
    loadgen.assert_results_equal(results, seq, "mix vs sequential")
    st = svc.stats()
    rec["mix"] = {
        "traffic": SERVICE_MIX, "max_batch": 4,
        "families": {f: sum(q.family == f for q in wl)
                     for f in SERVICE_MIX["families"]},
        "dispatches": st["dispatches"],
        "shuffles": launches["bincount_tiles"],
        "single_query_shuffles": sum(n_plan_shuffles(q.plan) for q in wl),
        "mean_occupancy": st["mean_occupancy"], "wall_s": wall,
        "queries_per_s": len(wl) / wall, "sequential_s": seq_s,
        "sequential_queries_per_s": len(wl) / seq_s,
        "dropped": sum(int(r.stats.dropped) for r in results.values()),
        "launches": launches}
    emit(phase="query-service", **rec)
    return launches


def service_phases(torch, dev, ops, engine, dense, sort_query_ms):
    """Phases recovery, obs and query-service (checkpoints and traces in a
    temporary directory, deleted afterwards).  Returns the launches of the
    shuffle kernels and ``monotone_chain`` on each path."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_service_"))
    try:
        rec = recovery_phase(torch, dev, ops, engine, dense, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        obs = obs_phase(torch, dev, ops, engine, sort_query_ms, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        served = query_service_phase(torch, dev, ops, engine, dense)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"recovery-sort": rec["sort"], "recovery-hull2d": rec["hull2d"],
            "obs-sort": obs["sort"], "obs-hull2d": obs["hull2d"],
            "query-service": served}


#: the sharded-gloo phase: CPU ranks over gloo at the tests' small sizes
SHARDED_GLOO_WORLD = 4
#: dist_check's cases of the sharded round machine (phase train-gloo runs
#: the training ones)
SHARDED_GLOO_CASES = ("shuffle", "rounds", "plans", "collectives",
                      "elastic", "tracer", "errors", "moe")


def sharded_phase(torch, dev, ops, engine):
    """Phase sharded: the main sizes on ``ShardedEngine(shuffle_impl=
    "kernel")`` over a one-rank NCCL group (started here, destroyed at the
    end), overlapped and with ``overlap=False``, against the kernel
    ``LocalEngine``: outputs and CostAccum equal bit for bit, no drops,
    every shuffle on the kernels (``dense == 0``), the overlapped engine's
    windows counted (``overlapped > 0``), and the launches of each query
    equal to the local engine's; host-clock medians of 5 of the three
    engines beside each other, and one profiled run of the local and the
    overlapped engine.  Returns each sharded query's launches."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.core import (ShardedEngine, hull2d_plan,
                                  multisearch_plan, sort_plan)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    backend = dist.get_backend()
    try:
        ovl = ShardedEngine(shuffle_impl="kernel", device=dev)
        seq = ShardedEngine(shuffle_impl="kernel", device=dev, overlap=False)
        check(ovl.n_shards == 1, f"sharded: {ovl.n_shards} ranks")
        gen = torch.Generator(device=dev)
        gen.manual_seed(31)
        n_q, n_piv, M_s = SEARCH
        hull = hull2d_plan(*HULL2D, align=ovl.aligned_nodes)
        queries = {
            "sort": (sort_plan(N_MAIN, M_MAIN, align=ovl.aligned_nodes),
                     (torch.randn(N_MAIN, device=dev, generator=gen),),
                     SEEDS[0], {}),
            # monotone_chain once a chaining round: merge-0, the finalize
            "hull2d": (hull, (torch.randn(HULL2D[0], 2, device=dev,
                                          generator=gen),), 5,
                       {"monotone_chain": sum(
                           st.name.startswith(("merge-", "finalize"))
                           for st in hull.stages)}),
            "multisearch": (multisearch_plan(n_q, n_piv, M_s,
                                             align=ovl.aligned_nodes),
                            (torch.randn(n_q, device=dev, generator=gen),
                             torch.randn(n_piv, device=dev, generator=gen)),
                            7, {}),
        }
        rows, paths = [], {}
        for name, (plan, args, key, others) in queries.items():
            n_shuffles = n_plan_shuffles(plan)
            runs = {}
            for tag, eng in (("local", engine), ("sharded", ovl),
                             ("sharded-seq", seq)):
                exe = eng.compile(plan)
                res, launches = kernel_query(
                    torch, ops, eng, lambda e: exe(*args, key=key),
                    n_shuffles, f"sharded {name} {tag}", others)
                overlapped = getattr(eng.route_log, "overlapped", 0)
                runs[tag] = (exe, res, launches, overlapped)
            _, want, local_launches, _ = runs["local"]
            check(int(want.stats.dropped) == 0, f"sharded {name}: dropped")
            for tag in ("sharded", "sharded-seq"):
                _, res, launches, _ = runs[tag]
                for i, (a, b) in enumerate(zip(tree_leaves(res),
                                               tree_leaves(want))):
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"sharded {name} {tag}: leaf {i} differs from "
                          f"the local engine's")
                same_accum(torch, want.stats, res.stats,
                           f"sharded {name} {tag}")
                check(launches == local_launches,
                      f"sharded {name} {tag}: launches {launches} vs "
                      f"local {local_launches}")
            check(runs["sharded"][3] > 0 and runs["sharded-seq"][3] == 0,
                  f"sharded {name}: overlapped rounds "
                  f"{runs['sharded'][3]}, {runs['sharded-seq'][3]}")
            ms = {tag: host_ms(lambda: exe(*args, key=key), torch)
                  for tag, (exe, _, _, _) in runs.items()}
            # where the sharded engine's extra time goes: one run of the
            # local and the overlapped engine under torch.profiler
            prof = {tag: profiled(lambda: runs[tag][0](*args, key=key),
                                  torch, top=12)
                    for tag in ("local", "sharded")}
            paths[f"sharded-{name}"] = runs["sharded"][2]
            rows.append({"query": name, "shuffles": n_shuffles,
                         "launches": runs["sharded"][2],
                         "overlapped_rounds": runs["sharded"][3],
                         "stats": accum_dict(want.stats), "host_ms": ms,
                         "sharded_over_local": ms["sharded"] / ms["local"],
                         "seq_over_local": ms["sharded-seq"] / ms["local"],
                         "profile": prof})
            del runs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="sharded", world_size=1, backend=backend, queries=rows,
         nvidia_smi=nvidia_smi_line(),
         note="host-clock medians of 5 after a warm-up; the sharded engine "
              "runs every round function on the whole mailbox and shuffles "
              "through a keyed all-to-all hop, the per-rank kernel scatter "
              "and an all-gather")
    return paths


def sharded_gloo_phase(job) -> dict:
    """Phase sharded-gloo, host work started after the build
    (``gloo_start``): ``python -m repro_torch.dist_check`` at
    SHARDED_GLOO_WORLD CPU ranks over gloo, at the tests' small sizes, on
    this machine's install: every case's result equal on every rank and
    equal to the port's LocalEngine (``--check``)."""
    rec, _ = gloo_join(job)
    check(rec["ok"] and rec["entries_held"] > 0, f"sharded-gloo: {rec}")
    emit(phase="sharded-gloo", kind="host work (CPU ranks, gloo)", **rec)
    return rec


def ssm_bwd_inputs(torch, dev, gen, shape):
    """a in [0.8, 1), x and a cotangent dh, seeded, in the shape's dtypes."""
    b, t, d, a_dt, x_dt = shape
    a = (0.8 + 0.2 * torch.rand(b, t, d, device=dev, generator=gen)
         ).to(getattr(torch, a_dt))
    x = torch.randn(b, t, d, device=dev, generator=gen).to(getattr(torch,
                                                                   x_dt))
    dh = torch.randn(b, t, d, device=dev, generator=gen).to(x.dtype)
    return a, x, dh


def train_kernel_phase(torch, dev) -> dict:
    """Phase train-kernels: ssm_scan's backward kernel (through the
    autograd Function, forward kernel first) against autograd through the
    plain version, da and dx for a seeded dh, at the two training shapes and
    the edges, within 2e-4 in float32 and 2e-2 with a bfloat16 input; then
    CUDA-event medians of the backward kernel and of the plain backward at
    the training shapes, beside the bound.  Returns the summary totals."""
    from repro_torch.kernels import ssm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    checked, max_err = [], 0.0
    for shape in SSM_BWD_MAIN + SSM_BWD_EDGE:
        a, x, dh = ssm_bwd_inputs(torch, dev, gen, shape)
        ka, kx = a.clone().requires_grad_(), x.clone().requires_grad_()
        before = ssm_scan.bwd_launches
        ssm_scan.SsmScan.apply(ka, kx).backward(dh)
        torch.cuda.synchronize()
        check(ssm_scan.bwd_launches == before + 1,
              f"ssm_scan backward {shape}: kernel not launched")
        pa, px = a.clone().requires_grad_(), x.clone().requires_grad_()
        ssm_scan.ssm_scan_plain(pa, px).backward(dh)
        tol = 2e-4 if shape[3:] == ("float32", "float32") else 2e-2
        errs = []
        # at T = 1, h does not depend on a: autograd leaves da unset
        for name, got, want in (("da", ka.grad, pa.grad
                                 if pa.grad is not None
                                 else torch.zeros_like(pa)),
                                ("dx", kx.grad, px.grad)):
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"ssm_scan backward {shape}: {name} {got.dtype} "
                  f"{tuple(got.shape)}")
            e = (got.float() - want.float()).abs().max().item()
            check(rel_close(got, want, tol), f"ssm_scan backward {shape}: "
                  f"{name} max abs err {e} over tolerance {tol}")
            errs.append(e)
        if shape[3:] == ("float32", "float32"):
            max_err = max(max_err, *errs)
        checked.append([*shape, *errs])
        del a, x, dh, ka, kx, pa, px
    per_call = []
    for shape in SSM_BWD_MAIN:
        a, x, dh = ssm_bwd_inputs(torch, dev, gen, shape)
        h = ssm_scan.ssm_scan_cuda(a, x)
        pa, px = a.clone().requires_grad_(), x.clone().requires_grad_()
        hp = ssm_scan.ssm_scan_plain(pa, px)
        nops, nbytes = ssm_scan.ssm_scan_bwd_work(*shape[:3], a.dtype,
                                                  x.dtype)
        per_call.append({
            "shape": list(shape[:3]),
            "ms": event_ms(lambda: ssm_scan.ssm_scan_bwd_cuda(a, h, dh),
                           torch),
            "b2b_ms": b2b_ms(lambda: ssm_scan.ssm_scan_bwd_cuda(a, h, dh),
                             torch),
            "plain_ms": event_ms(lambda: torch.autograd.grad(
                hp, (pa, px), dh, retain_graph=True), torch),
            "library_ms": None, "bytes": nbytes, "ops": nops,
            "bound_ms": bound_ms(nops, nbytes)})
        del a, x, dh, h, pa, px, hp
    emit(phase="train-kernels", checked=checked, max_abs_err_f32=max_err,
         per_call=per_call,
         columns="b t d a_dtype x_dtype da_err dx_err",
         note=f"CUDA-event medians of {REPS} after a warm-up: the backward "
              "kernel alone; plain_ms the backward of autograd through "
              "ssm_scan_plain, its forward graph built once")
    totals = {k: sum(r[k] for r in per_call)
              for k in ("ms", "b2b_ms", "plain_ms", "bytes", "ops")}
    return {"max_abs_err": max_err, "totals": totals, "per_call": per_call}


def grads_of(torch, model, batch):
    """(loss, {name: gradient}) of one loss_fn and backward."""
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss_fn(batch)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def train_parity_phase(torch, dev) -> dict:
    """Phase train-parity: zamba2-1.2b and rwkv6-1.6b at full width and 2
    layers in float32 compute (TF32 off), one batch of TRAIN_PARITY: the
    loss and every gradient leaf through the kernels against the same
    model with ssm_scan's plain version; loss within 1e-4 relative, each
    leaf max|d| <= 1e-3 max|g_plain|."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, _ in SSM_ARCHS:
        cfg = get_config(arch, n_layers=2, compute_dtype="float32")
        model = build_model(cfg, device=dev, seed=0)
        b, s = TRAIN_PARITY
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_pipeline(cfg, b, s, seed=0).batch_at(0).items()}
        ops.reset_launches()
        loss_k, grads_k = grads_of(torch, model, batch)
        launches = ops.launches()
        with plain_ssm_scan():
            loss_p, grads_p = grads_of(torch, model, batch)
        # remat "full" (zamba2 always, rwkv6 under scan_layers): each
        # layer's forward runs again in the backward
        want = {"ssm_scan": 2 * cfg.n_layers,
                "ssm_scan.bwd": cfg.n_layers, "flash_attention": 0}
        got = {k: launches[k] for k in want}
        check(got == want, f"{arch} train-parity launches {got}, want {want}")
        check(math.isfinite(loss_k) and abs(loss_k - loss_p)
              <= 1e-4 * abs(loss_p),
              f"{arch}: loss through the kernels {loss_k}, plain {loss_p}")
        leaves = {}
        for name, gp in grads_p.items():
            gk = grads_k[name]
            e = (gk - gp).abs().max().item()
            scale = gp.abs().max().item()
            leaves[name] = [e, scale]
            check(bool(torch.isfinite(gk).all()) and e <= 1e-3 * scale,
                  f"{arch}: gradient {name} max abs diff {e}, "
                  f"max |g_plain| {scale}")
        worst = max(leaves.items(), key=lambda kv: kv[1][0]
                    / max(kv[1][1], 1e-30))
        emit(phase="train-parity", arch=arch, layers=cfg.n_layers,
             batch=b, seq=s, loss_kernel=loss_k, loss_plain=loss_p,
             launches=got, leaves=len(leaves),
             worst_leaf={"name": worst[0], "max_abs_diff": worst[1][0],
                         "max_abs_plain": worst[1][1]},
             columns_leaves="name: max|g_kernel - g_plain|, max|g_plain|",
             leaves_detail=leaves)
        out[arch] = {"loss": [loss_k, loss_p], "launches": got}
        del model, grads_k, grads_p, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_phase(torch, dev) -> dict:
    """Phase train: zamba2-1.2b at full width and depth through the port's
    Trainer (float32 params, bf16 compute, remat "full", AdamW), the
    launch counts reset just before the TRAIN_STEPS steps and read just
    after; every logged loss finite and the last below the first; host-clock
    ms of each step, peak device memory, then one more step under
    torch.profiler.  Returns the launches and the timings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer, TrainConfig
    cfg = get_config("zamba2-1.2b")
    b, s = TRAIN_SHAPE
    tc = TrainConfig(arch=cfg, global_batch=b, seq_len=s, steps=TRAIN_STEPS,
                     warmup_steps=2, log_every=1, seed=0)
    t0 = time.perf_counter()
    trainer = Trainer(tc, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    # -- the main path: counts reset just before, read just after --------
    ops.reset_launches()
    step_ms = []
    for k in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        trainer.train(steps=k)              # logs (reads) the loss each step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_shared = len(range(0, cfg.n_layers, cfg.shared_attn_period))
    want = {"ssm_scan": 2 * cfg.n_layers * TRAIN_STEPS,
            "ssm_scan.bwd": cfg.n_layers * TRAIN_STEPS, "flash_attention": 0}
    got = {k: launches[k] for k in want}
    check(got == want, f"train launches {got}, want {want} (per step: "
          f"{2 * cfg.n_layers} forward, {cfg.n_layers} backward)")
    others = {k: v for k, v in launches.items()
              if k.split(".")[0] not in want and v}
    check(not others, f"train: other kernels launched: {others}")
    losses = [loss for _, loss in trainer.history]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"train: last loss {losses[-1]} not "
          f"below the first {losses[0]}")
    steady = step_ms[2:]
    median_ms = statistics.median(steady)
    prof = profiled(lambda: trainer.train(steps=trainer.step + 1), torch,
                    named={"ssm_scan": "ssm_scan_kernel",
                           "ssm_scan.bwd": "ssm_scan_bwd_kernel"})
    prof["busy_share"] = prof["device_ms"] / median_ms
    for k in ("ssm_scan", "ssm_scan.bwd"):
        prof[k]["share"] = prof[k]["ms"] / prof["device_ms"]
    timing = {"step_ms": step_ms, "median_step_ms_3_to_8": median_ms,
              "tokens_per_s": b * s / (median_ms / 1e3),
              "peak_mem_bytes": peak, "build_s": build_s,
              "profiled_step": prof}
    emit(phase="train", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, batch=b, seq=s, steps=TRAIN_STEPS,
         shared_blocks_per_step=n_shared, remat=cfg.remat,
         compute_dtype=cfg.compute_dtype, optimizer=cfg.optimizer,
         losses=losses, launches=got, launches_per_step={
             k: v // TRAIN_STEPS for k, v in got.items()}, **timing,
         note="host-clock ms of each Trainer step ending in a synchronize "
              "(the loss is read each step: log_every 1); median over "
              "steps 3-8; one more step under torch.profiler, busy_share = "
              "device ms over the median step")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "timing": timing, "losses": losses}


def train_resume_phase(torch, dev) -> dict:
    """Phase train-resume: zamba2-1.2b at full width and 2 layers (bf16
    compute, AdamW), TRAIN_SHAPE batches: 4 steps uninterrupted, against 2
    steps, a checkpoint, a fresh Trainer that resumes from it and 2 more
    steps; the final losses within 1e-5.  The checkpoints go to a
    temporary directory, deleted afterwards."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train import Trainer, TrainConfig
    cfg = get_config("zamba2-1.2b", n_layers=2)
    b, s = TRAIN_SHAPE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        def tc(ckpt_dir, every):
            return TrainConfig(arch=cfg, global_batch=b, seq_len=s, steps=4,
                               warmup_steps=2, log_every=1, seed=0,
                               ckpt_dir=ckpt_dir, ckpt_every=every)
        whole = Trainer(tc(None, 1000), device=dev).train()
        first = Trainer(tc(d, 2), device=dev)
        first.train(steps=2)
        del first
        t0 = time.perf_counter()
        resumed = Trainer(tc(d, 1000), device=dev)
        check(resumed.maybe_resume() and resumed.step == 2,
              f"train-resume: resumed at step {resumed.step}")
        resume_s = time.perf_counter() - t0
        rest = resumed.train()
    diff = abs(whole["final_loss"] - rest["final_loss"])
    check(diff <= 1e-5, f"train-resume: final loss {rest['final_loss']} vs "
          f"uninterrupted {whole['final_loss']}")
    emit(phase="train-resume", arch=cfg.name, layers=cfg.n_layers, batch=b,
         seq=s, uninterrupted=whole["history"], resumed=rest["history"],
         final_loss_diff=diff, resume_s=resume_s)
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    return {"final_loss_diff": diff}


# -- the parallel-training half (the mesh Trainer) ---------------------------
TRAIN_GLOO_WORLDS = (4,)          # the tests also run 2 and 8 ranks
TRAIN_GLOO_CASES = ("train", "elastic-train", "pipeline", "moe-grad",
                    "train-sp")
FAMILY_TRAIN = (("internvl2-2b", 8, 1792), ("whisper-base", 8, 448))
FAMILY_TRAIN_STEPS = 8
FAMILY_TRAIN_LR = (1e-4, 4)       # peak lr, warmup steps
MOE_TRAIN_STEPS = 4
#: (arch, dispatch) of phase moe-train's mesh Trainer runs
MOE_MESH_TRAIN = (("kimi-k2-1t-a32b", "einsum"),
                  ("llama4-scout-17b-a16e", "shuffle"))
#: the steps phase train-mesh runs of phase train's schedule (cut from
#: TRAIN_STEPS for the script's time limit)
MESH_TRAIN_STEPS = 4
#: steps of phase train-mesh's plain compressed reference
COMPRESSED_REF_STEPS = 4
#: steps of phase train-mesh's plain step with one int8 scale a layer
LAYER_SCALE_STEPS = 4
#: the step whose gradient phase train-mesh reads for int8 zeros (the
#: first update with a learning rate above 0)
COMPRESSED_PROBE_STEP = 2


def nccl_world(tag: str):
    """A one-rank NCCL process group over a file store (a context manager;
    the group is destroyed at the end)."""
    import contextlib
    import shutil
    import tempfile
    import torch.distributed as dist

    @contextlib.contextmanager
    def ctx():
        tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
    return ctx()


def mesh_train_run(torch, dev, tc, mesh, steps: int) -> dict:
    """``steps`` steps of a mesh Trainer, launch counts reset just before
    and read just after; host-clock ms of each step (ending in a
    synchronize: the loss is read every step), peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(tc, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    step_ms = []
    for k in range(1, steps + 1):
        t0 = time.perf_counter()
        trainer.train(steps=k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in ops.launches().items() if v}
    step = trainer._mesh_step
    return {"trainer": trainer, "losses": [l for _, l in trainer.history],
            "step_ms": step_ms, "launches": launches, "build_s": build_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "param_bytes": dict(zip(("rank", "whole"),
                                    step.param_bytes(trainer.params))),
            "moment_bytes": dict(zip(("rank", "whole"),
                                     step.moment_bytes(trainer.opt_state)))}


def int8_zero_shares(torch, paths, grads, residuals, n_layers) -> dict:
    """How much of the error-corrected gradient ``grads + residuals`` (one
    pod) quantizes to 0 where it is not 0: for each stacked layer (the leaves under
    ``layers/``, leading dim ``n_layers``), the share of its elements that
    are 0 under the leaf's one scale (the JAX package's formulation) and
    under one scale for the layer; for each other leaf, its share; and the
    share over all elements under either scaling."""
    from repro_torch.optim import compress
    zero_leaf = torch.zeros(n_layers, dtype=torch.float64)
    zero_layer = torch.zeros(n_layers, dtype=torch.float64)
    size = torch.zeros(n_layers, dtype=torch.float64)
    amax_ratio = {}
    other, other_zero, other_n = {}, 0, 0
    for path, g, r in zip(paths, grads, residuals):
        c = g[0].float() + r[0]
        q, _ = compress.quantize_int8(c)
        if path.startswith("layers/") and c.shape[0] == n_layers:
            lost = (q == 0) & (c != 0)
            zero_leaf += lost.reshape(n_layers, -1).sum(1).double().cpu()
            size += c[0].numel()
            for i in range(n_layers):
                zero_layer[i] += int(((compress.quantize_int8(c[i])[0] == 0)
                                      & (c[i] != 0)).sum())
            amax = c.abs().reshape(n_layers, -1).amax(1)
            amax_ratio[path] = float(amax.min() / amax.max())
        else:
            zeros = int(((q == 0) & (c != 0)).sum())
            other[path] = zeros / c.numel()
            other_zero += zeros
            other_n += c.numel()
    total = float(size.sum()) + other_n
    return {
        "stacked_layer_share_leaf_scale": (zero_leaf / size).tolist(),
        "stacked_layer_share_layer_scale": (zero_layer / size).tolist(),
        "stacked_min_over_max_layer_amax": amax_ratio,
        "other_leaf_share": other,
        "all_elements_share_leaf_scale":
            (float(zero_leaf.sum()) + other_zero) / total,
        "all_elements_share_layer_scale":
            (float(zero_layer.sum()) + other_zero) / total}


def layer_scaled_mean(torch, grads, ef, paths, n_layers):
    """``tree_stacked_compressed_mean`` with one int8 scale for each layer
    of a stacked leaf (the leaves under ``layers/``) instead of one for the
    leaf: a variant, not the JAX package's formulation."""
    from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
    from repro_torch.optim import compress
    flat, tdef = tree_flatten(grads)
    means, residuals = [], []
    for path, g, r in zip(paths, flat, tree_leaves(ef.residual)):
        if path.startswith("layers/") and g.shape[1] == n_layers:
            parts = [compress.stacked_compressed_mean(g[:, i], r[:, i])
                     for i in range(n_layers)]
            m = torch.stack([p for p, _ in parts])
            nr = torch.stack([p for _, p in parts], dim=1)
        else:
            m, nr = compress.stacked_compressed_mean(g, r)
        means.append(m.to(g.dtype))
        residuals.append(nr)
    return (tree_unflatten(tdef, means),
            compress.EFState(residual=tree_unflatten(tdef, residuals)))


def plain_compressed_run(torch, dev, tc, steps: int, layer_scale=False,
                         probe_step=None) -> tuple:
    """The compressed step's plain version on one device: the one-device
    Trainer with each gradient passed through
    ``compress.tree_stacked_compressed_mean`` (the JAX package's
    formulation, one pod) before AdamW, or with ``layer_scale`` through
    :func:`layer_scaled_mean`.  Returns (losses, the
    :func:`int8_zero_shares` of step ``probe_step``'s gradient, or None)."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.sharding import tree_paths
    from repro_torch.optim import compress
    from repro_torch.train import Trainer, build_train_step
    t = Trainer(tc, device=dev)
    ef = compress.ef_init(t.params, n_pod=1)
    paths = tree_leaves(tree_paths(t.params))
    n_layers = tc.arch.n_layers
    exact = t.opt.update
    calls, probe = 0, None

    def update(grads, state, params, lr, **kw):
        nonlocal ef, calls, probe
        calls += 1
        stacked = tree_map(lambda g: g[None], grads)
        if calls == probe_step:
            probe = int8_zero_shares(torch, paths, tree_leaves(stacked),
                                     tree_leaves(ef.residual), n_layers)
        if layer_scale:
            mean, ef = layer_scaled_mean(torch, stacked, ef, paths, n_layers)
        else:
            mean, ef = compress.tree_stacked_compressed_mean(stacked, ef)
        return exact(mean, state, params, lr, **kw)
    t._step_fn = build_train_step(tc, t.model, t.opt._replace(update=update))
    losses = [l for _, l in t.train(steps=steps)["history"]]
    del t, ef
    gc.collect()
    torch.cuda.empty_cache()
    return losses, probe


def train_mesh_phase(torch, dev, train_losses, train_timing) -> dict:
    """Phase train-mesh: the slice's main path.  zamba2-1.2b at full width
    and depth as phase train (bf16 compute, remat "full", AdamW, 8 x 2048,
    phase train's schedule of TRAIN_STEPS steps) through the mesh Trainer
    on a (1, 1, 1) NCCL mesh (``make_host_mesh``), the first
    MESH_TRAIN_STEPS steps, in "auto" and "compressed" modes: auto's
    losses equal phase train's within 1e-5 relative; 76 ``ssm_scan`` and
    38 ``ssm_scan.bwd`` launches a step and no other kernel; compressed's
    first COMPRESSED_REF_STEPS losses equal its plain version's
    (``plain_compressed_run``) within 1e-5 relative, and its last loss
    is below its first.  Recorded: compressed over auto loss at the last
    step (not held to a bound: at 8 full-size steps the int8 hop trails
    the exact one; PERF.md §6), step ms beside phase train's, peak memory,
    the pod hop's wire bytes (``compression_wire_bytes``), and two readings
    of the gap's cause: the int8 zero shares of step
    COMPRESSED_PROBE_STEP's gradient (``int8_zero_shares``) and the plain
    compressed step with one scale a layer (``layer_scaled_mean``) run
    LAYER_SCALE_STEPS steps, its last loss over auto's at that step (cut
    from TRAIN_STEPS to fit the script's time limit)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compress import compression_wire_bytes
    from repro_torch.train import TrainConfig
    cfg = get_config("zamba2-1.2b")
    b, s = TRAIN_SHAPE
    n = MESH_TRAIN_STEPS
    want = {"ssm_scan": 2 * cfg.n_layers * n, "ssm_scan.bwd": cfg.n_layers * n}
    runs = {}
    with nccl_world("mesh"):
        mesh = make_host_mesh()
        for mode in ("auto", "compressed"):
            tc = TrainConfig(arch=cfg, global_batch=b, seq_len=s,
                             steps=TRAIN_STEPS, warmup_steps=2, log_every=1,
                             seed=0, pod_grad_mode=mode)
            r = mesh_train_run(torch, dev, tc, mesh, n)
            trainer = r.pop("trainer")
            if mode == "auto":
                counted = count_mesh_step(torch, trainer, cfg, ShapeConfig(
                    f"train_{b}x{s}", s, b, "train"))
            if mode == "compressed":
                check(trainer.ef_state is not None,
                      "train-mesh: compressed mode kept no residuals")
                r["wire_bytes"] = dict(zip(
                    ("float32", "int8"),
                    compression_wire_bytes(trainer.params)))
            r["median_step_ms_from_3"] = statistics.median(r["step_ms"][2:])
            runs[mode] = r
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    tc = TrainConfig(arch=cfg, global_batch=b, seq_len=s, steps=TRAIN_STEPS,
                     warmup_steps=2, log_every=1, seed=0,
                     pod_grad_mode="compressed")
    plain, zero_shares = plain_compressed_run(
        torch, dev, tc, COMPRESSED_REF_STEPS, probe_step=COMPRESSED_PROBE_STEP)
    per_layer, _ = plain_compressed_run(torch, dev, tc, LAYER_SCALE_STEPS,
                                        layer_scale=True)
    auto, comp = runs["auto"]["losses"], runs["compressed"]["losses"]
    rel = [abs(a - t) / abs(t) for a, t in zip(auto, train_losses)]
    rel_plain = [abs(c - p) / abs(p) for c, p in zip(comp, plain)]
    ratio = comp[-1] / auto[-1]
    per_layer_ratio = per_layer[-1] / auto[LAYER_SCALE_STEPS - 1]
    emit(phase="train-mesh", arch=cfg.name, mesh=[1, 1, 1],
         mesh_axes=["pod", "data", "model"], backend="nccl", batch=b, seq=s,
         steps=n, schedule_steps=TRAIN_STEPS, runs=runs,
         auto_vs_train_max_rel=max(rel),
         compressed_plain_losses=plain,
         compressed_vs_plain_max_rel=max(rel_plain),
         compressed_over_auto_loss_at_last_step=ratio,
         compressed_int8_zero_shares_at_step=COMPRESSED_PROBE_STEP,
         compressed_int8_zero_shares=zero_shares,
         layer_scale_losses=per_layer, layer_scale_steps=LAYER_SCALE_STEPS,
         layer_scale_cut=f"steps {TRAIN_STEPS} -> {LAYER_SCALE_STEPS}",
         steps_cut=f"steps {TRAIN_STEPS} -> {n}",
         layer_scale_over_auto_loss_at_step=per_layer_ratio,
         train_median_step_ms_3_to_8=train_timing["median_step_ms_3_to_8"],
         train_peak_mem_bytes=train_timing["peak_mem_bytes"],
         launches_per_step={k: v // n for k, v in want.items()},
         note="host-clock ms of each step ending in a synchronize; "
              "collectives over a group of one rank are skipped, so the "
              "mesh step on one card adds the funnel's copies, the "
              "compressed hop's int8 round trip and its residuals")
    for mode, r in runs.items():
        check(r["launches"] == want, f"train-mesh {mode}: launches "
              f"{r['launches']}, want {want}")
        losses = r["losses"]
        check(len(losses) == n and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"train-mesh {mode}: losses {losses}")
    check(max(rel) <= 1e-5, f"train-mesh: auto losses {auto} against phase "
          f"train's {train_losses}")
    check(len(plain) == COMPRESSED_REF_STEPS and max(rel_plain) <= 1e-5,
          f"train-mesh: compressed losses {comp} against the plain "
          f"compressed step's {plain}")
    check(zero_shares is not None and len(per_layer) == LAYER_SCALE_STEPS
          and all(map(math.isfinite, per_layer)),
          f"train-mesh: the one-scale-a-layer run's losses {per_layer}")
    return {"launches": runs["auto"]["launches"], "runs": runs,
            "counted": counted}


#: (arch, steps) of phase mesh-paths' reduced runs
MESH_PATH_ARCHS = (("qwen1.5-0.5b", 3), ("zamba2-1.2b", 3))


def forced_fsdp():
    """A context in which every leaf with a data dimension counts as split
    over the FSDP axes (``TensorLayout.fsdp_axes`` gives ``("data",)``),
    so that a mesh step of one rank takes the sharded-parameter path, and
    in which each ``fsdp_gather`` is counted (``counts["gathers"]``)."""
    import contextlib
    from repro_torch.models import sharding

    @contextlib.contextmanager
    def ctx():
        counts = {"gathers": 0}
        real_axes, real_gather = (sharding.TensorLayout.fsdp_axes,
                                  sharding.D.fsdp_gather)

        def gather(*a, **kw):
            counts["gathers"] += 1
            return real_gather(*a, **kw)
        sharding.TensorLayout.fsdp_axes = lambda self: (
            ("data",) if self.data_dim is not None else ())
        sharding.D.fsdp_gather = gather
        try:
            yield counts
        finally:
            sharding.TensorLayout.fsdp_axes = real_axes
            sharding.D.fsdp_gather = real_gather
    return ctx()


def tp_pair_check(torch, dev, group) -> dict:
    """The Megatron pair and the vocab-parallel cross-entropy on a
    one-rank NCCL group, under a checkpoint (its recompute runs the
    forward collectives again, its backward the backward ones on
    autograd's device thread): a column- and a row-parallel matmul, the
    region left through a sum and through a gather, the logits' CE; and
    the sequence-parallel pair (``sp_*``): the region entered by an
    all-gather of the sequence (a reduce-scatter back) and left by a
    reduce-scatter (an all-gather back), its output's gradient strided;
    gradients against the same function without the collectives
    (float32, TF32 off): max abs error over each gradient's max."""
    import torch.distributed as dist
    from torch.utils.checkpoint import checkpoint
    from repro_torch.core import distributed as D
    from repro_torch.models.layers import (cross_entropy,
                                           vocab_parallel_cross_entropy)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w1, w2, wv = (torch.randn(*sh, device=dev, generator=gen) * sc
                     for sh, sc in (((4, 64, 128), 1.0), ((128, 256), 0.1),
                                    ((256, 128), 0.1), ((128, 512), 0.1)))
    labels = torch.randint(0, 512, (4, 64), device=dev, generator=gen)

    def f(x, w1, w2, wv, tp: bool):
        enter = (lambda t: D.copy_to_region(t, group)) if tp else (
            lambda t: t)
        h = torch.relu(enter(x) @ w1)
        y = h @ w2
        if tp:
            y = D.gather_from_region(D.reduce_from_region(y, group), -1,
                                     group)
        logits = enter(y) @ wv
        if not tp:
            return cross_entropy(logits, labels)
        return vocab_parallel_cross_entropy(
            logits, labels, None, 1e-4, first=0,
            psum=lambda t: D.reduce_from_region(t, group),
            pmax=lambda t: D.all_reduce(t, dist.ReduceOp.MAX, group))

    def g(x, w1, w2, sp: bool):
        h = D.enter_sequence(x, group) if sp else x
        y = torch.relu(h @ w1) @ w2
        y = D.leave_sequence(y, group) if sp else y
        return (y.transpose(1, 2) ** 2).sum()

    out = {}
    for fn, names, args in ((f, ("loss", "x", "w1", "w2", "wv"),
                             (x, w1, w2, wv)),
                            (g, ("sp_loss", "sp_x", "sp_w1", "sp_w2"),
                             (x, w1, w2))):
        grads = {}
        for on in (True, False):
            ins = [t.detach().clone().requires_grad_() for t in args]
            loss = checkpoint(fn, *ins, on, use_reentrant=False)
            loss.backward()
            torch.cuda.synchronize()
            grads[on] = [loss.detach()] + [t.grad for t in ins]
        out.update({name: float((a - b).abs().max() / b.abs().max())
                    for name, a, b in zip(names, grads[True],
                                          grads[False])})
    return out


def mesh_paths_phase(torch, dev) -> dict:
    """Phase mesh-paths: the sharded-parameter code's collectives on the
    card, on a one-rank NCCL mesh, where the main path's mesh step is the
    one-device one (no axis splits a leaf, ``"model"`` has one rank).
    Under ``forced_fsdp`` every leaf with a data dimension is a
    ``LeafRef``: each layer gathers it inside its checkpointed function
    (an NCCL all-gather, again in the recompute) and its backward
    reduce-scatters the gradient into the region sink, from which the
    step updates the shard in place.  Reduced qwen1.5-0.5b and
    zamba2-1.2b (float32, remat "full") train MESH_PATH_ARCHS' steps so,
    and are held to the same Trainer without a mesh: losses within 1e-5
    relative, final params within 1e-5 in the relative L2 norm of the
    whole tree.  Then ``tp_pair_check``: each gradient within 1e-5 of
    its largest element."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import MeshGroups
    from repro_torch.train import Trainer, TrainConfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    with nccl_world("mesh_paths"):
        mesh = make_host_mesh()
        for arch, steps in MESH_PATH_ARCHS:
            tc = TrainConfig(arch=get_config(arch, reduced=True),
                             global_batch=8, seq_len=64, steps=steps,
                             warmup_steps=1, log_every=1, seed=0)
            plain = Trainer(tc, device=dev)
            want = [l for _, l in plain.train()["history"]]
            with forced_fsdp() as counts:
                t = Trainer(tc, device=dev, mesh=mesh)
                got = [l for _, l in t.train()["history"]]
            n_refs = sum(1 for lay in t._mesh_step.layouts
                         if lay.data_dim is not None)
            sq = sq_ref = 0.0
            for a, b in zip(tree_leaves(t.params), tree_leaves(plain.params)):
                a, b = a.detach().double(), b.detach().double()
                sq += float(torch.sum((a - b) ** 2))
                sq_ref += float(torch.sum(b ** 2))
            runs[arch] = {
                "losses": got, "plain_losses": want,
                "loss_max_rel": max(abs(a - b) / abs(b)
                                    for a, b in zip(got, want)),
                "params_rel": math.sqrt(sq / sq_ref),
                "leafref_leaves": n_refs, "leaves": len(t._mesh_step.layouts),
                "gathers": counts["gathers"], "steps": steps}
            del t, plain
        pair = tp_pair_check(torch, dev, MeshGroups(mesh).group("model"))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="mesh-paths", mesh=[1, 1, 1], backend="nccl", runs=runs,
         tp_pair_max_rel_err=pair, tolerance=1e-5)
    for arch, r in runs.items():
        check(r["leafref_leaves"] > 0 and r["gathers"] > 0,
              f"mesh-paths {arch}: the sharded path did not run {r}")
        check(r["loss_max_rel"] <= 1e-5 and r["params_rel"] <= 1e-5,
              f"mesh-paths {arch}: {r}")
    check(max(pair.values()) <= 1e-5, f"mesh-paths: the TP pair {pair}")
    return runs


def families_train_phase(torch, dev) -> dict:
    """Phase families-train: internvl2-2b (8 x (256 patches + 1792
    tokens)) and whisper-base (8 x 1500 frames, 448 tokens) at full size
    (bf16 compute, AdamW, peak lr 1e-4 after 4 warmup steps: at 3e-4
    after one, internvl2-2b's loss rose from 10.0 to 13.6 at its third
    step) through the mesh Trainer on a (1, 1, 1) NCCL mesh,
    FAMILY_TRAIN_STEPS steps: losses finite, the last below the first;
    step ms and peak memory.  internvl2-2b's batch is halved only
    if 8 rows do not fit the card, and the cut is recorded."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig
    out = {}
    with nccl_world("families"):
        mesh = make_host_mesh()
        for arch, b, s in FAMILY_TRAIN:
            cfg = get_config(arch)
            cut = None
            while True:
                tc = TrainConfig(arch=cfg, global_batch=b, seq_len=s,
                                 steps=FAMILY_TRAIN_STEPS,
                                 peak_lr=FAMILY_TRAIN_LR[0],
                                 warmup_steps=FAMILY_TRAIN_LR[1],
                                 log_every=1, seed=0)
                try:
                    r = mesh_train_run(torch, dev, tc, mesh,
                                       FAMILY_TRAIN_STEPS)
                    break
                except torch.cuda.OutOfMemoryError:
                    gc.collect()
                    torch.cuda.empty_cache()
                    check(arch == "internvl2-2b" and b == 8,
                          f"families-train: {arch} at batch {b} does not "
                          f"fit the card")
                    cut = f"batch {b} -> {b // 2}: {b} rows did not fit"
                    b //= 2
            del r["trainer"]
            gc.collect()
            torch.cuda.empty_cache()
            r.update(batch=b, seq=s, cut=cut, layers=cfg.n_layers,
                     d_model=cfg.d_model,
                     median_step_ms=statistics.median(r["step_ms"][2:]))
            out[arch] = r
    emit(phase="families-train", runs=out, mesh=[1, 1, 1], backend="nccl",
         note="host-clock ms of each step ending in a synchronize; median "
              "over steps 3-8; no kernel launches (attention under a "
              "gradient runs the plain path)")
    for arch, r in out.items():
        losses = r["losses"]
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"families-train {arch}: losses {losses}")
        check(not r["launches"], f"families-train {arch}: kernels launched "
              f"{r['launches']}")
    return out


def moe_train_phase(torch, dev) -> dict:
    """Phase moe-train: the reduced MoE configs on one NCCL rank.  The
    ``shuffle`` dispatch's gradients (``dist_check.moe_grads``: y, x and
    every parameter, float32, capacity factor 8 where nothing drops)
    equal the ``einsum`` dispatch's within 1e-4; with a planted detached
    ``all_to_all`` (the parent commit's) the check must fail.  Then
    MOE_TRAIN_STEPS Trainer steps of reduced kimi-k2 with the shuffle
    dispatch in the expert group against the einsum dispatch (losses
    within 1e-4 relative), and of reduced llama4-scout.  Then the mesh
    Trainer on a (1, 1, 1) NCCL mesh (``make_host_mesh``): kimi-k2 with
    the einsum dispatch and llama4-scout with the shuffle dispatch over
    the mesh's "model" group, each within 1e-5 relative of its run
    without a mesh (the einsum one: capacity 8, nothing drops)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import dist_check
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.interop import tree_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_expert_group
    from repro_torch.train import Trainer, TrainConfig
    tol = dist_check.MOE_GRAD_TOL
    params, x = dist_check.moe_inputs()
    cfg = get_config(dist_check.MOE_ARCH, reduced=True,
                     capacity_factor=dist_check.MOE_CFS[-1],
                     **dist_check.MOE_OVERRIDES)
    p = {k: v.to(dev) for k, v in tree_from_numpy(params).items()}
    xt = torch.from_numpy(x).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def errors():
        with use_expert_group(dist.group.WORLD):
            got = dist_check.moe_grads(p, cfg, xt, moe._moe_shuffle)
        want = dist_check.moe_grads(p, cfg, xt, moe._moe_einsum)
        err = {"y": (got[0] - want[0]).abs().max().item(),
               "x": (got[2] - want[2]).abs().max().item()}
        for k in want[1]:
            err[k] = (got[1][k] - want[1][k]).abs().max().item()
        ok = all(torch.allclose(a, b, rtol=tol, atol=tol) for a, b in
                 [(got[0], want[0]), (got[2], want[2])]
                 + [(got[1][k], want[1][k]) for k in want[1]])
        return ok, err

    losses = {}
    with nccl_world("moe_train"):
        ok, err = errors()
        check(ok, f"moe-train: shuffle vs einsum gradients {err}")
        real = moe.all_to_all
        moe.all_to_all = lambda send, group=None: D._all_to_all(
            send.detach(), group)
        try:
            planted_ok, planted_err = errors()
        finally:
            moe.all_to_all = real
        check(not planted_ok, "moe-train: the check passed a detached "
              f"all_to_all {planted_err}")
        for arch, dispatch in (("kimi-k2-1t-a32b", "einsum"),
                               ("kimi-k2-1t-a32b", "shuffle"),
                               ("llama4-scout-17b-a16e", "einsum")):
            c = get_config(arch, reduced=True, capacity_factor=8.0,
                           moe_dispatch=dispatch)
            tc = TrainConfig(arch=c, global_batch=8, seq_len=64,
                             steps=MOE_TRAIN_STEPS, warmup_steps=1,
                             log_every=1, seed=0)
            t = Trainer(tc, device=dev)
            with use_expert_group(dist.group.WORLD if dispatch == "shuffle"
                                  else None):
                losses[f"{arch}/{dispatch}"] = [
                    l for _, l in t.train()["history"]]
        mesh = make_host_mesh()
        mesh_bytes = {}
        for arch, dispatch in MOE_MESH_TRAIN:
            c = get_config(arch, reduced=True, capacity_factor=8.0,
                           moe_dispatch=dispatch)
            tc = TrainConfig(arch=c, global_batch=8, seq_len=64,
                             steps=MOE_TRAIN_STEPS, warmup_steps=1,
                             log_every=1, seed=0)
            t = Trainer(tc, device=dev, mesh=mesh)
            losses[f"{arch}/{dispatch}/mesh"] = [
                l for _, l in t.train()["history"]]
            mesh_bytes[arch] = t._mesh_step.param_bytes(t.params)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in losses.items():
        check(len(v) == MOE_TRAIN_STEPS and all(map(math.isfinite, v)),
              f"moe-train {k}: losses {v}")
    a, b = losses["kimi-k2-1t-a32b/shuffle"], losses["kimi-k2-1t-a32b/einsum"]
    check(all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(a, b)),
          f"moe-train: shuffle losses {a} against einsum {b}")
    mesh_rel = {}
    for arch, dispatch in MOE_MESH_TRAIN:
        got, want = losses[f"{arch}/{dispatch}/mesh"], losses[
            f"{arch}/einsum"]
        mesh_rel[arch] = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        check(mesh_rel[arch] <= 1e-5, f"moe-train: {arch} {dispatch} on "
              f"the mesh {got} against without one {want}")
    emit(phase="moe-train", grad_max_abs_err=err, tolerance=tol,
         planted_detached_all_to_all={"check_passed": planted_ok,
                                      "max_abs_err": planted_err},
         losses=losses, world_size=1, backend="nccl",
         mesh=[1, 1, 1], mesh_runs=[list(r) for r in MOE_MESH_TRAIN],
         mesh_vs_no_mesh_max_rel=mesh_rel,
         mesh_param_bytes={a: list(b) for a, b in mesh_bytes.items()})
    return {"err": err}


def train_gloo_start() -> list:
    """Start phase train-gloo's host work (``train_gloo_phase`` waits for
    it, ``train_gloo_stop`` ends what is left): ``python -m
    repro_torch.dist_check --cases train,elastic-train,pipeline,moe-grad
    --check`` on gloo CPU ranks at each world size of TRAIN_GLOO_WORLDS,
    each in a session of its own, at the lowest CPU priority (the card's
    phases beside it keep the host's cores first)."""
    import os
    import tempfile
    started = []
    for world in TRAIN_GLOO_WORLDS:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_gloo_"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist_check", "--world",
             str(world), "--out", str(tmp), "--cases",
             ",".join(TRAIN_GLOO_CASES), "--check", "--timeout", "420"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True, preexec_fn=lambda: os.nice(19),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "CUDA_VISIBLE_DEVICES": ""})
        started.append((tmp, time.perf_counter(), proc))
    return started


def train_gloo_stop(started) -> None:
    """Kill whatever ``train_gloo_start`` started and is still running
    (the launcher and its ranks share its session) and remove its
    directories."""
    import os
    import shutil
    import signal
    for tmp, _, proc in started:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def train_gloo_phase(started) -> dict:
    """Phase train-gloo, host work started by ``train_gloo_start`` at
    the lowest CPU priority before the training phases 27-33 ran on the
    card: the mesh trainer on every layout of ``TRAIN_MESHES`` and
    ``FAMILY_TRAIN`` against one device, elastic resume on half the
    ranks, the GPipe schedule and the MoE shuffle's gradients, each
    checked on every rank."""
    recs = []
    for _, t0, proc in started:
        try:
            out, err = proc.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            check(False, "train-gloo: timed out after 480 s")
        check(proc.returncode == 0, f"train-gloo: {out[-2000:]} "
              f"{err[-4000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        check(rec["ok"] and rec["entries_held"] > 0, f"train-gloo: {rec}")
        rec["wall_s"] = time.perf_counter() - t0
        recs.append(rec)
    emit(phase="train-gloo", kind="host work (CPU ranks, gloo)", runs=recs,
         beside="phases train-kernels to moe-train, at nice 19")
    return {"runs": recs}


# ---------------------------------------------------------------------------
# The assigned shape cells and the roofline
# ---------------------------------------------------------------------------

#: steps counted on the card beside the same step's dry run on meta:
#: (arch, kind, batch, seq), the serving and training paths' own shapes
ROOFLINE_CHECKS = (("tinyllama-1.1b", "prefill", LM_B, LM_S),
                   ("zamba2-1.2b", "train", *TRAIN_SHAPE))
#: every assigned cell that the dry run fits in the card's 80 GB runs on
#: the card; these are reported whether they run or not (the prefill that
#: puts the flash kernel at s = 32768, and the sub-quadratic decodes)
ASSIGNED_CELLS = (("tinyllama-1.1b", "prefill_32k"),
                  ("zamba2-1.2b", "long_500k"),
                  ("rwkv6-1.6b", "long_500k"),
                  ("rwkv6-1.6b", "decode_32k"))
#: the flash kernel at the assigned prefill length (b, hq, hkv, s_q, s_k,
#: d, causal): about 8.6 GB of float32 scores in the plain version
FLASH_32K = (1, 2, 1, 32768, 32768, 64, True)
#: the dry run's peak against max_memory_allocated, relative
PEAK_TOL = 0.10
#: one small launch, for HardwareModel's latency_s: bincount_tiles on one
#: (1, 4096) tile into 2048 buckets
LATENCY_TILE = (1, 4096, 2048)
#: greedy decode steps of phase lm-mesh after its prefill
MESH_DECODE = 8
#: the per-rank dry run's cells on the host (arch, shape, mesh): a
#: training step, a prefill and each of the decode state's three layouts
#: (KV heads over "model", the head dimension over "model", the sequence
#: over "data")
MESH_CELLS = (("kimi-k2-1t-a32b", "train_4k", "multi"),
              ("tinyllama-1.1b", "prefill_32k", "single"),
              ("qwen1.5-0.5b", "decode_32k", "single"),
              ("tinyllama-1.1b", "decode_32k", "multi"),
              ("zamba2-1.2b", "long_500k", "single"))
#: the per-rank dry run's cells with Megatron sequence parallelism
#: (``dryrun --seq-shard``: the residual stream's sequence split over
#: "model"), each beside its plain record
MESH_SP_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                 ("kimi-k2-1t-a32b", "train_4k", "multi"),
                 ("tinyllama-1.1b", "prefill_32k", "single"))
#: (arch, kind, batch, seq) of the (1, 1, 1) per-rank dry runs held against
#: the card: phase train-mesh's step (one batch, no microbatches, as the
#: mesh Trainer steps) and phase lm-mesh's prefill and decode step
MESH_HOLDS = (("tinyllama-1.1b", "prefill", LM_B, LM_S),
              ("tinyllama-1.1b", "decode", LM_B, LM_S + LM_DECODE),
              ("zamba2-1.2b", "train", *TRAIN_SHAPE))


def roofline_start():
    """Start the dry runs on the host, without the card, at the lowest CPU
    priority, in two sessions of their own, each one run after another,
    into one directory: the 40 cells (``python -m
    repro_torch.launch.dryrun --all``) and each step of ROOFLINE_CHECKS
    (``--arch --kind --batch --seq``); and the (1, 1, 1) per-rank dry runs
    of MESH_HOLDS (``--mesh-shape 1,1,1 --grad-accum 1``), then the
    per-rank cells of MESH_CELLS (``--mesh``).  ``roofline_phase`` joins
    them and ``roofline_stop`` (also at exit) ends what is left."""
    import atexit
    import os
    import tempfile
    import shlex
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    jobs = [["--all"]] + [["--arch", arch, "--kind", kind, "--batch", str(b),
                           "--seq", str(s)]
                          for arch, kind, b, s in ROOFLINE_CHECKS]
    mesh_jobs = [["--arch", arch, "--kind", kind, "--batch", str(b),
                  "--seq", str(s), "--mesh-shape", "1,1,1", "--grad-accum",
                  "1"] for arch, kind, b, s in MESH_HOLDS]
    mesh_jobs += [["--arch", arch, "--shape", shape, "--mesh", mesh]
                  for arch, shape, mesh in MESH_CELLS]
    mesh_jobs += [["--arch", arch, "--shape", shape, "--mesh", mesh]
                  + flag for arch, shape, mesh in MESH_SP_CELLS
                  for flag in ([], ["--seq-shard"])
                  if flag or (arch, shape, mesh) not in MESH_CELLS]
    procs = [subprocess.Popen(
        ["sh", "-c", " && ".join(shlex.join(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *job,
             "--out", str(tmp)]) for job in js)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, preexec_fn=lambda: os.nice(19),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
        for js in (jobs, mesh_jobs)]
    started = (tmp, time.perf_counter(), procs)
    atexit.register(roofline_stop, started)
    return started


def roofline_stop(started) -> None:
    import os
    import shutil
    import signal
    tmp, _, procs = started
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def mesh_sp_cells(tmp) -> list:
    """Phase roofline's lines ``roofline-mesh-sp``: each cell of
    MESH_SP_CELLS, its ``dryrun --seq-shard`` record in ``tmp`` beside
    the plain one: GB a rank (the step's peak and the peak before the
    optimizer's update), collective GB by op.  Checked: the flag split
    the sequence (more reduce-scatters) and a rank keeps less."""
    from repro_torch.core.distributed import COLLECTIVE_OPS
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import SEQ_SHARD_SUFFIX, mesh_name
    from repro_torch.launch.mesh import MESHES
    rows = []
    for arch, shape_name, mesh in MESH_SP_CELLS:
        name = mesh_name(MESHES[mesh])
        recs = [roofline._load(f"{arch}_{shape_name}_{n}", tmp)
                for n in (name, name + SEQ_SHARD_SUFFIX)]
        check(all(r is not None and not r.get("skipped") for r in recs),
              f"roofline: no plain or --seq-shard record of {arch} x "
              f"{shape_name} x {name}")
        plain, sp = recs
        gb = [r["memory"]["peak_bytes"] / 1e9 for r in recs]
        before = [r["memory"].get("peak_before_update_bytes", 0) / 1e9
                  for r in recs]
        coll = [{op: r["collectives"][op] / 1e9 for op in COLLECTIVE_OPS
                 if r["collectives"][op]} for r in recs]
        rows.append(dict(arch=arch, shape=shape_name, mesh=name,
                         per_rank_gb=gb[0], sp_per_rank_gb=gb[1],
                         before_update_gb=before[0],
                         sp_before_update_gb=before[1],
                         collective_gb=coll[0], sp_collective_gb=coll[1]))
        emit(phase="roofline-mesh-sp", arch=arch, shape=shape_name,
             mesh=name, per_rank_gb=gb[0], sp_per_rank_gb=gb[1],
             before_update_gb=before[0], sp_before_update_gb=before[1],
             collective_gb=coll[0], sp_collective_gb=coll[1],
             source=sp["note"])
        # the activations a rank keeps fall: the step's peak, or where
        # the optimizer's update holds it (kimi-k2's Adafactor), the
        # peak before the update
        check(sp["seq_shard"] and not plain["seq_shard"]
              and sp["collectives"]["n_reduce-scatter"]
              > plain["collectives"]["n_reduce-scatter"]
              and gb[1] <= gb[0] and before[1] <= before[0]
              and (gb[1] < gb[0] or before[1] < before[0]),
              f"roofline {arch} x {shape_name} x {name}: --seq-shard "
              f"GB {gb[1]} (before the update {before[1]}) against "
              f"{gb[0]} ({before[0]}), collectives {coll}")
    return rows


def count_on(torch, dev, cfg, shape):
    """One run of ``shape``'s step for ``cfg`` under the dry run's counter
    on ``dev`` (the model drawn from seed 0): (the counter's summary, the
    card's peak bytes above what was allocated before the model was
    built)."""
    from repro_torch.launch.dryrun import cell_inputs, count
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model, step, args = cell_inputs(cfg, shape, dev, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    counted = count(model, step, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del model, step, args
    return counted, peak


def count_mesh_step(torch, trainer, cfg, shape):
    """The dry run's record of one more step of a mesh Trainer, counted on
    its device: the next batch's rows, ``step_local`` under a counter."""
    from repro_torch.launch.dryrun import Counter, record
    step = trainer._mesh_step
    rows = {k: torch.from_numpy(v).to(trainer.device) for k, v in
            step.local_rows(trainer.pipeline.batch_at(trainer.step)).items()}
    counter = Counter()
    counter.track((trainer.model.param_tree(),
                   (trainer.params, trainer.opt_state, rows)))
    with counter:
        out = step.step_local(trainer.params, trainer.opt_state,
                              trainer.ef_state, rows)
        del out
    torch.cuda.synchronize()
    return record(cfg, shape, counter)


def lm_mesh_phase(torch, dev, tokens) -> dict:
    """Phase lm-mesh: TinyLlama-1.1B (flash prefill) served through
    ``MeshServe`` on a (1, 1, 1) NCCL mesh, the rank's parameters and
    decode state as the per-rank dry run lays them out: a prefill of
    phase lm's prompt and MESH_DECODE greedy decode steps give phase lm's
    tokens (``tokens``, prefill's first), bit for bit, with one flash
    launch a layer (the cache as long as phase lm's, LM_S + LM_DECODE: a
    decode step's sums run over the whole cache, so another length may
    move a near tie of random weights); then the dry run's counter over
    the mesh prefill step (LM_B x LM_S) and one decode step (that cache)
    on the card (``mesh_cell_inputs``, seed 0), held in phase roofline
    against the (1, 1, 1) per-rank dry runs of MESH_HOLDS."""
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import count, mesh_cell_inputs, record
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.mesh import MeshServe
    cfg = get_config(LM_ARCH)
    counts = {}
    t0 = time.perf_counter()
    with nccl_world("lm_mesh"):
        mesh = make_host_mesh((1, 1, 1), ("pod", "data", "model"))
        model = build_model(get_config(LM_ARCH, attn_impl="flash"),
                            device=dev, seed=0)
        max_len = LM_S + LM_DECODE
        serve = MeshServe(model, mesh, LM_B, max_len)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (LM_B, LM_S)).astype(np.int32)).to(dev)
        ops.reset_launches()
        logits, state = serve.prefill(serve.rows(prompt), max_len)
        got = [logits.argmax(-1)]
        for _ in range(MESH_DECODE):
            logits, state = serve.decode_step(got[-1], state)
            got.append(logits.argmax(-1))
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if v}
        got = torch.stack(got)
        same = torch.equal(got, tokens)
        del model, serve, state, logits
        gc.collect()
        torch.cuda.empty_cache()
        for kind, s in (("prefill", LM_S), ("decode", max_len)):
            shape = ShapeConfig(f"{kind}_{LM_B}x{s}", s, LM_B, kind)
            m, step, args = mesh_cell_inputs(cfg, shape, mesh, dev, seed=0)
            counts[LM_ARCH, kind] = record(cfg, shape, count(m, step, args))
            del m, step, args
            gc.collect()
            torch.cuda.empty_cache()
    emit(phase="lm-mesh", arch=LM_ARCH, mesh=[1, 1, 1], backend="nccl",
         batch=LM_B, seq=LM_S, decode_steps=MESH_DECODE,
         tokens_equal_phase_lm=same, launches=launches,
         greedy_tokens_slot0=[int(t) for t in got[:, 0]],
         counted={kind: {k: counts[LM_ARCH, kind][k] for k in (
             "cost", "kernels")} for kind in ("prefill", "decode")},
         seconds=time.perf_counter() - t0)
    check(same, f"lm-mesh: tokens {got[:, 0].tolist()} against phase lm's "
                f"{tokens[:, 0].tolist()}")
    check(launches == {"flash_attention": cfg.n_layers,
                       "flash_attention.wgmma": cfg.n_layers},
          f"lm-mesh: launches {launches}")
    return counts, launches


def roofline_phase(torch, dev, started, measured_ms,
                   mesh_counts=None) -> dict:
    """Phase roofline: the 40-cell dry run (started by ``roofline_start``)
    and its roofline, one line a cell; ``HardwareModel``'s latency beside
    one small launch on the card; the counter over TinyLlama's prefill and
    zamba2's training step on the card equal to the same dry run on meta
    (FLOPs, bytes, kernel calls), the dry run's peak within PEAK_TOL of
    ``max_memory_allocated``, the bound beside the earlier phases' ms
    (``measured_ms``); the flash kernel at s = 32768 against its plain
    version; and every assigned cell that the dry run fits in 80 GB run
    once at full width (seeded random parameters,
    inputs and cache; decode at the cache's last position), timed beside
    its bound, its peak within PEAK_TOL of the dry run's; the cells of
    ASSIGNED_CELLS that do not fit reported with the dry run's GB."""
    from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig,
                                     get_config, get_shape, shape_applicable)
    from repro_torch.core.costmodel import HBM_BYTES, LAUNCH_LATENCY_S
    from repro_torch.kernels import bincount
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import DEVICE, cell_inputs, record
    smi = nvidia_smi_line()
    # -- the 40 cells, computed from shapes on the host ---------------------
    tmp, t0, procs = started
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            check(False, "roofline: a dry run timed out after 600 s")
        check(proc.returncode == 0, f"roofline: dry run failed: "
              f"{out[-2000:]} {err[-4000:]}")
    dry_s = time.perf_counter() - t0
    cells = {}
    for arch in ARCH_IDS:
        for sh in SHAPES:
            rec = roofline._load(f"{arch}_{sh.name}_{DEVICE}", tmp)
            check(rec is not None, f"roofline: no record of {arch} x "
                                   f"{sh.name}")
            ok, reason = shape_applicable(get_config(arch), sh)
            check(ok != bool(rec.get("skipped")) and
                  rec.get("skipped", "") == reason,
                  f"roofline: {arch} x {sh.name} skipped {rec.get('skipped')}")
            row = roofline.analyze_cell(rec)
            cells[arch, sh.name] = row
            emit(phase="roofline-cell", **({"arch": arch, "shape": sh.name,
                                            "skipped": reason} if not ok else
                                           {k: row[k] for k in (
                                               "arch", "shape", "compute_s",
                                               "memory_s", "collective_s",
                                               "dominant", "useful_ratio",
                                               "per_device_gb", "fits_80gb",
                                               "kernels")}),
                 source="computed from shapes (meta device), not measured")
    n_run = sum(not r.get("skipped") for r in cells.values())
    check(n_run == 32 and len(cells) == 40, f"roofline: {n_run} of "
                                            f"{len(cells)} cells ran")
    # -- per rank of a mesh: the cells, and the (1, 1, 1) holds --------------
    from repro_torch.core.distributed import COLLECTIVE_OPS
    from repro_torch.launch.dryrun import mesh_name
    from repro_torch.launch.mesh import MESHES
    for arch, shape_name, mesh in MESH_CELLS:
        name = mesh_name(MESHES[mesh])
        rec = roofline._load(f"{arch}_{shape_name}_{name}", tmp)
        check(rec is not None and not rec.get("skipped"),
              f"roofline: no record of {arch} x {shape_name} x {name}")
        row = roofline.analyze_cell(rec)
        coll = rec["collectives"]
        check(rec["chips"] == math.prod(MESHES[mesh]) and
              coll["raw_total"] > 0, f"roofline {arch} x {shape_name} x "
              f"{name}: chips {rec['chips']}, collectives {coll}")
        emit(phase="roofline-mesh-cell", arch=arch, shape=shape_name,
             mesh=name, chips=rec["chips"], rank=rec["rank"],
             per_rank_gb=row["per_device_gb"], fits_80gb=row["fits_80gb"],
             compute_s=row["compute_s"], memory_s=row["memory_s"],
             collective_s=row["collective_s"], dominant=row["dominant"],
             collective_gb={op: coll[op] / 1e9 for op in COLLECTIVE_OPS
                            if coll[op]},
             collective_n={op: coll["n_" + op] for op in COLLECTIVE_OPS
                           if coll[op]},
             source=rec["note"])
    mesh_sp_cells(tmp)
    mesh_held = []
    for arch, kind, b, s in MESH_HOLDS:
        dry = roofline._load(f"{arch}_{kind}_{b}x{s}_"
                             f"{mesh_name((1, 1, 1))}", tmp)
        card = (mesh_counts or {}).get((arch, kind))
        check(dry is not None and card is not None,
              f"roofline: no (1, 1, 1) count of {arch} {kind}")
        for key in ("cost", "kernels", "collectives"):
            check(card[key] == dry[key], f"roofline {arch} {kind} (1, 1, 1)"
                  f": {key} on the card {card[key]} against the per-rank "
                  f"dry run {dry[key]}")
        check(dry["collectives"]["raw_total"] == 0,
              f"roofline {arch} {kind} (1, 1, 1): collectives "
              f"{dry['collectives']}")
        mesh_held.append({"arch": arch, "kind": kind, "batch": b, "seq": s,
                          "flops": dry["cost"]["flops"],
                          "bytes": dry["cost"]["bytes accessed"],
                          "kernels": dry["kernels"]})
    emit(phase="roofline-mesh-held", checks=mesh_held,
         counted="train: one more step of phase train-mesh's auto Trainer; "
                 "prefill and decode: phase lm-mesh's steps",
         source="dry run: --mesh-shape 1,1,1 --grad-accum 1 on meta")
    meta = {(arch, kind): roofline._load(
        f"{arch}_{kind}_{b}x{s}_{DEVICE}", tmp)
        for arch, kind, b, s in ROOFLINE_CHECKS}
    roofline_stop(started)
    # -- one small launch against HardwareModel's latency_s ----------------
    T, tile_n, V = LATENCY_TILE
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    tiles = torch.randint(0, V, (T, tile_n), dtype=torch.int32, device=dev,
                          generator=gen)
    launch_ms = event_ms(lambda: bincount.bincount_tiles_cuda(tiles, V),
                         torch)
    del tiles
    # -- counts held against the card ----------------------------------------
    held = []
    for arch, kind, b, s in ROOFLINE_CHECKS:
        cfg = get_config(arch)
        shape = ShapeConfig(f"{kind}_{b}x{s}", s, b, kind)
        dry = meta[arch, kind]
        check(dry is not None, f"roofline: no dry run of {arch} {kind}")
        counted, peak = count_on(torch, dev, cfg, shape)
        card = record(cfg, shape, counted)
        for key in ("cost", "kernels"):
            check(card[key] == dry[key], f"roofline {arch} {kind}: {key} "
                  f"on the card {card[key]} against the dry run "
                  f"{dry[key]}")
        dry_peak = dry["memory"]["peak_bytes"]
        check(abs(dry_peak - peak) <= PEAK_TOL * peak,
              f"roofline {arch} {kind}: dry-run peak {dry_peak} against "
              f"max_memory_allocated {peak}")
        row = roofline.analyze_cell(dry)
        ms = measured_ms[arch]
        held.append({"arch": arch, "kind": kind, "batch": b, "seq": s,
                     "flops": dry["cost"]["flops"],
                     "bytes": dry["cost"]["bytes accessed"],
                     "kernels": dry["kernels"],
                     "dry_run_peak_bytes": dry_peak,
                     "max_memory_allocated": peak,
                     "peak_err": (dry_peak - peak) / peak,
                     "card_peak_from_storages":
                         card["memory"]["peak_bytes"],
                     "bound_ms": row["bound_s"] * 1e3,
                     "dominant": row["dominant"], "measured_ms": ms,
                     "measured_over_bound": ms / (row["bound_s"] * 1e3)})
    emit(phase="roofline-held", checks=held, nvidia_smi=smi,
         measured="TinyLlama: phase lm-timings' prefill (host-clock median); "
                  "zamba2: phase train's Trainer step (steps 3-8, one "
                  "batch of 8 x 2048, no microbatches)")
    # -- the flash kernel at the assigned prefill length ---------------------
    flash32k = flash_check(torch, dev, FLASH_32K, 32)
    gc.collect()
    torch.cuda.empty_cache()
    # -- the assigned cells that fit -----------------------------------------
    fit = [key for key, row in cells.items()
           if not row.get("skipped") and row["fits_80gb"]]
    assigned = []
    for arch, shape_name in [k for k in ASSIGNED_CELLS if k not in fit] + fit:
        row = cells[arch, shape_name]
        gb = row["per_device_gb"]
        rec = {"arch": arch, "shape": shape_name, "dry_run_gb": gb,
               "bound_ms": row["bound_s"] * 1e3, "dominant": row["dominant"]}
        if not row["fits_80gb"]:
            rec["ran"] = (f"no: the dry run places it over "
                          f"{HBM_BYTES / 1e9:.0f} GB")
            assigned.append(rec)
            emit(phase="roofline-assigned", **rec)
            continue
        cfg, shape = get_config(arch), get_shape(shape_name)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        model, step, args = cell_inputs(cfg, shape, dev, seed=0)
        if shape.kind == "decode":
            args[1].pos.fill_(shape.seq_len - 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        tok = out[0] if isinstance(out, tuple) else out
        check(tok.shape == (shape.global_batch,) and
              bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"roofline {arch} x {shape_name}: next tokens {tok}")
        if shape.kind == "decode":
            # a block at a time: the cache may hold most of the card
            check(all(bool(torch.isfinite(blk).all())
                      for t in out[1] if t.is_floating_point()
                      for blk in t.view(-1).split(1 << 28)),
                  f"roofline {arch} x {shape_name}: non-finite state")
        check(abs(gb * 1e9 - peak) <= PEAK_TOL * peak,
              f"roofline {arch} x {shape_name}: dry-run peak {gb} GB "
              f"against max_memory_allocated {peak / 1e9} GB")
        rec.update(ran="yes", ms=ms, measured_over_bound=ms / rec["bound_ms"],
                   max_memory_allocated=peak,
                   peak_over_dry_run=peak / (gb * 1e9))
        del model, step, args, out, tok
        assigned.append(rec)
        emit(phase="roofline-assigned", **rec,
             timed="host clock around one step ending in a synchronize, "
                   "the first (the compute-dtype copy of the weights made "
                   "inside, as in the dry run)")
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"dry_run_s": dry_s, "launch_ms": launch_ms,
               "launch_latency_s_in_costmodel": LAUNCH_LATENCY_S,
               "held": held, "flash_32k": flash32k, "assigned": assigned}
    emit(phase="roofline", nvidia_smi=smi, dry_run_s=dry_s,
         launch_ms=launch_ms, latency_s=LAUNCH_LATENCY_S,
         flash_32k=flash32k,
         ran=[f"{r['arch']} x {r['shape']}" for r in assigned
              if r["ran"] == "yes"],
         not_run=[f"{r['arch']} x {r['shape']} ({r['dry_run_gb']:.2f} GB)"
                  for r in assigned if r["ran"] != "yes"])
    return summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import LocalEngine, get_engine, sort_plan
    from repro_torch.core import kshuffle
    from repro_torch.core.mrmodel import shuffle_batch as dense_shuffle_batch
    from repro_torch.core.sortmr import pivot_sample_size, sample_indices
    from repro_torch.kernels import _build, bincount, bitonic_sort, ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    from repro_torch.core.costmodel import HBM_BW

    # -- 1. device ----------------------------------------------------------
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         mem_rate_bytes_s=HBM_BW)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.last_build["seconds"], library=str(lib_path),
         sources=[p.name for p in _build.sources()])
    # The kernels redesigned for Hopper: what ptxas gave them.  Dynamic
    # shared memory is set at launch: flash_wgmma_kernel<D> asks for
    # 128 D 2 + 4 * 64 D 2 + 1024 bytes (Q, two K and two V stages,
    # alignment), bitonic_regs<K, LOGC> for 2^LOGC * 17 / 16 * 8,
    # count_groups<Q> for G V 4 (at the sort's V = 2048, G = 8), scan_tiles
    # for none.
    hopper = ptxas_report((lib_path.parent / "build.log").read_text(),
                          ("flash_wgmma_kernel", "bitonic_regs", "scan_tiles",
                           "count_groups"))
    V_sort = sort_plan(N_MAIN, M_MAIN).n_nodes
    for row in hopper:
        name, t = row["kernel"].rstrip(">").split("<")
        t = t.split(",")
        row["dynamic_smem"] = {
            "flash_wgmma_kernel": lambda: 128 * int(t[0]) * 2
            + 4 * 64 * int(t[0]) * 2 + 1024,
            "bitonic_regs": lambda: (1 << int(t[1])) * 17 // 2,
            "count_groups": lambda: bincount.group_tiles(12288, 4096, V_sort)
            * V_sort * 4,
            "scan_tiles": lambda: 0}[name]()
    check(len(hopper) == 12 and all("registers" in r for r in hopper),
          f"ptxas report of the redesigned kernels: {hopper}")
    emit(phase="build-kernels", kernels=hopper,
         source="build.log of the library (nvcc -Xptxas -v)")
    dryrun = roofline_start()       # host work, joined by phase roofline
    gloo_jobs = {                   # host work, joined by their phases
        "moe": gloo_start("moe_gloo", 2, ("moe",), 120),
        "sharded": gloo_start("gloo", SHARDED_GLOO_WORLD,
                              SHARDED_GLOO_CASES, 240)}

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = {"bincount_tiles": 0.0, "bitonic_sort": 0.0}

    def held(name, got, want, ctx):
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {ctx}: shape/dtype {g.shape} {g.dtype} vs "
                  f"{w.shape} {w.dtype}")
            if g.numel():
                err = (g.double() - w.double()).abs().max().item()
                max_err[name] = max(max_err[name], err)
            check(torch.equal(g, w), f"{name} {ctx}: differs from the plain "
                                     f"version")

    checked = []
    for T, tile_n, V in ((4096, 4096, 2048), (12288, 4096, 2048),
                         (16, 8, 1 << 20), (1, 4096, 2048), (0, 4096, 2048),
                         (3, 0, 8), (5, 7, 100)):
        tiles = torch.randint(-1, V + 2, (T, tile_n), dtype=torch.int32,
                              device=dev, generator=gen)
        got = bincount.bincount_tiles_cuda(tiles, V)
        torch.cuda.synchronize()
        held("bincount_tiles", got, bincount.bincount_tiles_plain(tiles, V),
             (T, tile_n, V))
        checked.append(["bincount_tiles", T, tile_n, V])
    # The look-back's edges, from a generator of their own (the main path's
    # keys stay as they were): T = 1, G and G + 1 tiles where the group size
    # G changes with V, both sides of the route boundary, ids all outside
    # [0, V), whole tiles of one bucket, and the two mixed; each call on the
    # route group_tiles names.
    gen_b = torch.Generator(device=dev)
    gen_b.manual_seed(2)
    edges = [(T, 1024, V, "random") for V in BT_EDGE_V
             for G in [max(bincount.group_tiles(1, 1024, V), 1)]
             for T in (1, G, G + 1)]
    edges += [(12288, 4096, 2048, fill)
              for fill in ("outside", "uniform", "mixed")]
    for T, tile_n, V, fill in edges:
        if fill == "random":
            tiles = torch.randint(-2, V + 2, (T, tile_n), dtype=torch.int32,
                                  device=dev, generator=gen_b)
        else:
            outside = torch.tensor([-5, -1, V, V + 7], dtype=torch.int32,
                                   device=dev)[torch.randint(
                                       0, 4, (T, tile_n), device=dev,
                                       generator=gen_b)]
            uniform = torch.randint(0, V, (T, 1), dtype=torch.int32,
                                    device=dev, generator=gen_b)
            tiles = {"outside": outside,
                     "uniform": uniform.expand(T, tile_n).contiguous(),
                     "mixed": torch.where(torch.rand(
                         T, tile_n, device=dev, generator=gen_b) < 0.5,
                         outside, uniform)}[fill]
        route = ("single_pass" if bincount.group_tiles(T, tile_n, V)
                 else "global")
        before = dict(bincount.route_launches)
        got = bincount.bincount_tiles_cuda(tiles, V)
        torch.cuda.synchronize()
        check(bincount.route_launches[route] == before[route] + 1,
              f"bincount_tiles {T, tile_n, V}: not on the {route} route")
        held("bincount_tiles", got, bincount.bincount_tiles_plain(tiles, V),
             (T, tile_n, V, fill))
        checked.append(["bincount_tiles", T, tile_n, V, fill, route])
    # The batch axis: B queries' (T, tile_n) tiles in one launch, the
    # cross-tile prefix restarting at each query: at a sort query's tiles
    # (4096 of 4096 ids) with B = 4 on both routes (V = 2048, and V above
    # 48 Ki for the global route), with a group size G = 8 that does not
    # divide T = 13, and on the global route with two chunks of its column
    # scan a query.  Each query's tables also equal its own launch.
    gen_q = torch.Generator(device=dev)
    gen_q.manual_seed(4)
    for B_, T, tile_n, V in BT_BATCH:
        tiles = torch.randint(-1, V + 2, (B_, T, tile_n), dtype=torch.int32,
                              device=dev, generator=gen_q)
        route = ("single_pass" if bincount.group_tiles(T, tile_n, V, B_)
                 else "global")
        before = dict(bincount.route_launches)
        got = bincount.bincount_tiles_cuda(tiles, V)
        torch.cuda.synchronize()
        check(bincount.route_launches[route] == before[route] + 1,
              f"bincount_tiles {B_, T, tile_n, V}: not one launch on the "
              f"{route} route")
        held("bincount_tiles", got, bincount.bincount_tiles_plain(tiles, V),
             (B_, T, tile_n, V, route))
        for b in range(B_):
            held("bincount_tiles", [g[b] for g in got],
                 bincount.bincount_tiles_cuda(tiles[b], V),
                 (B_, T, tile_n, V, route, f"query {b} alone"))
        checked.append(["bincount_tiles batch", B_, T, tile_n, V, route])
        del tiles, got
    gc.collect()
    torch.cuda.empty_cache()

    def unique_rows(rows, n, dtype, gen):
        # distinct keys per row (the network is not stable; the shuffle's
        # keys are distinct), scattered over the key range
        keys = torch.rand(rows, n, device=dev, generator=gen).argsort(1)
        keys = keys.to(torch.int32) * 37 - 5000
        return keys.to(dtype) * 0.25 if dtype == torch.float32 else keys

    # The width sweep and the tie rows draw from their own generator, so
    # that checks added here leave the main path's keys (drawn from ``gen``
    # below) as they are.
    gen_w = torch.Generator(device=dev)
    gen_w.manual_seed(1)
    widths = [(1 if n == 1 << 18 else 3, n, dtype, gen_w)
              for n in BITONIC_WIDTHS
              for dtype in (torch.int32, torch.float32)]
    for rows, n, dtype, g in [(12288, 4096, torch.int32, gen),
                              (4096, 4096, torch.int32, gen),
                              (256, 4096, torch.float32, gen),
                              (64, 3000, torch.int32, gen),
                              (9, 1000, torch.float32, gen),
                              (1, 1 << 18, torch.int32, gen),
                              (2, 100000, torch.float32, gen),
                              (3, 1, torch.int32, gen)] + widths:
        keys = unique_rows(rows, n, dtype, g)
        vals = torch.randint(0, 1 << 30, (rows, n), dtype=torch.int32,
                             device=dev, generator=g)
        got = bitonic_sort.bitonic_sort_cuda(keys, vals)
        torch.cuda.synchronize()
        held("bitonic_sort", got, bitonic_sort.bitonic_sort_plain(keys, vals),
             (rows, n, str(dtype)))
        checked.append(["bitonic_sort", rows, n, str(dtype)])

    def pairs(k, v):
        # the (key bits, value) multiset of each row, as sorted int64s
        bits = k.view(torch.int32).long() & 0xFFFFFFFF
        return torch.sort((bits << 32) | (v.long() & 0xFFFFFFFF), 1).values

    # tie-heavy rows (the network is not stable): keys drawn from 8 values,
    # in float32 with both zeros; the keys come out sorted and the (key,
    # value) pairs are those that went in
    zeros = torch.tensor([0.0, -0.0, 1.5, -2.0, 3.0, -0.0, 0.0, 7.0],
                         device=dev)
    for rows, n in ((4096, 4096), (5, 33), (3, 4097), (2, 16385),
                    (1, 1 << 18)):
        for dtype in (torch.int32, torch.float32):
            pick = torch.randint(0, 8, (rows, n), device=dev,
                                 generator=gen_w)
            keys = (zeros[pick] if dtype == torch.float32
                    else (pick - 4).to(torch.int32))
            vals = torch.randint(0, 1 << 30, (rows, n), dtype=torch.int32,
                                 device=dev, generator=gen_w)
            gk, gv = bitonic_sort.bitonic_sort_cuda(keys, vals)
            torch.cuda.synchronize()
            check(bool((gk[:, 1:] >= gk[:, :-1]).all()),
                  f"bitonic_sort ties {rows, n, dtype}: keys not sorted")
            check(torch.equal(pairs(gk, gv), pairs(keys, vals)),
                  f"bitonic_sort ties {rows, n, dtype}: pairs changed")
            checked.append(["bitonic_sort ties", rows, n, str(dtype)])
    # What the network gives where the plain version differs (see
    # bitonic_sort_plain): tied keys, a +inf key in a row 3 wide (padded
    # to 4 with the float32 maximum), a NaN key.  Recorded, not checked.
    network = {}
    for tag, row in (("ties", [1, 1, 1, 0]), ("inf", [float("inf"), 1.0,
                                                      2.0]),
                     ("nan", [float("nan"), 1.0, 0.0, 2.0])):
        keys = torch.tensor([row], device=dev,
                            dtype=torch.int32 if tag == "ties"
                            else torch.float32)
        gk, gv = bitonic_sort.bitonic_sort_cuda(
            keys, torch.arange(len(row), dtype=torch.int32,
                               device=dev)[None])
        network[tag] = {"keys": [str(v) for v in gk[0].tolist()],
                        "values": gv[0].tolist()}
    emit(phase="kernels", checked=checked, max_abs_err=max_err,
         bitonic_network=network)

    # -- 4. the kernel shuffle against the dense one at main-path calls -----
    x = torch.randn(N_MAIN, device=dev, generator=gen)
    plan1 = sort_plan(N_MAIN, M_MAIN)
    V = plan1.n_nodes
    s = pivot_sample_size(N_MAIN, V, 8)

    class CheckedKernelEngine(LocalEngine):
        """Kernel engine that also runs the dense shuffle on every call and
        requires identical results."""

        def __init__(self):
            super().__init__(shuffle_impl="kernel", device=dev)
            self.calls = []

        def shuffle_batch(self, dests, payload, n_nodes, capacity):
            box, st = super().shuffle_batch(dests, payload, n_nodes,
                                            capacity)
            dbox, dst = dense_shuffle_batch(dests, payload, n_nodes,
                                            capacity)
            n = dests[0].numel()
            ctx = f"shuffle n={n} V={n_nodes} cap={capacity}"
            check(torch.equal(box.payload, dbox.payload), ctx + " payload")
            check(torch.equal(box.valid, dbox.valid), ctx + " valid")
            for name, a, b in zip(st._fields, st, dst):
                check(a.dtype == b.dtype == torch.int32 and torch.equal(a, b),
                      f"{ctx} RoundStats.{name} {a} vs {b}")
            self.calls.append({"n": n, "n_nodes": n_nodes,
                               "capacity": capacity,
                               "stats": [int(v) for v in st]})
            return box, st

    recorder = Recorder(ops)
    kshuffle._kops = recorder
    try:
        checker = CheckedKernelEngine()
        res = checker.compile(plan1)(x, key=SEEDS[0])
    finally:
        kshuffle._kops = ops
    torch.cuda.synchronize()
    check(torch.equal(res.values, torch.sort(x).values), "checked query")
    check(checker.route_log.snapshot() == (2, 0),
          f"checked query routes {checker.route_log.snapshot()}")
    emit(phase="shuffle", calls=checker.calls,
         kernel_inputs=[[c[0], list(c[1].shape)] for c in recorder.calls])

    # -- 5. the main path ---------------------------------------------------
    engine = get_engine("kernel", device=dev)
    dense = LocalEngine(device=dev)
    exe = engine.compile(plan1)
    dense_exe = dense.compile(plan1)
    ops.reset_launches()
    results = [exe(x, key=seed) for seed in SEEDS]
    torch.cuda.synchronize()
    launches = ops.launches()
    launches_sort = {k: launches[k] for k in SHUFFLE_KERNELS}
    route = engine.route_log.snapshot()
    check(route == (2 * len(SEEDS), 0), f"main path routes {route}")
    for name in ("bincount_tiles", "bitonic_sort",
                 "bincount_tiles.single_pass"):
        check(launches[name] == 2 * len(SEEDS),
              f"{name} launched {launches[name]} times on the main path")
    want = torch.sort(x).values
    queries = []
    for seed, res in zip(SEEDS, results):
        check(torch.equal(res.values, want), f"seed {seed}: values")
        check(int(res.stats.dropped) == 0, f"seed {seed}: dropped")
        ref = dense_exe(x, key=sample_indices(seed, N_MAIN, s, dev))
        for name, a, b in zip(res.stats._fields, res.stats, ref.stats):
            check(torch.equal(a, b), f"seed {seed}: CostAccum.{name} "
                                     f"{a} vs {b}")
        queries.append({"seed": seed, "stats": {k: float(v) for k, v in
                                                res.stats._asdict().items()}})
    emit(phase="main", n=N_MAIN, M=M_MAIN, V=V, levels=1, queries=queries,
         launches=launches, route_log=list(route))

    plan2 = sort_plan(N_MAIN, M_MAIN, levels=2)
    before = ops.launches()
    res2 = engine.compile(plan2)(x, key=SEEDS[1])
    ref2 = dense.compile(plan2)(x, key=SEEDS[1])
    torch.cuda.synchronize()
    check(torch.equal(res2.values, want), "levels=2: values")
    check(int(res2.stats.dropped) == 0, "levels=2: dropped")
    for name, a, b in zip(res2.stats._fields, res2.stats, ref2.stats):
        check(torch.equal(a, b), f"levels=2: CostAccum.{name} {a} vs {b}")
    grew = {k: ops.launches()[k] - before[k] for k in max_err}
    check(all(v == 3 for v in grew.values()), f"levels=2 launches {grew}")
    emit(phase="main-levels2", schedule=[list(r) for r in plan2.schedule()],
         launches=grew, stats={k: float(v) for k, v in
                               res2.stats._asdict().items()})

    # -- 5b. batched round programs: every family's exe.batch(B) ----------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch_paths = batch_phases(torch, dev, ops, engine)
    emit(phase="batch-summary", seconds=time.perf_counter() - t0,
         launches_by_path=batch_paths)

    # -- 6. timings ---------------------------------------------------------
    per_call = []
    totals = {name: {"ms": 0.0, "b2b_ms": 0.0, "plain_ms": 0.0,
                     "library_ms": 0.0, "bytes": 0, "ops": 0}
              for name in max_err}
    for name, a, b in recorder.calls:
        if name == "bincount_tiles":
            T, tile_n = math.prod(a.shape[:-1]), a.shape[-1]
            kern = event_ms(lambda: bincount.bincount_tiles_cuda(a, b), torch)
            b2b = b2b_ms(lambda: bincount.bincount_tiles_cuda(a, b), torch)
            plain = event_ms(lambda: bincount.bincount_tiles_plain(a, b),
                             torch)
            library = None
            held(name, bincount.bincount_tiles_cuda(a, b),
                 bincount.bincount_tiles_plain(a, b), "main-path inputs")
            nops, nbytes = bincount.bincount_tiles_work(T, tile_n, b)
        else:
            rows, n = a.shape
            kern = event_ms(lambda: bitonic_sort.bitonic_sort_cuda(a, b),
                            torch)
            b2b = b2b_ms(lambda: bitonic_sort.bitonic_sort_cuda(a, b), torch)
            plain = event_ms(lambda: bitonic_sort.bitonic_sort_plain(a, b),
                             torch)

            def library_sort():
                sk, order = torch.sort(a, dim=1)
                return sk, b.gather(1, order)
            library = event_ms(library_sort, torch)
            held(name, bitonic_sort.bitonic_sort_cuda(a, b),
                 bitonic_sort.bitonic_sort_plain(a, b), "main-path inputs")
            nops, nbytes = bitonic_sort.bitonic_sort_work(rows, n, a.dtype,
                                                          b.dtype)
        t = totals[name]
        t["ms"] += kern
        t["b2b_ms"] += b2b
        t["plain_ms"] += plain
        t["library_ms"] = None if library is None else t["library_ms"] + library
        t["bytes"] += nbytes
        t["ops"] += nops
        per_call.append({"kernel": name, "shape": list(a.shape), "ms": kern,
                         "b2b_ms": b2b, "plain_ms": plain,
                         "library_ms": library,
                         "bytes": nbytes, "ops": nops,
                         "bound_ms": bound_ms(nops, nbytes)})
    # bincount_tiles at the main path's shapes on tiles whose ids all name
    # one bucket: every shared-memory atomic of a warp hits one word
    gen_u = torch.Generator(device=dev)
    gen_u.manual_seed(3)
    one_bucket = []
    for name, a, b in recorder.calls:
        if name != "bincount_tiles":
            continue
        tiles = torch.randint(0, b, (*a.shape[:-1], 1), dtype=torch.int32,
                              device=dev, generator=gen_u).expand(
                                  a.shape).contiguous()
        held(name, bincount.bincount_tiles_cuda(tiles, b),
             bincount.bincount_tiles_plain(tiles, b), "one bucket a tile")
        one_bucket.append({"shape": list(a.shape), "ms": event_ms(
            lambda: bincount.bincount_tiles_cuda(tiles, b), torch)})
        del tiles
    # bincount_tiles with a batch axis: four sort queries' entry tiles
    # (4, 4096, 4096) into V buckets in one launch, beside the bound
    tiles = torch.randint(-1, V, (4, N_MAIN // 4096, 4096), dtype=torch.int32,
                          device=dev, generator=gen_u)
    held("bincount_tiles", bincount.bincount_tiles_cuda(tiles, V),
         bincount.bincount_tiles_plain(tiles, V), "a batch of four")
    batch_ops, batch_bytes = bincount.bincount_tiles_work(
        math.prod(tiles.shape[:-1]), tiles.shape[-1], V)
    batched = {"shape": list(tiles.shape), "ms": event_ms(
        lambda: bincount.bincount_tiles_cuda(tiles, V), torch),
        "b2b_ms": b2b_ms(lambda: bincount.bincount_tiles_cuda(tiles, V),
                         torch),
        "plain_ms": event_ms(lambda: bincount.bincount_tiles_plain(tiles, V),
                             torch),
        "bound_ms": bound_ms(batch_ops, batch_bytes),
        "bound_by": bound_by(batch_ops, batch_bytes)}
    del tiles
    emit(phase="kernel-timings", per_call=per_call,
         bincount_tiles_one_bucket=one_bucket,
         bincount_tiles_batch_of_four=batched,
         note="ms, plain_ms, library_ms and bound_ms in the summary are sums "
              "over the two calls of one levels=1 query (entry, local-sort); "
              f"CUDA-event medians of {REPS} after a warm-up")

    # Whole queries as a user calls them: the seed's splitter draw is inside.
    sort_ms = {
        "kernel_engine": host_ms(lambda: exe(x, key=SEEDS[0]), torch),
        "dense_engine": host_ms(lambda: dense_exe(x, key=SEEDS[0]), torch),
        "torch_sort": host_ms(lambda: torch.sort(x), torch),
        "splitter_draw": host_ms(
            lambda: sample_indices(SEEDS[0], N_MAIN, s, dev), torch),
    }
    emit(phase="sort-timings", n=N_MAIN, M=M_MAIN, ms=sort_ms,
         keys_per_s={k: N_MAIN / (v / 1e3) for k, v in sort_ms.items()
                     if k != "splitter_draw"},
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))

    sources = {"bincount_tiles": ("src/repro_torch/kernels/csrc/bincount_tiles.cu",
                                  "src/repro/kernels/bincount.py:123"),
               "bitonic_sort": ("src/repro_torch/kernels/csrc/bitonic_sort.cu",
                                "src/repro/kernels/bitonic_sort.py:103")}
    summary = []
    for name, t in totals.items():
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "b2b_ms": t["b2b_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms(t["ops"], t["bytes"]),
            "bound_by": bound_by(t["ops"], t["bytes"]),
            "library_ms": t["library_ms"],
            "per_call": [{k: r[k] for k in ("shape", "ms", "b2b_ms",
                                            "plain_ms", "bound_ms",
                                            "library_ms")}
                         for r in per_call if r["kernel"] == name]})

    tinyllama = lm_phases(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_counts, mesh_launches = lm_mesh_phase(torch, dev,
                                               tinyllama["tokens"])
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10-14. the sub-quadratic LMs and the last three kernels -------------
    entry = ssm_kernel_phase(torch, dev)
    lms = []
    for arch, tag in SSM_ARCHS:
        lms.append(ssm_lm_phase(torch, dev, arch, tag))
        gc.collect()                 # free each model before the next one
        torch.cuda.empty_cache()
    # -- 13b. the MoE, VLM and enc-dec serving paths ------------------------
    families = family_phases(torch, dev, gloo_jobs["moe"])
    totals = ssm_timings_phase(torch, dev, [r["timings"] for r in lms])
    # flash_attention: the sums over one call at each main-path shape
    # (TinyLlama's prefill, the hybrid's shared block), as the sort rows sum
    # over the calls of one query
    parts = [tinyllama["timing"]] + [r["flash"]["timing"] for r in lms
                                 if r["flash"]]
    flash_bytes_ms = sum(t["bytes_ms"] for t in parts)
    flash_ops_ms = sum(t["flops_ms_bf16"] for t in parts)
    summary.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": (tinyllama["launches"]
                     + mesh_launches["flash_attention"]
                     + sum(r["launches"]["flash_attention"]
                           for r in lms + families)),
        "max_abs_err": max([tinyllama["max_abs_err"]]
                           + [r["flash"]["max_abs_err"] for r in lms + families
                              if r["flash"]]),
        "ms": sum(t["flash_ms"] for t in parts),
        "b2b_ms": sum(t["flash_b2b_ms"] for t in parts),
        "plain_ms": sum(t["plain_ms"] for t in parts),
        "bound_ms": max(flash_bytes_ms, flash_ops_ms),
        "bound_by": ("bytes" if flash_bytes_ms >= flash_ops_ms
                     else "operations"),
        "library_ms": sum(t["sdpa_ms"] for t in parts),
        # launches by route on the main paths (bf16 prefill: wgmma), and
        # the float32 route's time at the same shapes beside its bound at
        # the CUDA-core rate
        "launches_by_route": {
            r: (tinyllama["routes"][r]
                + mesh_launches.get(f"flash_attention.{r}", 0)
                + sum(x["routes"][r] for x in lms + families))
            for r in ("wgmma", "cuda_core")},
        # each serving path's main run: one prefill (none in decode)
        "launches_by_path": {
            LM_ARCH: tinyllama["launches"],
            f"{LM_ARCH} (1, 1, 1) mesh": mesh_launches["flash_attention"],
            **{arch: r["launches"]["flash_attention"]
               for (arch, _), r in zip(SSM_ARCHS, lms)},
            **{p["timings"]["arch"]: p["launches"]["flash_attention"]
               for p in families}},
        "f32_ms": sum(t["flash_f32_ms"] for t in parts),
        "f32_library_ms": sum(t["sdpa_f32_ms"] for t in parts),
        "f32_bound_ms": max(flash_bytes_ms * 2, sum(t["flops_ms_f32"]
                                              for t in parts))})
    launches = {"ssm_scan": sum(r["launches"]["ssm_scan"] for r in lms),
                "prefix_scan": entry["launches"]["prefix_scan"],
                "bincount": entry["launches"]["bincount"]}
    sources = {"ssm_scan": "src/repro/kernels/ssm_scan.py:65",
               "prefix_scan": "src/repro/kernels/prefix_scan.py:64",
               "bincount": "src/repro/kernels/bincount.py:63"}
    for name, t in totals.items():
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": entry["max_abs_err"][name], "ms": t["ms"],
            "b2b_ms": t["b2b_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"], "per_call": t["per_call"]})
    # -- 14-19. the searching and simulation paths -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    queries, by_path = search_phases(torch, dev, ops, engine, dense)
    rows = search_timings(torch, queries)
    del queries
    by_path = {"sort": launches_sort, **batch_paths, **by_path}
    for r in rows:
        by_path[r["query"]] = r["launches"]
    emit(phase="search-summary", seconds=time.perf_counter() - t0,
         launches_by_path=by_path)
    # -- 20-23. the geometry ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    queries, chain_row, geo_paths = geometry_phases(torch, dev, ops, engine,
                                                    dense)
    geometry_timings(torch, queries, chain_row)
    del queries
    emit(phase="geometry-summary", seconds=time.perf_counter() - t0,
         launches_by_path=geo_paths)
    by_path.update(geo_paths)
    summary.append(chain_row)
    # -- 24-26. recovery, observability, the query service -----------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = service_phases(torch, dev, ops, engine, dense,
                            sort_ms["kernel_engine"])
    emit(phase="service-summary", seconds=time.perf_counter() - t0,
         launches_by_path=served)
    by_path.update(served)
    chain_row["launches_by_path"] = {
        "hull2d": chain_row["launches"],
        **{path: n["monotone_chain"] for path, n in served.items()
           if "monotone_chain" in n}}
    # -- 26b. the sharded round machine -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = sharded_phase(torch, dev, ops, engine)
    sharded_gloo_phase(gloo_jobs["sharded"])
    emit(phase="sharded-summary", seconds=time.perf_counter() - t0,
         launches_by_path=sharded)
    by_path.update(sharded)
    chain_row["launches_by_path"]["sharded-hull2d"] = \
        sharded["sharded-hull2d"]["monotone_chain"]
    # -- 27-30. training --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gloo = train_gloo_start()             # host work, beside phases 27-33
    try:
        bwd = train_kernel_phase(torch, dev)
        parity = train_parity_phase(torch, dev)
        trained = train_phase(torch, dev)
        resume = train_resume_phase(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        # -- 31-35. the parallel-training half: the mesh Trainer --------
        meshed = train_mesh_phase(torch, dev, trained["losses"],
                                  trained["timing"])
        mesh_paths_phase(torch, dev)
        moe_train_phase(torch, dev)
        train_gloo_phase(gloo)
    finally:
        train_gloo_stop(gloo)
    families_train_phase(torch, dev)
    # -- 36. the assigned shape cells and the roofline --------------------
    mesh_counts["zamba2-1.2b", "train"] = meshed["counted"]
    roofline_phase(torch, dev, dryrun, {
        "tinyllama-1.1b": tinyllama["prefill_ms"],
        "zamba2-1.2b": trained["timing"]["median_step_ms_3_to_8"]},
        mesh_counts)
    emit(phase="train-summary", seconds=time.perf_counter() - t0,
         parity=parity, launches=trained["launches"],
         mesh_launches=meshed["launches"],
         resume_final_loss_diff=resume["final_loss_diff"])
    t = bwd["totals"]
    summary.append({
        "name": "ssm_scan.bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:65",
        "vjp": "src/repro/kernels/ops.py:95 (_ssm_scan_bwd runs the "
               "kernel reversed)",
        "launches": meshed["launches"]["ssm_scan.bwd"],
        "launches_by_path": {"train": trained["launches"]["ssm_scan.bwd"],
                             "train-mesh": meshed["launches"][
                                 "ssm_scan.bwd"]},
        "max_abs_err": bwd["max_abs_err"], "ms": t["ms"],
        "b2b_ms": t["b2b_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": bound_ms(t["ops"], t["bytes"]),
        "bound_by": bound_by(t["ops"], t["bytes"]),
        "library_ms": None,
        "per_call": [{k: r[k] for k in ("shape", "ms", "b2b_ms",
                                        "plain_ms", "bound_ms",
                                        "library_ms")}
                     for r in bwd["per_call"]]})
    for row in summary:
        if row["name"] == "ssm_scan":
            # the forward kernel's launches on the training path as well
            row["launches_by_path"] = {
                "serving": row["launches"],
                "train": trained["launches"]["ssm_scan"],
                "train-mesh": meshed["launches"]["ssm_scan"]}
            row["launches"] += (trained["launches"]["ssm_scan"]
                                + meshed["launches"]["ssm_scan"])
    for row in summary[:2]:
        row["launches_by_path"] = {path: n[row["name"]]
                                   for path, n in by_path.items()}
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
