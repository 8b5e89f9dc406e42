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
              one bucket and the two mixed, each call on its route;
4. shuffle  — the kernel shuffle against the dense shuffle at both calls of
              a main-path query: mailbox, validity and RoundStats identical;
5. main     — the §4.3 sample sort of n = 2^24 float32 keys at M = 8192
              through LocalEngine(shuffle_impl="kernel"): values equal
              torch.sort, no drops, CostAccum equal to the dense engine fed
              the same sample, every shuffle routed to the kernels, and both
              kernels launched, every ``bincount_tiles`` launch on its
              single-pass route; then a levels=2 query and exe.batch(4);
6. timings  — CUDA-event medians of each kernel, its plain version and its
              library yardstick at the main path's inputs, beside the
              bound, per call; ``bincount_tiles`` also on tiles whose ids
              all name one bucket (every shared-memory atomic of a warp on
              one word); and host-clock medians of whole sort queries;
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
              the ServeEngine draining 16 requests (phase lm-serve); with the
              launch counts reset just before and read just after.  Then
              float32 prefill against token-by-token decode, and the bf16
              flash path against the plain attention path;
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
              profiles.

The last three lines are the kernels summary, the ``nvidia-smi`` name and
power line, and ``{"ok": true, "device": {...}}``; the summary's
``flash_attention`` row also gives its launches by route and the float32
route's time beside that route's bound.  A kernel's times and
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
N_MAIN = 1 << 24          # keys sorted by a main-path query
M_MAIN = 8192             # reducer I/O bound: V = 2048 reducers
SEEDS = (101, 202, 303)
REPS = 7
#: H100 memory rates (bytes/s), NVIDIA's data sheets; the name picks one
MEM_RATES = (("PCIe", 2.0e12), ("NVL", 3.9e12), ("H100", 3.35e12))
#: float32 rate outside the tensor cores (FLOP/s), the H100 SXM data sheet;
#: used for the comparisons of the sort network (int32 or float32 keys)
ALU_RATE = 67e12
#: dense bf16 tensor-core rate (FLOP/s), the H100 SXM data sheet
BF16_RATE = 989e12
LM_ARCH = "tinyllama-1.1b"
LM_B, LM_S, LM_DECODE = 8, 2048, 32       # prefill batch and length, steps
DECODE_WINDOW = 5                          # decode steps in a profiled window
#: flash_attention shapes (b, hq, hkv, s_q, s_k, d, causal): TinyLlama's
#: prefill, then the edge shapes of tests/test_kernels.py, one query
#: against a 512-key cache, lengths off the wgmma kernel's tiles (128
#: queries, 64 keys) at d 64 and 128, every head dim causal and ragged, and
#: d 128 causal at s 2048
FLASH_MAIN = (LM_B, 32, 4, LM_S, LM_S, 64, True)
FLASH_EDGE = ((2, 4, 2, 128, 128, 64, True), (1, 2, 2, 200, 200, 32, False),
              (1, 8, 2, 256, 256, 64, True), (1, 2, 1, 100, 100, 48, True),
              (2, 4, 4, 64, 64, 128, False), (2, 4, 4, 1, 512, 64, False),
              (1, 4, 2, 300, 300, 128, True), (2, 4, 4, 200, 200, 64, False),
              (1, 2, 2, 77, 333, 128, False), (1, 4, 1, 129, 129, 32, True),
              (1, 4, 4, 65, 65, 48, False), (2, 16, 4, LM_S, LM_S, 128, True))
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
BINCOUNT_EDGE = ((0, 8), (13, 64), (31, 5), (6, 100), (1 << 20, 100000))


def emit(**rec) -> None:
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
    32 new tokens each; ``eng.admitted`` holds the order in which they left
    the queue."""
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
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=32))
    eng.run_until_drained()
    return eng


def check_drain(eng, n: int) -> dict:
    """Every request finished with 32 tokens, at most 8 in a round, in
    FIFO order; returns the engine's stats."""
    st = eng.stats()
    check(st["requests"] == n and len(eng.finished) == n,
          f"serve finished {st['requests']} of {n}")
    check(all(len(r.output) == 32 for r in eng.finished), "serve outputs")
    check(eng.cost.max_reducer_io <= 8,
          f"max_reducer_io {eng.cost.max_reducer_io} > 8")
    check(eng.admitted == list(range(n)), f"admission {eng.admitted}")
    return st


def lm_host_timings(torch, model, prompt, requests, prefill_reps: int = 5):
    """Host-clock timings of a served LM: prefill of ``prompt`` (median of
    ``prefill_reps``), one decode step against LM_S - 1 cached tokens (15
    reps; each step starts from the same state) and a serve drain (the
    middle of three).  Returns them with the prefill and decode closures."""
    def prefill():
        return model.prefill(prompt, max_len=LM_S)

    prefill_runs = host_times(prefill, torch, reps=prefill_reps)
    prefill_ms = statistics.median(prefill_runs)
    _, state = model.prefill(prompt[:, :LM_S - 1], max_len=LM_S)
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
        "prefill_tokens_per_s": prompt.numel() / (prefill_ms / 1e3),
        "decode_step_ms": statistics.median(decode_runs),
        "decode_step_ms_runs": decode_runs, "decode_batch": prompt.shape[0],
        "serve_drain_s": drain_s,
        "serve_tokens_per_s": drain_stats["tokens"] / drain_s,
        "serve_mean_ttft_s": drain_stats["mean_ttft_s"],
        "serve_mean_latency_s": drain_stats["mean_latency_s"],
        "serve_rounds": drain_stats["rounds"]}
    return timings, prefill, decode


class Recorder:
    """Stands in for kshuffle's kernel module: records each kernel call's
    inputs, then forwards to the real dispatch."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = []

    def bincount_tiles(self, tiles, n_buckets):
        self.calls.append(("bincount_tiles", tiles, n_buckets))
        return self.ops.bincount_tiles(tiles, n_buckets)

    def bitonic_sort(self, keys, values):
        self.calls.append(("bitonic_sort", keys, values))
        return self.ops.bitonic_sort(keys, values)


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


def flash_timing(torch, dev, shape, mem_rate) -> dict:
    """CUDA-event medians of flash_attention (bf16 and f32), its plain
    version and torch's SDPA at a causal ``shape``, beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    q, k, v = flash_inputs(torch, dev, shape, torch.bfloat16, 7)
    kern_ms = event_ms(lambda: flash.flash_attention_cuda(q, k, v, True),
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
    del q32, k32, v32
    b, hq, hkv, s, _, d, _ = shape
    flops = 4 * b * hq * d * s * (s + 1) // 2     # unmasked pairs only
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    return {"shape": list(shape), "flash_ms": kern_ms,
            "flash_f32_ms": kern32_ms, "plain_ms": plain_ms,
            "sdpa_ms": sdpa_ms, "flops": flops, "bytes": nbytes,
            "bytes_ms": nbytes / mem_rate * 1e3,
            "flops_ms_bf16": flops / BF16_RATE * 1e3,
            "flops_ms_f32": flops / ALU_RATE * 1e3}


def lm_phases(torch, dev, mem_rate) -> dict:
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
    flash_t = flash_timing(torch, dev, FLASH_MAIN, mem_rate)
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
            "max_abs_err": max_abs, "timing": flash_t}


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
    version; fails if the kernel was launched there all the same."""
    from repro_torch.kernels import ops, ssm_scan
    kernel, before = ops.ssm_scan, ops.launches()["ssm_scan"]
    ops.ssm_scan = ssm_scan.ssm_scan_plain
    try:
        yield
    finally:
        ops.ssm_scan = kernel
    check(ops.launches()["ssm_scan"] == before,
          "the ssm_scan kernel ran where its plain version should have")


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


def ssm_lm_phase(torch, dev, mem_rate, arch: str, tag: str) -> dict:
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
                 "timing": flash_timing(torch, dev, shape, mem_rate)}
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


def ssm_timings_phase(torch, dev, mem_rate, lm_timings) -> list:
    """Phase ssm-timings: CUDA-event medians of ssm_scan, prefix_scan and
    bincount, their plain versions and yardsticks at the main shapes,
    beside the bound, with the models' host-clock timings.  Returns the
    per-kernel totals of the summary line."""
    from repro_torch.kernels import bincount, prefix_scan, ssm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    per_call = []

    def row(name, shape, kern, plain, library, nbytes, nops):
        per_call.append({"kernel": name, "shape": shape, "ms": kern,
                         "plain_ms": plain, "library_ms": library,
                         "bytes": nbytes, "ops": nops,
                         "bytes_ms": nbytes / mem_rate * 1e3,
                         "ops_ms": nops / ALU_RATE * 1e3,
                         "bound_ms": max(nbytes / mem_rate,
                                         nops / ALU_RATE) * 1e3})

    for shape in SSM_MAIN:
        a = torch.rand(shape, device=dev, generator=gen)
        x = torch.randn(shape, device=dev, generator=gen)
        row("ssm_scan", list(shape),
            event_ms(lambda: ssm_scan.ssm_scan_cuda(a, x), torch),
            event_ms(lambda: ssm_scan.ssm_scan_plain(a, x), torch), None,
            3 * a.numel() * 4, 2 * a.numel())
        del a, x
    for rows, n, dt, ex in SCAN_MAIN:
        x = scan_input(torch, dev, gen, rows, n, dt)
        row("prefix_scan", [rows, n, dt, ex],
            event_ms(lambda: prefix_scan.prefix_scan_cuda(x, ex), torch),
            event_ms(lambda: prefix_scan.prefix_scan_plain(x, ex), torch),
            event_ms(lambda: torch.cumsum(x, -1, dtype=x.dtype), torch),
            2 * x.numel() * 4, x.numel())
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
        n * 4 + V * 4, n)
    emit(phase="ssm-timings", per_call=per_call, models=lm_timings,
         note=f"kernel rows: CUDA-event medians of {REPS} after a warm-up; "
              "models: host-clock medians ending in a synchronize, one "
              "profiled prefill and a profiled window of "
              f"{DECODE_WINDOW} decode steps (per step); busy_share = "
              "device ms over the unprofiled median wall ms")
    totals = {}
    for r in per_call:
        t = totals.setdefault(r["kernel"], {"ms": 0.0, "plain_ms": 0.0,
                                            "library_ms": 0.0,
                                            "bytes_ms": 0.0, "ops_ms": 0.0})
        for k in ("ms", "plain_ms", "bytes_ms", "ops_ms"):
            t[k] += r[k]
        t["library_ms"] = (None if r["library_ms"] is None
                           else t["library_ms"] + r["library_ms"])
        t.setdefault("per_call", []).append(
            {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                               "library_ms")})
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import LocalEngine, get_engine, sort_plan
    from repro_torch.core import kshuffle
    from repro_torch.core.mrmodel import shuffle as dense_shuffle
    from repro_torch.core.sortmr import pivot_sample_size, sample_indices
    from repro_torch.kernels import _build, bincount, bitonic_sort, ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    mem_rate = next((rate for tag, rate in MEM_RATES if tag in kind), 3.35e12)

    # -- 1. device ----------------------------------------------------------
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         mem_rate_bytes_s=mem_rate)

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
    emit(phase="kernels", checked=checked, max_abs_err=max_err)

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

        def shuffle(self, dests, payload, n_nodes, capacity):
            box, st = super().shuffle(dests, payload, n_nodes, capacity)
            dbox, dst = dense_shuffle(dests, payload, n_nodes, capacity)
            ctx = f"shuffle n={dests.numel()} V={n_nodes} cap={capacity}"
            check(torch.equal(box.payload, dbox.payload), ctx + " payload")
            check(torch.equal(box.valid, dbox.valid), ctx + " valid")
            for name, a, b in zip(st._fields, st, dst):
                check(a.dtype == b.dtype == torch.int32 and torch.equal(a, b),
                      f"{ctx} RoundStats.{name} {a} vs {b}")
            self.calls.append({"n": dests.numel(), "n_nodes": n_nodes,
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

    n_b, B = 1 << 20, 4
    exe_b = engine.compile(sort_plan(n_b, M_MAIN))
    xs = torch.randn(B, n_b, device=dev, generator=gen)
    keys = list(range(B))
    out = exe_b.batch(B)(xs, keys=keys)
    for i in range(B):
        one = exe_b(xs[i], key=keys[i])
        check(torch.equal(out.values[i], one.values), f"batch row {i}")
        check(torch.equal(out.values[i], torch.sort(xs[i]).values),
              f"batch row {i} sorted")
        for name, a, b in zip(one.stats._fields, out.stats, one.stats):
            check(torch.equal(a[i], b), f"batch row {i} CostAccum.{name}")
    emit(phase="batch", n=n_b, B=B, ok=True)

    # -- 6. timings ---------------------------------------------------------
    per_call = []
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bytes": 0, "ops": 0} for name in max_err}
    for name, a, b in recorder.calls:
        if name == "bincount_tiles":
            T, tile_n = a.shape
            kern = event_ms(lambda: bincount.bincount_tiles_cuda(a, b), torch)
            plain = event_ms(lambda: bincount.bincount_tiles_plain(a, b),
                             torch)
            library = None
            held(name, bincount.bincount_tiles_cuda(a, b),
                 bincount.bincount_tiles_plain(a, b), "main-path inputs")
            nbytes = T * tile_n * 4 + 3 * T * b * 4
            nops = T * tile_n
        else:
            rows, n = a.shape
            kern = event_ms(lambda: bitonic_sort.bitonic_sort_cuda(a, b),
                            torch)
            plain = event_ms(lambda: bitonic_sort.bitonic_sort_plain(a, b),
                             torch)

            def library_sort():
                sk, order = torch.sort(a, dim=1)
                return sk, b.gather(1, order)
            library = event_ms(library_sort, torch)
            held(name, bitonic_sort.bitonic_sort_cuda(a, b),
                 bitonic_sort.bitonic_sort_plain(a, b), "main-path inputs")
            n_pad = 1 << max(0, (n - 1).bit_length())
            L = int(math.log2(n_pad))
            nbytes = 4 * rows * n * 4
            nops = rows * (n_pad // 2) * L * (L + 1) // 2
        t = totals[name]
        t["ms"] += kern
        t["plain_ms"] += plain
        t["library_ms"] = None if library is None else t["library_ms"] + library
        t["bytes"] += nbytes
        t["ops"] += nops
        per_call.append({"kernel": name, "shape": list(a.shape), "ms": kern,
                         "plain_ms": plain, "library_ms": library,
                         "bytes": nbytes, "ops": nops,
                         "bound_ms": max(nbytes / mem_rate,
                                         nops / ALU_RATE) * 1e3})
    # bincount_tiles at the main path's shapes on tiles whose ids all name
    # one bucket: every shared-memory atomic of a warp hits one word
    gen_u = torch.Generator(device=dev)
    gen_u.manual_seed(3)
    one_bucket = []
    for name, a, b in recorder.calls:
        if name != "bincount_tiles":
            continue
        tiles = torch.randint(0, b, (a.shape[0], 1), dtype=torch.int32,
                              device=dev, generator=gen_u).expand(
                                  a.shape).contiguous()
        held(name, bincount.bincount_tiles_cuda(tiles, b),
             bincount.bincount_tiles_plain(tiles, b), "one bucket a tile")
        one_bucket.append({"shape": list(a.shape), "ms": event_ms(
            lambda: bincount.bincount_tiles_cuda(tiles, b), torch)})
        del tiles
    emit(phase="kernel-timings", per_call=per_call,
         bincount_tiles_one_bucket=one_bucket,
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
        bytes_ms = t["bytes"] / mem_rate * 1e3
        ops_ms = t["ops"] / ALU_RATE * 1e3
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
            "per_call": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                            "bound_ms", "library_ms")}
                         for r in per_call if r["kernel"] == name]})

    tinyllama = lm_phases(torch, dev, mem_rate)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10-14. the sub-quadratic LMs and the last three kernels -------------
    entry = ssm_kernel_phase(torch, dev)
    lms = []
    for arch, tag in SSM_ARCHS:
        lms.append(ssm_lm_phase(torch, dev, mem_rate, arch, tag))
        gc.collect()                 # free each model before the next one
        torch.cuda.empty_cache()
    totals = ssm_timings_phase(torch, dev, mem_rate,
                               [r["timings"] for r in lms])
    # flash_attention: the sums over one call at each main-path shape
    # (TinyLlama's prefill, the hybrid's shared block), as the sort rows sum
    # over the calls of one query
    parts = [tinyllama["timing"]] + [r["flash"]["timing"] for r in lms
                                 if r["flash"]]
    bytes_ms = sum(t["bytes_ms"] for t in parts)
    ops_ms = sum(t["flops_ms_bf16"] for t in parts)
    summary.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": (tinyllama["launches"]
                     + sum(r["launches"]["flash_attention"] for r in lms)),
        "max_abs_err": max([tinyllama["max_abs_err"]]
                           + [r["flash"]["max_abs_err"] for r in lms
                              if r["flash"]]),
        "ms": sum(t["flash_ms"] for t in parts),
        "plain_ms": sum(t["plain_ms"] for t in parts),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(t["sdpa_ms"] for t in parts),
        # launches by route on the main paths (bf16 prefill: wgmma), and
        # the float32 route's time at the same shapes beside its bound at
        # the CUDA-core rate
        "launches_by_route": {
            r: tinyllama["routes"][r] + sum(x["routes"][r] for x in lms)
            for r in ("wgmma", "cuda_core")},
        "f32_ms": sum(t["flash_f32_ms"] for t in parts),
        "f32_bound_ms": max(bytes_ms * 2, sum(t["flops_ms_f32"]
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
            "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"], "per_call": t["per_call"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
