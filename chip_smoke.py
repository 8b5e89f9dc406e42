#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any mismatch raises and the script
exits non-zero:

1. device   — the card, and ``nvidia-smi``'s name and power limit;
2. build    — nvcc builds the kernels from src/repro_torch/kernels/csrc;
3. kernels  — each kernel against its plain PyTorch version, exactly, at
              the main path's shapes and at edge shapes;
4. shuffle  — the kernel shuffle against the dense shuffle at both calls of
              a main-path query: mailbox, validity and RoundStats identical;
5. main     — the §4.3 sample sort of n = 2^24 float32 keys at M = 8192
              through LocalEngine(shuffle_impl="kernel"): values equal
              torch.sort, no drops, CostAccum equal to the dense engine fed
              the same sample, every shuffle routed to the kernels, and both
              kernels launched; then a levels=2 query and exe.batch(4);
6. timings  — CUDA-event medians of each kernel, its plain version and its
              library yardstick at the main path's inputs, beside the bound;
              and host-clock medians of whole sort queries.

The last three lines are the kernels summary, the ``nvidia-smi`` name and
power line, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside it, the script fails before any result.
"""
from __future__ import annotations

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


def host_ms(fn, torch, reps: int = 5) -> float:
    """Median wall time of fn() ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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

    def unique_rows(rows, n, dtype):
        # distinct keys per row (the network is not stable; the shuffle's
        # keys are distinct), scattered over the key range
        keys = torch.rand(rows, n, device=dev, generator=gen).argsort(1)
        keys = keys.to(torch.int32) * 37 - 5000
        return keys.to(dtype) * 0.25 if dtype == torch.float32 else keys

    for rows, n, dtype in ((12288, 4096, torch.int32),
                           (4096, 4096, torch.int32),
                           (256, 4096, torch.float32),
                           (64, 3000, torch.int32), (9, 1000, torch.float32),
                           (1, 1 << 18, torch.int32),
                           (2, 100000, torch.float32), (3, 1, torch.int32)):
        keys = unique_rows(rows, n, dtype)
        vals = torch.randint(0, 1 << 30, (rows, n), dtype=torch.int32,
                             device=dev, generator=gen)
        got = bitonic_sort.bitonic_sort_cuda(keys, vals)
        torch.cuda.synchronize()
        held("bitonic_sort", got, bitonic_sort.bitonic_sort_plain(keys, vals),
             (rows, n, str(dtype)))
        checked.append(["bitonic_sort", rows, n, str(dtype)])
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
    for name, count in launches.items():
        check(count == 2 * len(SEEDS), f"{name} launched {count} times on "
                                       f"the main path")
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
    grew = {k: ops.launches()[k] - before[k] for k in before}
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
                         "bytes": nbytes, "ops": nops})
    emit(phase="kernel-timings", per_call=per_call,
         note="ms, plain_ms, library_ms and bound_ms in the summary are sums "
              "over the two calls of one levels=1 query (entry, local-sort)")

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
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
