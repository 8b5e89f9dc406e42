"""Cost model of the I/O-memory-bound MapReduce framework (paper §1.2-1.3).

The paper evaluates algorithms by
  R  -- number of map-shuffle-reduce rounds,
  C  -- communication complexity (total items sent over all rounds),
  t  -- total internal running time (sum over rounds of the max reducer time),
and lower-bounds wall time by

  T = Omega(t + R*L + C/B)

where L is shuffle latency and B shuffle bandwidth.  Engines return a
:class:`RoundStats` per round and fold it into a :class:`CostAccum`; the
mutable :class:`MRCost` is the host-side reporting adapter.

Fields are 0-d tensors on the engine's device, so accounting a round reads
nothing back to the host; a batch of B queries keeps (B,) fields, updated
row by row.  ``communication`` and ``internal_time`` are
float32 and accumulate in float32 in the same order as the JAX package's
``CostAccum``, so the two round identically; the other fields are int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class RoundStats(NamedTuple):
    """Per-round shuffle observables (Theorem 2.1's send/keep/receive
    bounds), each an int32 0-d tensor."""

    items_sent: torch.Tensor     # sum_v |B_v(r)|  (includes keeps)
    max_sent: torch.Tensor       # max items sent by any node
    max_received: torch.Tensor   # max items received by any node
    dropped: torch.Tensor        # items lost to capacity overflow (0 = valid)


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


class CostAccum(NamedTuple):
    """Functional accumulator of the paper's complexity measures: every
    field is a 0-d tensor and updates return new values."""

    rounds: torch.Tensor
    communication: torch.Tensor
    internal_time: torch.Tensor
    max_reducer_io: torch.Tensor
    dropped: torch.Tensor

    @staticmethod
    def zero(device="cpu", shape=()) -> "CostAccum":
        """The empty accumulator; ``shape`` (B,) gives one per query of a
        batch, each field then (B,) and every update row by row."""
        def z(dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return CostAccum(rounds=z(torch.int32), communication=z(torch.float32),
                         internal_time=z(torch.float32),
                         max_reducer_io=z(torch.int32), dropped=z(torch.int32))

    def add_round(self, items_sent, max_io, dropped=0) -> "CostAccum":
        """Record one map-shuffle-reduce round (pure update)."""
        dev = self.rounds.device
        max_io = _scalar(max_io, torch.int32, dev)
        return CostAccum(
            rounds=self.rounds + 1,
            communication=(self.communication
                           + _scalar(items_sent, torch.float32, dev)),
            internal_time=self.internal_time + max_io.to(torch.float32),
            max_reducer_io=torch.maximum(self.max_reducer_io, max_io),
            dropped=self.dropped + _scalar(dropped, torch.int32, dev),
        )

    def add_round_stats(self, stats: RoundStats) -> "CostAccum":
        """Record one round from the shuffle's measured :class:`RoundStats`."""
        dev = self.rounds.device
        return self.add_round(
            items_sent=stats.items_sent,
            max_io=torch.maximum(_scalar(stats.max_sent, torch.int32, dev),
                                 _scalar(stats.max_received, torch.int32, dev)),
            dropped=stats.dropped)

    def merge_parallel(self, other: "CostAccum") -> "CostAccum":
        """Costs incurred in parallel: rounds/time take the max, comm adds."""
        return CostAccum(
            rounds=torch.maximum(self.rounds, other.rounds),
            communication=self.communication + other.communication,
            internal_time=torch.maximum(self.internal_time, other.internal_time),
            max_reducer_io=torch.maximum(self.max_reducer_io,
                                         other.max_reducer_io),
            dropped=self.dropped + other.dropped,
        )

    def merge_sequential(self, other: "CostAccum") -> "CostAccum":
        return CostAccum(
            rounds=self.rounds + other.rounds,
            communication=self.communication + other.communication,
            internal_time=self.internal_time + other.internal_time,
            max_reducer_io=torch.maximum(self.max_reducer_io,
                                         other.max_reducer_io),
            dropped=self.dropped + other.dropped,
        )

    def to_mrcost(self) -> "MRCost":
        """Host-side reporting adapter (the one synchronization point)."""
        return MRCost(rounds=int(self.rounds),
                      communication=int(self.communication),
                      internal_time=int(self.internal_time),
                      max_reducer_io=int(self.max_reducer_io))


@dataclasses.dataclass
class MRCost:
    """Accumulator for the paper's three complexity measures."""

    rounds: int = 0
    communication: int = 0        # items sent, summed over rounds
    internal_time: int = 0        # sum over rounds of max reducer I/O
    max_reducer_io: int = 0       # max_{r,i} n_{r,i}: must stay <= M

    def round(self, items_sent: int, max_io: int) -> None:
        """Record one map-shuffle-reduce round."""
        self.rounds += 1
        self.communication += int(items_sent)
        self.internal_time += int(max_io)
        self.max_reducer_io = max(self.max_reducer_io, int(max_io))

    def merge_parallel(self, other: "MRCost") -> None:
        """Merge a cost incurred *in parallel* with this one: rounds take
        the max, communication adds."""
        self.rounds = max(self.rounds, other.rounds)
        self.communication += other.communication
        self.internal_time = max(self.internal_time, other.internal_time)
        self.max_reducer_io = max(self.max_reducer_io, other.max_reducer_io)

    def merge_sequential(self, other: "MRCost") -> None:
        self.rounds += other.rounds
        self.communication += other.communication
        self.internal_time += other.internal_time
        self.max_reducer_io = max(self.max_reducer_io, other.max_reducer_io)

    def absorb(self, accum: CostAccum) -> None:
        """Fold a functional :class:`CostAccum` into this reporting object
        (the single host-synchronization point)."""
        self.merge_sequential(accum.to_mrcost())

    @classmethod
    def from_accum(cls, accum: CostAccum) -> "MRCost":
        return accum.to_mrcost()

    def check_io_bound(self, M: int) -> None:
        if self.max_reducer_io > M:
            raise ValueError(
                f"I/O-memory bound violated: reducer I/O {self.max_reducer_io} > M={M}"
            )

    def lower_bound_time(self, *, latency_s: float, bandwidth_items_s: float,
                         item_time_s: float = 1e-9) -> float:
        """Evaluate T = t + R*L + C/B with concrete constants (seconds)."""
        return (self.internal_time * item_time_s
                + self.rounds * latency_s
                + self.communication / bandwidth_items_s)


def log_M(n: int, M: int) -> int:
    """ceil(log_M n) with the paper's convention log_M n >= 1 for n > 1."""
    if n <= 1:
        return 1
    if M < 2:
        raise ValueError("M must be >= 2")
    return max(1, math.ceil(math.log(n) / math.log(M)))


def tree_height(n_leaves: int, d: int) -> int:
    """Height L = ceil(log_d n) of the paper's d-ary trees (root = level 0)."""
    if n_leaves <= 1:
        return 1
    if d < 2:
        raise ValueError("branching factor must be >= 2")
    return max(1, math.ceil(math.log(n_leaves) / math.log(d)))


# One NVIDIA H100 SXM 80 GB (NVIDIA's data sheet: dense rates, no sparsity,
# at the full 700 W power limit), the constants the abstract cost model and
# the roofline (repro_torch.launch.roofline) map onto the card.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # device memory
NVLINK_BW_PER_LINK = 25e9         # bytes/s, one NVLink 4 link, one direction
#: one shuffle hop's fixed cost on the card (the paper's L): the median
#: CUDA-event time of one ``bincount_tiles`` call on one (1, 4096) tile
#: into 2048 buckets, one call between an event pair, so that the
#: wrapper's host work (its allocations and the ctypes call) is inside;
#: measured by ``chip_smoke.py`` (phase ``roofline``) on an NVIDIA H100
#: 80GB HBM3 at a 700.00 W power limit: 0.0574 ms in a whole run of the
#: script (0.1056 ms in a run of the phase alone)
LAUNCH_LATENCY_S = 5.74e-5


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Maps the paper's (L, B) shuffle network onto the card: the
    counterpart of the JAX package's TPU ``HardwareModel``, with the same
    fields and formula and the H100's figures.  ``ici_bw_per_link`` holds
    NVLink's rate a link on this card (the TPU's inter-chip link there),
    ``latency_s`` one launch's time on the card."""

    chips: int
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw_per_link: float = NVLINK_BW_PER_LINK
    latency_s: float = LAUNCH_LATENCY_S

    def shuffle_time(self, cost: MRCost, bytes_per_item: int = 4) -> float:
        """Paper lower bound T = Omega(t + R*L + C/B) with B = the chips'
        aggregate link bandwidth and t charged at the HBM streaming rate."""
        agg_bw_items = self.chips * self.ici_bw_per_link / bytes_per_item
        t_seconds = cost.internal_time * bytes_per_item / self.hbm_bw
        return (t_seconds
                + cost.rounds * self.latency_s
                + cost.communication / agg_bw_items)
