"""Data pipeline: a deterministic synthetic corpus and the global batch
loader, the port of ``repro.data.pipeline``.

Everything is numpy, so ``batch_at(step)`` returns the JAX package's batch
bit for bit, and the trainer moves it to its device each step.

  * *Deterministic resumability*: batches are a pure function of
    (seed, step), so a checkpoint restart resumes the exact stream with no
    loader state to persist.
  * *Global shuffle = the paper's sample sort* (§4.3): document order is a
    permutation produced by sorting random keys, through the port's
    ``sort_plan_escalating`` when ``paper_shuffle``, or a stable argsort
    otherwise (the same permutation).

The corpus mixes Zipfian unigrams with a deterministic successor chain, so
that models learn (the loss falls) in a few steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig


def global_shuffle_indices(n: int, seed: int, paper_shuffle: bool = False,
                           M: int = 4096, device="cuda") -> np.ndarray:
    """Permutation of [0, n): random keys ranked by sorting; with
    ``paper_shuffle`` through the paper's sample sort on a dense
    ``LocalEngine`` on ``device`` (the card unless the caller asks for the
    CPU)."""
    rng = np.random.default_rng(seed)
    keys = rng.random(n).astype(np.float32)
    if paper_shuffle:
        from ..core.engine import LocalEngine
        from ..core.sortmr import sort_plan_escalating
        engine = LocalEngine(device=device)
        res = sort_plan_escalating(torch.from_numpy(keys).to(engine.device),
                                   M, engine=engine)
        sorted_keys = res.values.cpu().numpy()
        ranks = np.searchsorted(sorted_keys, keys)       # rank of each item
        # float32 keys collide at realistic n; a stable argsort over the
        # collapsed ranks breaks ties by input order, so the result is a
        # permutation even with duplicate keys
        return np.argsort(ranks, kind="stable")
    return np.argsort(keys, kind="stable")


@dataclasses.dataclass
class SyntheticCorpus:
    """Zipf + Markov-chain token stream with learnable structure."""
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3
    order_weight: float = 0.7     # fraction of tokens drawn from the chain

    def __post_init__(self):
        v = self.vocab_size
        # sparse deterministic successor table: w -> (w * 16807 + 7) % v
        self._succ = (np.arange(v, dtype=np.int64) * 16807 + 7) % v
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        self._zipf_p = (p / p.sum()).astype(np.float64)

    def tokens(self, n: int, stream_seed: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, stream_seed))
        out = np.empty(n, dtype=np.int32)
        out[0] = rng.integers(self.vocab_size)
        zipf_draws = rng.choice(self.vocab_size, size=n, p=self._zipf_p)
        chain = rng.random(n) < self.order_weight
        for i in range(1, n):
            out[i] = self._succ[out[i - 1]] if chain[i] else zipf_draws[i]
        return out


@dataclasses.dataclass
class DataPipeline:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    corpus: Optional[SyntheticCorpus] = None

    def __post_init__(self):
        if self.corpus is None:
            self.corpus = SyntheticCorpus(self.cfg.vocab_size, seed=self.seed)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step: restart-exact resume (no loader state)."""
        b, s = self.global_batch, self.seq_len
        toks = self.corpus.tokens(b * (s + 1), stream_seed=step)
        toks = toks.reshape(b, s + 1)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        rng = np.random.default_rng((self.seed, step, 1))
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = rng.normal(
                size=(b, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(b, self.cfg.n_frames, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(cfg: ArchConfig, global_batch: int, seq_len: int,
                  seed: int = 0) -> DataPipeline:
    return DataPipeline(cfg=cfg, global_batch=global_batch, seq_len=seq_len,
                        seed=seed)
