"""Serving engine: continuous batching with Theorem 4.2 admission control.

The port of ``repro.serve.engine``.  The decode loop is a MapReduce round
system: each decode slot is a reducer with bounded per-round I/O; requests
are items.  The §4.2 FIFO discipline is applied literally — requests queue
in arrival order, at most ``max_batch`` occupy slots (the M bound), the rest
wait in the input buffer; admission happens only at round boundaries, so no
round blocks on a straggler.

Continuous batching at *token* granularity: every round, each live slot
consumes exactly one token — the next prompt token while the request is
still prefilling (its logits are ignored), or its last sampled token while
generating.  Slots evolve independently because the decode state is
per-slot (per-slot pos, per-slot cache lines), so prefill and decode mix
freely in one ``decode_step`` call per round.

The decoder-only LMs of the port, as the JAX engine serves them: the
dense, MoE and (its text) VLM families of
:class:`~repro_torch.models.DecoderLM`, :class:`~repro_torch.models.HybridLM`
and :class:`~repro_torch.models.RWKVLM`.  The engine reads only
``init_decode_state``, ``decode_step``, ``device`` and the state's per-slot
fields.  An MoE decode step groups the B slots for its capacity, an idle
slot's pad token included, so a request's output depends on the other
slots, as in the JAX engine.  Enc-dec serving is
:meth:`~repro_torch.models.EncDecLM.prefill` (frames and prompt) then
``decode_step``: this engine has no per-slot frames feed.  The decode state lives on the model's device
and is updated in place; each round moves the B sampled token ids to the
host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.costmodel import MRCost
from ..obs import NULL_TRACER


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int = 16
    output: Optional[List[int]] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    _prompt_pos: int = 0            # next prompt token to feed


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8              # M: concurrently admitted requests
    max_len: int = 256              # slot KV capacity
    eos_token: int = -1             # <0: disabled (synthetic corpora)
    pad_token: int = 0


class ServeEngine:
    """Token-level continuous batching (see module docstring) over
    ``model``, one of the port's LMs, which holds its params.

    ``clock`` is the injectable time source: any zero-arg callable returning
    float seconds (``time.time`` in production, a counter under test), so
    latency stats are deterministic when the test controls the clock."""

    def __init__(self, model, scfg: ServeConfig,
                 clock: Callable[[], float] = time.time, tracer=None):
        self.model = model
        self.scfg = scfg
        self.clock = clock
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.queue: Deque[Request] = deque()    # Thm 4.2 FIFO input buffer
        self.active: List[Optional[Request]] = [None] * scfg.max_batch
        self.state = model.init_decode_state(scfg.max_batch, scfg.max_len)
        self.cur_tok = np.full(scfg.max_batch, scfg.pad_token, np.int32)
        self.rounds = 0
        self.finished: List[Request] = []
        self.cost = MRCost()
        self._decode = model.decode_step

    def submit(self, req: Request) -> None:
        req.submitted_at = self.clock()
        req.output = []
        req._prompt_pos = 0
        self.queue.append(req)                  # FIFO order preserved

    def _admit(self) -> None:
        for slot in range(self.scfg.max_batch):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                self.active[slot] = req
                self.state = _zero_slot(self.state, slot)
                self.cur_tok[slot] = int(req.prompt[0])
                req._prompt_pos = 1

    def step(self) -> int:
        """One decode round; returns number of generated tokens emitted."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        tok = torch.from_numpy(self.cur_tok).to(self.model.device)
        logits, self.state = self._decode(tok, self.state)
        # greedy: first index of the maximum, as np.argmax takes it
        nxt_all = torch.argmax(logits, dim=-1).tolist()
        pos = self.state.pos.tolist()
        emitted = 0
        now = self.clock()
        for slot in live:
            req = self.active[slot]
            if req._prompt_pos < len(req.prompt):
                # still prefilling: feed the next prompt token, drop logits
                self.cur_tok[slot] = int(req.prompt[req._prompt_pos])
                req._prompt_pos += 1
                continue
            nxt = nxt_all[slot]
            if req.first_token_at is None:
                req.first_token_at = now
            req.output.append(nxt)
            self.cur_tok[slot] = nxt
            emitted += 1
            if (nxt == self.scfg.eos_token
                    or len(req.output) >= req.max_new_tokens
                    or pos[slot] >= self.scfg.max_len - 1):
                req.finished_at = now
                self.finished.append(req)
                self.active[slot] = None
        self.rounds += 1
        self.cost.round(items_sent=len(live), max_io=len(live))
        tr = self.tracer
        if tr.enabled:
            tr.event("serve.token_round", round=self.rounds,
                     live=len(live), emitted=emitted,
                     queued=len(self.queue))
            tr.count("serve.token_rounds")
            tr.count("serve.tokens", emitted)
        return emitted

    def run_until_drained(self, max_rounds: int = 100_000) -> List[Request]:
        while (self.queue or any(r is not None for r in self.active)):
            self.step()
            if self.rounds >= max_rounds:
                raise RuntimeError("serve loop exceeded max_rounds")
        return self.finished

    def stats(self) -> Dict[str, Any]:
        lat = [r.finished_at - r.submitted_at for r in self.finished
               if r.finished_at]
        ttft = [r.first_token_at - r.submitted_at for r in self.finished
                if r.first_token_at]
        toks = sum(len(r.output) for r in self.finished)
        return {"requests": len(self.finished), "rounds": self.rounds,
                "tokens": toks,
                "mean_latency_s": float(np.mean(lat)) if lat else None,
                "mean_ttft_s": float(np.mean(ttft)) if ttft else None}


def _zero_slot(state, slot: int):
    """Zero one batch slot of a decode state (per-slot pos included), in
    place: axis 1 of every leaf with ndim >= 2, and the 1-D ``pos``."""
    for name, leaf in zip(state._fields, state):
        if leaf.ndim == 1 and "pos" in name:
            leaf[slot] = 0
        elif leaf.ndim >= 2:
            leaf[:, slot] = 0
    return state
