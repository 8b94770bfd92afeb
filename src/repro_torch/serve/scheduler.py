"""Continuous-batching scheduler: request queue, slot states, admission —
the counterpart of ``repro.serve.scheduler`` (pure Python, the same
rules).

Admission is FIFO and two-resource: the queue head is admitted when a
decode *slot* is free AND the page pool can cover the request
(``ceil(prompt_len / page_size)`` token pages plus the resident page for
models with recurrent state).  Head-of-line order is preserved on purpose
— requests never overtake each other, which keeps serving runs
deterministic and makes batched-vs-sequential parity testable.

Every request finishes with an explicit ``finish_reason``:

* ``"eos"`` — the model emitted the eos token;
* ``"length"`` — ``max_new_tokens`` generated;
* ``"truncated"`` — the context filled up (``max_len`` reached, the page
  pool ran dry mid-generation, or the prompt alone exceeds the context);
  previously this case was silently reported as a normal completion;
* ``"rejected"`` — load shedding (DESIGN.md §16): the engine refused the
  request *without running it* — the admission queue is over
  ``max_queue``, or the queue head starved with every slot/page
  exhausted.  Distinct from ``"truncated"`` on purpose: a rejected
  request produced no tokens and is safe to retry verbatim
  (``traffic.py`` does, with backoff), whereas a truncated one consumed
  budget.  Under an overload storm this is what keeps p99 of *admitted*
  requests bounded instead of silently degrading everyone.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_TRUNCATED = "truncated"
FINISH_REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    frames: Any = None          # enc-dec conditioning (1, F, d_model) or None
    submit_s: float = 0.0       # wall clock at submit()


@dataclasses.dataclass
class Completion:
    """Terminal record for one request — tokens plus the latency ledger the
    traffic harness aggregates into p50/p99."""

    rid: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str
    submit_s: float = 0.0
    admit_s: float = 0.0        # prefill started
    prefill_end_s: float = 0.0  # prompt forward done, KV insert starts
    first_token_s: float = 0.0  # first generated token available
    finish_s: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.submit_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.submit_s


@dataclasses.dataclass
class Slot:
    index: int
    request: Request | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0                # position the NEXT decode input occupies
    admit_s: float = 0.0
    prefill_end_s: float = 0.0
    first_token_s: float = 0.0

    @property
    def active(self) -> bool:
        return self.request is not None

    def clear(self) -> None:
        self.request = None
        self.tokens = []
        self.pos = 0


class Scheduler:
    """Owns the queue and the slot array; the engine owns the arena and
    asks ``next_admission`` whether the queue head fits."""

    def __init__(self, num_slots: int):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.queue: deque[Request] = deque()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.active]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    def free_slot(self) -> Slot | None:
        for s in self.slots:
            if not s.active:
                return s
        return None

    def next_admission(self) -> tuple[Slot, Request] | None:
        """Queue head + a free slot, if both exist.  Does NOT pop — the
        engine pops via ``admit`` only once the page pool also agrees."""
        if not self.queue:
            return None
        slot = self.free_slot()
        if slot is None:
            return None
        return slot, self.queue[0]

    def admit(self, slot: Slot, now: float) -> Request:
        req = self.queue.popleft()
        slot.request = req
        slot.tokens = []
        slot.pos = len(req.prompt)
        slot.admit_s = now
        slot.prefill_end_s = 0.0
        slot.first_token_s = 0.0
        return req

    def reject(self, req: Request, now: float) -> Completion:
        """Shed one request without a slot: a terminal Completion with no
        tokens, ``finish_reason="rejected"``, and the latency ledger
        collapsed to the decision instant (admit == finish == now, so a
        rejection's 'latency' is pure queueing time, never compute)."""
        return Completion(
            rid=req.rid,
            prompt_len=len(req.prompt),
            tokens=[],
            finish_reason=FINISH_REJECTED,
            submit_s=req.submit_s,
            admit_s=now,
            prefill_end_s=now,
            first_token_s=now,
            finish_s=now,
        )

    def finish(self, slot: Slot, reason: str, now: float) -> Completion:
        req = slot.request
        comp = Completion(
            rid=req.rid,
            prompt_len=len(req.prompt),
            tokens=list(slot.tokens),
            finish_reason=reason,
            submit_s=req.submit_s,
            admit_s=slot.admit_s,
            prefill_end_s=slot.prefill_end_s or now,
            first_token_s=slot.first_token_s or now,
            finish_s=now,
        )
        slot.clear()
        return comp


__all__ = [
    "Completion",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISH_REJECTED",
    "FINISH_TRUNCATED",
    "Request",
    "Scheduler",
    "Slot",
]
