"""Continuous-batching serving engine over the paged KV arena — the
counterpart of ``repro.serve.engine``, with the same three stages, the
same admission, finish and shedding rules, stats and telemetry:

* **prefill** — :class:`~repro_torch.serve.prefill.ChunkedPrefill` runs the
  whole prompt at batch 1 through the model's ``decode_step``, counted in
  chunks of ``prefill_chunk`` tokens.  An encoder-decoder model first
  encodes the request's frames (zeros when it has none) and projects them
  into the batch-1 caches' ``mem_k``/``mem_v``, once a request; the arena
  keeps them as resident leaves.
* **insert** — the prefilled dense cache is copied into freshly allocated
  arena pages (whole page rows rebuilt from zeros, so slot reuse cannot
  leak state).
* **generate** — every active slot advances one token per call: gather the
  dense batched caches through the page tables, run ``decode_step``,
  scatter the written rows back.

The engine runs on the model's device.  Every serving call runs under
``torch.inference_mode()``, and the arena's planes are written in place
(the reference donates them).  A generate step sends its page tables,
tokens and positions to the device in one transfer (from pinned memory on
the GPU) and reads one thing back: the sampled tokens.

Requests finish with an explicit ``finish_reason`` (eos / length /
truncated / rejected).  ``Engine.results`` maps request id to a
:class:`~repro_torch.serve.scheduler.Completion` carrying tokens, the
reason, and a wall-clock ledger for latency metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..obs import as_telemetry
from .kv_arena import (
    KVArena,
    build_insert_fn,
    gather_caches,
    plan_kv_layout,
    scatter_step,
)
from .prefill import ChunkedPrefill
from .scheduler import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_TRUNCATED,
    Completion,
    Request,
    Scheduler,
    Slot,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256
    max_new_tokens: int = 32
    eos_token: int = -1          # -1 = never stop on eos
    temperature: float = 0.0     # 0 = greedy
    page_size: int = 16          # tokens per KV page
    num_pages: int = 0           # 0 = auto (every slot can run full-length)
    prefill_chunk: int = 16      # prompt tokens per prefill call
    # load shedding: a submit while max_queue requests wait finishes at
    # once as "rejected" (no tokens, safe to retry); None = unbounded
    max_queue: int | None = None
    # starvation shedding: after starve_patience ticks in which the queue
    # head could not be admitted and no slot was active (nothing will ever
    # free a page, e.g. the pool is held by a page_starve fault), shed the
    # head as "rejected" once a tick; 0 disables
    starve_patience: int = 0


def greedy_sample(logits: torch.Tensor, generator: torch.Generator | None = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, 1, V) -> (B,) int32: the argmax (the first index on
    ties), or with ``temperature > 0`` a draw from
    ``softmax(logits / temperature)`` with ``generator``."""
    if temperature and temperature > 0:
        probs = torch.softmax(logits[:, 0, :].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)


def build_generate_fn(model, layout):
    """The batched generate step: page tables -> dense caches ->
    ``decode_step`` -> the written rows scattered back into the planes, in
    place.  Tables, tokens and positions are data, so one function serves
    every mix of active slots and positions."""

    @torch.inference_mode()
    def gen(params, planes, page_tbl, resident_tbl, tokens, pos):
        caches = gather_caches(layout, planes, page_tbl, resident_tbl)
        logits, caches = model.decode_step(params, caches, {"tokens": tokens, "pos": pos})
        planes = scatter_step(layout, planes, page_tbl, resident_tbl, caches, pos)
        return logits, planes

    return gen


def _zero_stats() -> dict[str, float]:
    return {
        "requests": 0, "completed": 0, "starved_shed": 0,
        "prefill_calls": 0, "prefill_tokens": 0, "prefill_s": 0.0,
        "insert_calls": 0, "insert_s": 0.0,
        "generate_calls": 0, "generate_tokens": 0, "generate_s": 0.0,
    }


class Engine:
    """``Engine(model, params, sc)``: ``model`` is a ``DecoderLM`` or an
    ``EncDecLM`` on the device to serve on; ``params`` is ``None`` (the
    model's own parameters) or the nested tree its ``decode_step`` takes.
    ``submit(prompt, frames)`` takes an encoder-decoder request's frames
    (1, T, d) as an array or a tensor."""

    def __init__(self, model, params, sc: ServeConfig, *, sample=greedy_sample,
                 telemetry=None):
        self.model = model
        self.params = params
        self.sc = sc
        self.sample = sample
        self.device = next(model.parameters()).device
        # telemetry (obs): per-request lifecycle spans, stage histograms and
        # queue/page-pool occupancy series; the default disabled bundle
        # makes every hook an attribute check
        self.telemetry = as_telemetry(telemetry)
        self.layout = plan_kv_layout(model.cache_specs, sc.max_len, sc.page_size)
        self._num_pages = sc.num_pages or KVArena.auto_pages(self.layout, sc.batch_slots)
        self.prefill = ChunkedPrefill(model, sc.prefill_chunk)
        self._generate = build_generate_fn(model, self.layout)
        self._insert = build_insert_fn(self.layout)
        self._encode = model.memory_kv if getattr(model.cfg, "is_encdec", False) else None
        # one staging row per slot: its page table, resident page, token
        # and position; pinned on the GPU, so the step's one transfer does
        # not block the host
        P = self.layout.pages_per_slot
        self._staging = torch.zeros((sc.batch_slots, P + 3), dtype=torch.long,
                                    pin_memory=self.device.type == "cuda")
        self._next_id = 0
        self.reset()

    def reset(self) -> None:
        """Fresh arena/queue/results/stats; the layout and the stage
        functions are kept, so QPS sweeps can reuse one engine.  The old
        arena's planes are dropped before the new ones are made, so the
        two are never held at once."""
        self.arena = None
        self.arena = KVArena(self.layout, self._num_pages, self.sc.batch_slots,
                             device=self.device)
        self.sched = Scheduler(self.sc.batch_slots)
        self.results: dict[int, Completion] = {}
        self.stats = _zero_stats()
        self._starved_ticks = 0
        self._gen = torch.Generator(self.device).manual_seed(0)
        # wall-clock origin of this serving episode: request spans in the
        # Chrome trace are rebased to it so traces start near t=0
        self._trace_t0 = time.perf_counter()

    # ---- request API -------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], frames: Any = None) -> int:
        rid = self._next_id
        self._next_id += 1
        req = Request(rid=rid, prompt=list(prompt_tokens), frames=frames,
                      submit_s=time.perf_counter())
        if self.sc.max_queue is not None and self.sched.pending >= self.sc.max_queue:
            # shed at the door: the request never queues, consumes no
            # tokens, and surfaces as finish_reason="rejected"
            self.stats["requests"] += 1
            self._record_completion(self.sched.reject(req, time.perf_counter()))
            return rid
        self.sched.submit(req)
        return rid

    @property
    def busy(self) -> bool:
        return self.sched.busy

    def metrics(self) -> dict[str, float]:
        """Per-stage unit costs (µs)."""
        st = self.stats
        return {
            "prefill_tok_us": 1e6 * st["prefill_s"] / max(1, st["prefill_tokens"]),
            "generate_tok_us": 1e6 * st["generate_s"] / max(1, st["generate_tokens"]),
            "insert_us": 1e6 * st["insert_s"] / max(1, st["insert_calls"]),
        }

    # ---- internals -----------------------------------------------------
    def _sample_host(self, logits) -> np.ndarray:
        return self.sample(logits, self._gen, self.sc.temperature).cpu().numpy()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish(self, slot: Slot, reason: str) -> None:
        comp = self.sched.finish(slot, reason, time.perf_counter())
        self.arena.release_slot(slot.index)
        self._record_completion(comp)

    def _record_completion(self, comp: Completion) -> None:
        """Terminal bookkeeping shared by slot finishes and slotless
        rejections: results map, stats, and the telemetry ledger."""
        self.results[comp.rid] = comp
        self.stats["completed"] += 1
        tel = self.telemetry
        if tel.enabled:
            tel.tracer.record_request(comp, t0=self._trace_t0)
            tel.registry.counter(
                "serve_requests_total", "completed requests by finish reason",
                reason=comp.finish_reason,
            ).inc()
            tel.registry.histogram(
                "serve_request_latency_ms", "submit -> finish, per request"
            ).observe(comp.latency_s * 1e3)
            tel.registry.histogram(
                "serve_request_ttft_ms", "submit -> first token, per request"
            ).observe(comp.ttft_s * 1e3)
            tel.events.emit(
                "serve_request",
                rid=int(comp.rid),
                prompt_len=int(comp.prompt_len),
                new_tokens=len(comp.tokens),
                finish_reason=comp.finish_reason,
                ttft_ms=comp.ttft_s * 1e3,
                latency_ms=comp.latency_s * 1e3,
                queued_ms=max(comp.admit_s - comp.submit_s, 0.0) * 1e3,
            )

    def _admit(self) -> None:
        while True:
            na = self.sched.next_admission()
            if na is None:
                return
            slot, req = na
            L = len(req.prompt)
            if L > self.sc.max_len - 1:
                # no room to even feed the first generated token back in
                self.sched.admit(slot, time.perf_counter())
                self.stats["requests"] += 1
                self._finish(slot, FINISH_TRUNCATED)
                continue
            needed = self.layout.pages_per_request(L)
            if needed > self.arena.pool.available:
                if needed > self.arena.num_pages:
                    # could never fit even in an idle arena: finish it now
                    # rather than deadlock the queue
                    self.sched.admit(slot, time.perf_counter())
                    self.stats["requests"] += 1
                    self._finish(slot, FINISH_TRUNCATED)
                    continue
                return  # wait for running requests to free pages
            self.sched.admit(slot, time.perf_counter())
            self.stats["requests"] += 1
            self._run_prefill(slot, req)

    def _run_prefill(self, slot: Slot, req: Request) -> None:
        if not self.arena.acquire_slot(slot.index, len(req.prompt)):
            raise AssertionError("admission checked pages but alloc failed")
        t0 = time.perf_counter()
        caches = self.model.init_caches(1, self.layout.tokens)
        if self._encode is not None:
            caches["mem_k"], caches["mem_v"] = self._encode(self.params,
                                                            self._frames(req.frames))
        logits, caches, calls = self.prefill(self.params, caches, req.prompt)
        first = int(self._sample_host(logits)[0])
        t1 = time.perf_counter()
        slot.prefill_end_s = t1
        self.stats["prefill_calls"] += calls
        self.stats["prefill_tokens"] += len(req.prompt)
        self.stats["prefill_s"] += t1 - t0

        page_ids, res_id = self.arena.insert_ids(slot.index)
        self._insert(self.arena.planes, caches, page_ids, res_id)
        self._sync()
        t2 = time.perf_counter()
        self.stats["insert_calls"] += 1
        self.stats["insert_s"] += t2 - t1

        tel = self.telemetry
        if tel.enabled:
            tel.registry.histogram(
                "serve_stage_ms", "per-call stage wall", stage="prefill"
            ).observe((t1 - t0) * 1e3)
            tel.registry.histogram(
                "serve_stage_ms", "per-call stage wall", stage="insert"
            ).observe((t2 - t1) * 1e3)

        slot.tokens.append(first)
        slot.first_token_s = t2
        self._maybe_finish(slot, first)

    def _frames(self, frames) -> torch.Tensor:
        """A request's frames on the device, (1, T, d); zeros (f32) when it
        has none, as the reference feeds them."""
        cfg = self.model.cfg
        if frames is None:
            return torch.zeros((1, cfg.frontend_tokens, cfg.d_model),
                               dtype=torch.float32, device=self.device)
        return torch.as_tensor(frames, device=self.device)

    def _maybe_finish(self, slot: Slot, tok: int) -> None:
        """Terminal checks after a token lands.  ``slot.pos`` is the
        position the NEXT decode input would occupy; it must stay within
        the context for generation to continue."""
        if tok == self.sc.eos_token:
            self._finish(slot, FINISH_EOS)
        elif len(slot.tokens) >= self.sc.max_new_tokens:
            self._finish(slot, FINISH_LENGTH)
        elif slot.pos > self.sc.max_len - 1:
            self._finish(slot, FINISH_TRUNCATED)

    def _step_inputs(self, active: list[Slot]):
        """Page tables, tokens and positions on the device, in one
        transfer: ``(page_tbl, resident_tbl, tokens (S, 1), pos (S,))``.
        Inactive slots feed token 0 at position 0 through null tables."""
        P = self.layout.pages_per_slot
        host = self._staging.numpy()
        host[:, :P] = self.arena.page_tbl
        host[:, P] = self.arena.resident_tbl
        host[:, P + 1:] = 0
        for slot in active:
            host[slot.index, P + 1] = slot.tokens[-1]
            host[slot.index, P + 2] = slot.pos
        dev = self._staging.to(self.device, non_blocking=True)
        return dev[:, :P], dev[:, P], dev[:, P + 1:P + 2], dev[:, P + 2]

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit (prefill+insert) what fits, then
        advance every active slot one generated token.  Returns the number
        of slots that decoded."""
        self._admit()
        for slot in self.sched.active_slots:
            if not self.arena.page_for(slot.index, slot.pos):
                self._finish(slot, FINISH_TRUNCATED)  # pool ran dry
        active = self.sched.active_slots
        if self.sc.starve_patience > 0:
            if self.sched.pending and not active:
                # queue non-empty, nothing admitted, nothing running: no
                # slot will ever free the pages admission waits on
                self._starved_ticks += 1
                if self._starved_ticks > self.sc.starve_patience:
                    req = self.sched.queue.popleft()
                    self.stats["requests"] += 1
                    self.stats["starved_shed"] += 1
                    self._record_completion(self.sched.reject(req, time.perf_counter()))
            else:
                self._starved_ticks = 0
        tel = self.telemetry
        if tel.enabled:
            # occupancy series: one counter-track sample per engine tick
            # plus last-value gauges for the registry snapshot
            now = time.perf_counter() - self._trace_t0
            depth = self.sched.pending
            free = self.arena.pool.available
            tel.tracer.record_counter(
                "serve occupancy", now,
                {"queue_depth": depth, "active_slots": len(active), "free_pages": free},
            )
            tel.registry.gauge(
                "serve_queue_depth", "requests waiting for admission").set(depth)
            tel.registry.gauge(
                "serve_active_slots", "slots decoding this tick").set(len(active))
            tel.registry.gauge(
                "serve_free_pages", "KV arena pages unallocated").set(free)
            tel.registry.histogram(
                "serve_page_occupancy", "fraction of KV pages in use, per tick"
            ).observe(1.0 - free / max(self.arena.num_pages, 1))
        if not active:
            return 0

        t0 = time.perf_counter()
        page_tbl, resident_tbl, tokens, pos = self._step_inputs(active)
        logits, _ = self._generate(self.params, self.arena.planes, page_tbl,
                                   resident_tbl, tokens, pos)
        nxt = self._sample_host(logits)
        t1 = time.perf_counter()
        self.stats["generate_calls"] += 1
        self.stats["generate_tokens"] += len(active)
        self.stats["generate_s"] += t1 - t0
        if tel.enabled:
            tel.registry.histogram(
                "serve_stage_ms", "per-call stage wall", stage="generate"
            ).observe((t1 - t0) * 1e3)

        for slot in active:
            tok = int(nxt[slot.index])
            slot.tokens.append(tok)
            slot.pos += 1
            self._maybe_finish(slot, tok)
        return len(active)

    def run_until_done(self, max_steps: int = 100_000) -> dict[int, Completion]:
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.results
