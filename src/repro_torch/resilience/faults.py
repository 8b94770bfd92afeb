"""Seeded, deterministic fault injection (the counterpart of
``repro.resilience.faults``).

A chaos run is only useful if it is reproducible: the same
:class:`FaultPlan` against the same seed corrupts the same elements of the
same leaves at the same steps.  Every corruption site is drawn from
``numpy.random.default_rng([seed, step, event_index])``, over the floating
leaves in the reference's leaf order (``jax.tree_util`` order: dict keys
sorted, lists in order, ``None`` holes skipped) and weighted by size, so
the port and the reference pick the same ``(leaf, flat index)`` sites.  The
port's ``state["params"]`` is the model's leaf list, which is that order.

Fault taxonomy:

* ``grad_nan`` / ``grad_inf`` / ``grad_bitflip``: ``count`` elements of
  the parameters are poisoned at the step boundary, so every gradient
  built from them is non-finite (the signal ``guards.py`` watches);
  ``grad_bitflip`` XORs a high exponent bit (``itemsize * 8 - 2 - k``,
  ``k`` drawn from the same generator), a blow-up rather than a wiggle.
  ``corrupt_planes`` applies the same corruption to packed arena planes.
* ``ef_blowup``: every floating leaf of the compressor state (PowerSGD's Q
  too, as in the reference) is scaled by ``scale`` (default 1e20).
* ``ccr_skew``: ``wrap_probe`` adds ``scale`` seconds to the adaptive
  runtime's measured comm time for ``times`` probes.
* ``page_starve``: ``starve_pages`` holds pages of a serving page pool.
* ``kill``: :class:`InjectedCrash` at the step boundary; resuming is the
  caller's job (``checkpoint.restore_train_state``).

The port's train step writes its state in place, and the trainer, the
arena views, the fused hooks and the sharded gathers hold references to
the parameter tensors.  So every corruption here is written into the live
tensor (on its device, with no host synchronisation), never into a copy.
Each event fires ``times`` times in all, matched by exact step number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..obs import as_telemetry

GRAD_FAULTS = ("grad_nan", "grad_inf", "grad_bitflip")
FAULT_KINDS = GRAD_FAULTS + ("ef_blowup", "ccr_skew", "page_starve", "kill")

_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class InjectedCrash(RuntimeError):
    """Raised by a ``kill`` fault: simulates the process dying mid-run."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step`` is the train-state step the event
    matches; ``scale`` is the ``ef_blowup`` factor or the ``ccr_skew``
    delay in seconds; ``count`` is how many elements to corrupt (grad
    faults) or pages to hold (page_starve)."""

    step: int
    kind: str
    times: int = 1
    scale: float = 1e20
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible chaos schedule: events and the seed sites come from."""

    events: tuple[FaultEvent, ...] = ()
    seed: int = 0

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(sorted({e.kind for e in self.events}))


def parse_fault_spec(spec: str, *, seed: int = 0) -> FaultPlan:
    """Parse the CLI fault grammar: ``kind@step[xTIMES][*SCALE]`` items,
    comma-separated, e.g. ``grad_nan@10,grad_inf@18x4,ef_blowup@14*1e12``."""
    events = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"bad fault spec {item!r}: expected kind@step[xN][*SCALE]")
        kind, rest = item.split("@", 1)
        scale, times = 1e20, 1
        if "*" in rest:
            rest, s = rest.split("*", 1)
            scale = float(s)
        if "x" in rest:
            rest, t = rest.split("x", 1)
            times = int(t)
        events.append(FaultEvent(step=int(rest), kind=kind.strip(), times=times,
                                 scale=scale))
    return FaultPlan(events=tuple(events), seed=seed)


def as_fault_plan(obj):
    """Coerce the ``faults=`` argument: None passes through, a spec string
    parses, a plan or a live injector is used as it is."""
    if obj is None or isinstance(obj, (FaultPlan, FaultInjector)):
        return obj
    if isinstance(obj, str):
        return parse_fault_spec(obj)
    if isinstance(obj, FaultEvent):
        return FaultPlan(events=(obj,))
    if isinstance(obj, (list, tuple)) and all(isinstance(e, FaultEvent) for e in obj):
        return FaultPlan(events=tuple(obj))
    raise TypeError(
        f"faults must be None, a spec string, FaultEvent(s), a FaultPlan or a "
        f"FaultInjector; got {type(obj).__name__}")


# ---------------------------------------------------------------------------
# corruption primitives (deterministic site selection, in place)
# ---------------------------------------------------------------------------

def _rng(seed: int, step: int, idx: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0x7FFFFFFF, int(step), int(idx)])


def tree_leaves(tree: Any) -> list:
    """A tree's leaves in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _draw_sites(sizes: Sequence[int], kind: str, *, seed: int, step: int,
                count: int = 1, event_index: int = 0) -> list[tuple[int, int, int]]:
    """The reference's site draw over leaves of ``sizes`` (0 for a leaf that
    is not floating or is empty): ``(leaf index, flat index, k)`` per site,
    ``k`` the bit-flip draw (0 for the other kinds)."""
    float_ids = [i for i, n in enumerate(sizes) if n > 0]
    if not float_ids:
        return []
    rng = _rng(seed, step, event_index)
    w = np.array([sizes[i] for i in float_ids], np.float64)
    sites = []
    for _ in range(max(int(count), 1)):
        li = float_ids[int(rng.choice(len(float_ids), p=w / w.sum()))]
        fi = int(rng.integers(0, sizes[li]))
        k = int(rng.integers(0, 3)) if kind == "grad_bitflip" else 0
        sites.append((li, fi, k))
    return sites


@torch.no_grad()
def _poison(kind: str, x: torch.Tensor, flat_idx: int, k: int) -> None:
    """Write one element's corruption into ``x`` itself (a 0-dim view of
    the element, so strides do not matter and the host does not wait)."""
    el = x[np.unravel_index(flat_idx, tuple(x.shape))] if x.dim() else x
    if kind == "grad_nan":
        el.fill_(float("nan"))
    elif kind == "grad_inf":
        el.fill_(float("inf"))
    elif kind == "grad_bitflip":
        bits = x.element_size() * 8
        el.view(_INT_VIEW[x.element_size()]).bitwise_xor_(1 << (bits - 2 - k))
    else:
        raise ValueError(f"not a value-corruption kind: {kind!r}")


def corrupt_tree(tree: Any, kind: str, *, seed: int, step: int, count: int = 1,
                 event_index: int = 0) -> tuple[Any, list]:
    """Corrupt ``count`` elements of a tree's floating leaves in place, sites
    drawn from ``(seed, step, event_index)``.  Returns ``(tree, sites)``,
    the same tree object, each site ``(leaf_index, flat_index)``."""
    leaves = tree_leaves(tree)
    sizes = [x.numel() if _is_float(x) else 0 for x in leaves]
    sites = _draw_sites(sizes, kind, seed=seed, step=step, count=count,
                       event_index=event_index)
    for li, fi, k in sites:
        _poison(kind, leaves[li], fi, k)
    return tree, [(li, fi) for li, fi, _ in sites]


def corrupt_planes(planes: Sequence[torch.Tensor], kind: str, *, seed: int,
                   step: int, count: int = 1) -> tuple[list[torch.Tensor], list]:
    """The same corruption written into packed gradient arena planes
    (``core.arena.ArenaLayout.empty_planes`` after a pack): the unit-level
    form the plane guard is tested against."""
    planes = list(planes)
    _, sites = corrupt_tree(planes, kind, seed=seed, step=step, count=count)
    return planes, sites


@torch.no_grad()
def blowup_residual(comp_state: Any, scale: float) -> Any:
    """Scale every floating leaf of a compressor state by ``scale`` in place
    (in float32, as the reference's ``(r.astype(f32) * f32(scale))``).
    Returns the same state."""
    s = float(np.float32(scale))
    for r in tree_leaves(comp_state):
        if _is_float(r):
            if r.dtype == torch.float32:
                r.mul_(s)
            else:
                r.copy_(r.float() * s)
    return comp_state


# ---------------------------------------------------------------------------
# serve-side starvation
# ---------------------------------------------------------------------------

def starve_pages(pool, n: int | None = None) -> list[int]:
    """Allocate and hold ``n`` pages (default: all available) of a page
    pool with ``available``, ``alloc`` and ``free``.  Returns the held page
    ids, for :func:`release_pages`."""
    n = pool.available if n is None else min(int(n), pool.available)
    held = pool.alloc(n) if n > 0 else []
    return held or []


def release_pages(pool, held: list[int]) -> None:
    if held:
        pool.free(held)


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Applies a :class:`FaultPlan` at step boundaries.

    ``pre_step(state, batch, step)`` fires every event whose ``step``
    matches and whose firing budget remains, corrupting the live state in
    place; ``kill`` raises :class:`InjectedCrash`.  ``wrap_probe`` decorates
    an adaptive-runtime probe so that ``ccr_skew`` inflates its comm time.
    Telemetry goes through the bundle the resilience runtime hands in."""

    def __init__(self, plan: FaultPlan, telemetry=None):
        self.plan = plan
        self.telemetry = as_telemetry(telemetry)
        self.fired = [0] * len(plan.events)
        self.log: list[dict] = []

    def attach_telemetry(self, telemetry) -> None:
        self.telemetry = as_telemetry(telemetry)

    def _record(self, step: int, event: FaultEvent, detail: dict) -> None:
        self.log.append({"step": int(step), "fault": event.kind, **detail})
        tel = self.telemetry
        if tel.enabled:
            tel.events.emit("fault_injected", step=int(step), fault=event.kind,
                            detail=detail)
            tel.registry.counter("faults_injected_total", "chaos faults fired, by kind",
                                 kind=event.kind).inc()

    def pre_step(self, state: dict, batch: Any, step: int):
        """Fire every due event against this step's inputs.  Must run after
        the caller's snapshot of the clean pre-step state: skip-step
        restores the state as it was before the fault."""
        for i, ev in enumerate(self.plan.events):
            if ev.step != int(step) or self.fired[i] >= ev.times:
                continue
            if ev.kind == "ccr_skew":
                continue        # consumed by wrap_probe, not the step path
            # page_starve counts a firing and acts on no train state, as in
            # the reference (starve_pages acts on a serving pool)
            self.fired[i] += 1
            if ev.kind == "kill":
                self._record(step, ev, {"firing": self.fired[i]})
                raise InjectedCrash(f"injected kill at step {step}")
            if ev.kind in GRAD_FAULTS:
                _, sites = corrupt_tree(state["params"], ev.kind, seed=self.plan.seed,
                                        step=step, count=ev.count, event_index=i)
                self._record(step, ev, {"firing": self.fired[i],
                                        "sites": [[li, fi] for li, fi in sites]})
            elif ev.kind == "ef_blowup":
                blowup_residual(state["comp"], ev.scale)
                self._record(step, ev, {"firing": self.fired[i], "scale": ev.scale})
        return state, batch

    def wrap_probe(self, probe: Callable) -> Callable:
        """Decorate ``probe(state, batch, phase) -> PhaseSample`` so that due
        ``ccr_skew`` events add their delay to the sample's comm time (and
        to its full-step time when it has one).  Each event fires on
        ``times`` consecutive probe calls from its ``step``-th call: the
        probe cadence is the clock the controller sees."""
        calls = [0]

        def skewed(state, batch, phase):
            sample = probe(state, batch, phase)
            n = calls[0]
            calls[0] += 1
            delay = 0.0
            for i, ev in enumerate(self.plan.events):
                if ev.kind == "ccr_skew" and ev.step <= n and self.fired[i] < ev.times:
                    self.fired[i] += 1
                    delay += float(ev.scale)
                    self._record(n, ev, {"firing": self.fired[i],
                                         "delay_s": float(ev.scale)})
            if delay > 0.0:
                sample = dataclasses.replace(
                    sample, t_comm=sample.t_comm + delay,
                    t_full=sample.t_full + delay if sample.t_full > 0.0 else sample.t_full)
            return sample

        skewed.skewed_by = self
        return skewed

    def summary(self) -> dict:
        return {
            "events": len(self.plan.events),
            "fired": int(sum(self.fired)),
            "by_kind": {k: sum(f for f, e in zip(self.fired, self.plan.events)
                               if e.kind == k) for k in self.plan.kinds},
        }


__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "GRAD_FAULTS",
    "InjectedCrash",
    "as_fault_plan",
    "blowup_residual",
    "corrupt_planes",
    "corrupt_tree",
    "parse_fault_spec",
    "release_pages",
    "starve_pages",
    "tree_leaves",
]
