"""Escalating auto-recovery around the trainer's host loop (the counterpart
of ``repro.resilience.recovery``).

The :class:`ResilienceRuntime` brackets each step:

* ``pre_step``: write the guard-owned checkpoint on its cadence, copy the
  clean incoming state into a rollback point when a new batch window
  opens, then let the fault injector corrupt the step's inputs.  The copy
  comes before the injection: skip-step must restore the state as it was
  before the fault.  The port's step writes its state in place (the
  parameters are the model's, and the arena views, the fused hooks and
  the sharded gathers hold them), so a rollback point is a copy, not a
  reference as in the reference.  At most two are kept (the current and
  the previous window's), in buffers allocated once and refilled with
  ``copy_``: fresh buffers per window would cost an allocation of the
  whole state each time.  A rollback point also records the trainer's
  pending sharded gather: a state copied while it is pending holds stale
  non-owner shards, which the next step's head all-gather re-gathers once
  the flag is restored with it.  A re-plan inside the window (the adaptive
  runtime) keeps the params' and the optimizer state's layout, so they are
  restored all the same; the copied residual is dropped instead (policy
  ``"flush"``), and a pending gather is settled under the plan it was
  pending in.
* ``post_step``: the checks are deferred and batched.  Step ``N``'s device
  scalars (and, on its cadence, the residual norm, launched then) are
  queued at its own ``post_step`` and read in step order once the queue
  holds ``sync_every`` entries: one stacked tensor, one host transfer a
  batch, no per-step host synchronisation.  ``finalize`` drains the queue
  when the loop ends.  A trip climbs the ladder:

  1. **skip-step**: restore the batch window's start (params, AdamW's m
     and v, the residuals), copied into the live tensors.  With
     ``sync_every=1`` that is exactly the tripped step's pre-state.
  2. **EF flush**: restore it AND zero the residual through
     ``runtime.transitions`` (policy ``"flush"``, after
     ``Trainer.flush_sync``).  Residual-watchdog trips enter here: a skip
     would restore the blown-up residual with everything else.
  3. **checkpoint rewind**: restore the last guard-owned checkpoint
     (``checkpoint.restore_train_state``, digest-verified, into the live
     tensors) and replay from there.

  Skip and flush budgets are per incident (reset on the first clean
  check); the rewind budget is per run.  An exhausted ladder raises
  :class:`RecoveryError` with the trip history.

**One verdict for every rank.**  Each rank of a process group runs its
own runtime, and a rung taken on one rank only would leave the ranks'
states apart (or deadlock the next collective).  ``total_loss`` and
``grad_norm`` are group means already, the same bits on every rank; the
residual is each rank's own, so the batched read takes its maximum over
the group (NaN read as +Inf) in one small all-reduce per batch.  Every
rank draws the same fault sites from the same seed.

Mid-run process death is not handled here: that is the operator's restart
(``launch/train.py --resume``, the chaos gate's ``kill``).
"""
from __future__ import annotations

import math
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .. import checkpoint
from ..core.comm import world_size
from ..obs import as_telemetry
from .faults import FaultInjector, FaultPlan, InjectedCrash, as_fault_plan
from .guards import GuardConfig, Guards, GuardTrip, as_guard_config

ACTIONS = ("skip_step", "ef_flush", "rewind")
_METRIC_KEYS = ("total_loss", "loss", "grad_norm")


def _group_max(values: torch.Tensor, group) -> None:
    """The residual norms' maximum over the group, in place (a NaN counts
    as +Inf, since a maximum over NaN is not defined)."""
    torch.nan_to_num(values, nan=math.inf, out=values)
    dist.all_reduce(values, op=dist.ReduceOp.MAX, group=group)


class RecoveryError(RuntimeError):
    """The escalation ladder is exhausted (or has no rung left: no
    checkpoint directory configured, or no checkpoint written yet)."""

    def __init__(self, msg: str, trips: list[GuardTrip] | None = None):
        super().__init__(msg)
        self.trips = list(trips or [])


_PARTS = ("params", "opt", "comp")
_TENSOR = object()    # a tensor's place among a state part's host values


def _flat(tree: Any) -> tuple[list, Any, tuple]:
    """A state part's leaves, its tree spec, and a key of its layout: the
    spec with each tensor leaf's shape, dtype and device."""
    leaves, spec = pytree.tree_flatten(tree)
    key = (spec, tuple((tuple(x.shape), x.dtype, x.device)
                       if isinstance(x, torch.Tensor) else None for x in leaves))
    return leaves, spec, key


class _Snapshot:
    """One rollback point: a copy of a train state's tensors, per part
    (params, optimizer state, compressor state), in buffers allocated once
    per layout and refilled with ``copy_``; the state's host values (the
    steps); and what the trainer was when the copy was taken (its plan,
    compressor and interval, and the pending-gather flag)."""

    def __init__(self):
        self.step: int | None = None
        self.keys: dict[str, tuple] = {}
        self.bufs: dict[str, list[torch.Tensor]] = {}
        self.hosts: dict[str, list] = {}
        self.plan = self.compressor = None
        self.interval = 0
        self.pending_sync = False

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for bs in self.bufs.values() for b in bs)

    @torch.no_grad()
    def fill(self, state: dict, trainer) -> None:
        for part in _PARTS:
            leaves, _, key = _flat(state[part])
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            if key != self.keys.get(part):
                self.bufs[part] = []       # free the old layout's buffers first
                self.bufs[part] = [torch.empty_like(t) for t in tensors]
                self.keys[part] = key
            if tensors:
                torch._foreach_copy_(self.bufs[part], tensors)
            self.hosts[part] = [_TENSOR if isinstance(x, torch.Tensor) else x
                                for x in leaves]
        self.step = int(state["step"])
        self.plan, self.compressor = trainer.plan, trainer.compressor
        self.interval = trainer.tc.interval
        self.pending_sync = trainer._pending_sync

    def _tree(self, part: str, tensors) -> Any:
        tensors = iter(tensors)
        leaves = [next(tensors) if h is _TENSOR else h for h in self.hosts[part]]
        return pytree.tree_unflatten(leaves, self.keys[part][0])

    def copy_of(self, part: str) -> Any:
        """The copied part, over the snapshot's own buffers."""
        return self._tree(part, self.bufs[part])

    @torch.no_grad()
    def restore_into(self, live: dict, part: str) -> Any:
        """The copied part written into ``live``'s tensors (with the copy's
        host values).  Raises :class:`RecoveryError` when the live part has
        another layout."""
        leaves, _, key = _flat(live[part])
        if key != self.keys[part]:
            raise RecoveryError(f"the train state's {part} changed layout since the "
                                f"rollback point of step {self.step}")
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if tensors:
            torch._foreach_copy_(tensors, self.bufs[part])
        return self._tree(part, tensors)


class ResilienceRuntime:
    """One per chain of ``Trainer.run`` calls (like ``AdaptiveRuntime``, it
    survives chunked runs).  Built by the trainer from ``run(guards=...,
    faults=...)``; either side may be None: guards without faults is the
    production form, faults without guards the negative control that shows
    the faults are real (no rollback points are copied then)."""

    def __init__(self, trainer, guards: GuardConfig | None = None,
                 faults: FaultPlan | FaultInjector | None = None, telemetry=None):
        self.trainer = trainer
        self.config = as_guard_config(guards)
        self.guards = Guards(self.config) if self.config is not None else None
        faults = as_fault_plan(faults)
        if isinstance(faults, FaultInjector):
            self.injector = faults
        elif faults is not None:
            self.injector = FaultInjector(faults)
        else:
            self.injector = None
        self.telemetry = as_telemetry(telemetry)
        if self.injector is not None:
            self.injector.attach_telemetry(self.telemetry)
        # the two rollback points; _win and _prev_win point into them
        self._slots = (_Snapshot(), _Snapshot())
        self._win: _Snapshot | None = None
        self._prev_win: _Snapshot | None = None
        # deferred checks: (ran, device metrics, residual norm | None)
        self._pending: list[tuple[int, dict, Any]] = []
        self._last_saved_step: int | None = None
        self._skips_used = 0       # per incident
        self._flushes_used = 0     # per incident
        self._rewinds_used = 0     # per run, never reset
        self.actions: list[dict] = []
        # host seconds of the guard-owned saves and of the rewinds' restores
        self.timings: dict[str, list[float]] = {"save": [], "restore": []}

    def attach_telemetry(self, telemetry) -> None:
        self.telemetry = as_telemetry(telemetry)
        if self.injector is not None:
            self.injector.attach_telemetry(self.telemetry)

    @property
    def _cfg(self) -> GuardConfig:
        return self.config if self.config is not None else GuardConfig()

    @property
    def snapshot_bytes(self) -> int:
        """Device bytes held by the two rollback points."""
        return sum(s.nbytes for s in self._slots)

    # ------------------------------------------------------------------
    # step bracket
    # ------------------------------------------------------------------
    def pre_step(self, state: dict, batch: Any):
        """Guard-owned checkpoint, then the rollback copy, then the faults.
        Returns the ``(state, batch)`` the step should consume."""
        cfg = self._cfg
        step = int(state["step"])
        if (cfg.ckpt_dir and cfg.ckpt_every > 0 and step % cfg.ckpt_every == 0
                and step != self._last_saved_step):
            state = self._save_checkpoint(state)
        # a new batch window opens when the queue is empty (run start, just
        # recovered) or full (this post_step reads it): copy this step's
        # pre-state into the older rollback point
        if self.guards is not None and (not self._pending
                                        or len(self._pending) >= cfg.sync_every):
            slot = self._slots[1] if self._win is self._slots[0] else self._slots[0]
            slot.fill(state, self.trainer)
            self._prev_win, self._win = self._win, slot
        if self.injector is not None:
            try:
                state, batch = self.injector.pre_step(state, batch, step)
            except InjectedCrash:
                # the queued checks belong to a trajectory the restart will
                # not continue
                self._pending = []
                raise
        return state, batch

    def post_step(self, state: dict, metrics: dict) -> dict:
        """Queue the step's checks; read the queue first when it is full
        (its oldest entries are long computed).  Returns the state the
        loop continues from: a recovered one after a trip."""
        if self.guards is None:
            return state
        if len(self._pending) >= self._cfg.sync_every:
            healed = self._flush_pending(state)
            if healed is not state:
                return healed
        ran = int(state["step"]) - 1       # the step that just ran
        if ran % self._cfg.check_every == 0:
            self._pending.append((ran, metrics,
                                  self.guards.residual_async(ran, state.get("comp"))))
        return state

    def finalize(self, state: dict) -> dict:
        """Drain the deferred checks at the end of a run.  May recover: the
        returned state can sit a few steps behind the loop's target."""
        if self.guards is None:
            self._pending = []
            return state
        return self._flush_pending(state)

    @torch.no_grad()
    def _read(self, pending) -> list[tuple[dict, float | None]]:
        """The queued scalars on the host: one stack, the residual norms'
        maximum over the group, one transfer."""
        scalars, keys = [], []
        for _, metrics, _ in pending:
            ks = [k for k in _METRIC_KEYS if k in metrics]
            keys.append(ks)
            scalars.extend(metrics[k].detach().float().reshape(()) for k in ks)
        norms = [r for _, _, r in pending if r is not None]
        flat = torch.stack(scalars + norms)
        group = self.trainer.world_group
        if norms and group is not None and world_size(group) > 1:
            _group_max(flat[len(scalars):], group)
        host = iter(flat.tolist())
        metrics = [{k: next(host) for k in ks} for ks in keys]
        return [(m, None if r is None else next(host))
                for m, (_, _, r) in zip(metrics, pending)]

    def _flush_pending(self, state: dict) -> dict:
        """Check the queued steps oldest first.  On a trip the younger
        entries are dropped unchecked: recovery rewinds past them."""
        pending, self._pending = self._pending, []
        if not pending:
            return state
        for (ran, _, _), (host, rnorm) in zip(pending, self._read(pending)):
            trips = self.guards.check(ran, host, residual_value=rnorm)
            if not trips:
                # the first clean check closes the incident
                self._skips_used = 0
                self._flushes_used = 0
                continue
            for t in trips:
                self._emit_trip(t)
            return self._recover(ran, trips, state)
        return state

    # ------------------------------------------------------------------
    # the ladder
    # ------------------------------------------------------------------
    def _recover(self, step: int, trips: list[GuardTrip], state: dict) -> dict:
        cfg = self._cfg
        residual_trip = any(t.guard == "residual" for t in trips)
        if cfg.retry_backoff_s > 0.0:
            time.sleep(cfg.retry_backoff_s)
        if not residual_trip and self._skips_used < cfg.max_skips:
            self._skips_used += 1
            return self._act("skip_step", step, self._roll_back(step, state, flush=False),
                             attempt=self._skips_used, detail=trips[0].reason)
        if self._flushes_used < cfg.max_flushes:
            self._flushes_used += 1
            return self._act("ef_flush", step, self._roll_back(step, state, flush=True),
                             attempt=self._flushes_used, detail=trips[0].reason)
        if self._rewinds_used < cfg.max_rewinds:
            restored, rewind_to = self._rewind(step, trips, state)
            self._rewinds_used += 1
            # a rewind opens a fresh incident at the restored step
            self._skips_used = 0
            self._flushes_used = 0
            self.guards.reset_window()
            return self._act("rewind", step, restored, attempt=self._rewinds_used,
                             detail=trips[0].reason, rewind_to=rewind_to)
        raise RecoveryError(
            f"recovery ladder exhausted at step {step}: {self._skips_used} skip(s), "
            f"{self._flushes_used} flush(es), {self._rewinds_used} rewind(s) "
            f"(last trip: {trips[0].guard}: {trips[0].reason})",
            trips=self.guards.trips)

    def _roll_back(self, step: int, state: dict, *, flush: bool) -> dict:
        """Restore the latest rollback point at or before the tripped step
        (its pre-step state with ``sync_every=1``, else its batch window's
        start) into the live tensors; with ``flush`` the residual is
        dropped.  A re-plan since the copy drops it too: a residual
        accumulated under another plan has no meaning under this one, and
        its layout may differ.  The params and the optimizer state keep
        their layout across a re-plan and are always restored in place."""
        from ..runtime.transitions import carry_comp_state

        best = None
        for w in (self._prev_win, self._win):
            if w is not None and w.step <= step and (best is None or w.step > best.step):
                best = w
        if best is None:
            raise RecoveryError("no pre-step snapshot to skip back to")
        tr = self.trainer
        out = {**state, "step": best.step, "params": best.restore_into(state, "params"),
               "opt": best.restore_into(state, "opt")}
        replanned = best.plan is not tr.plan
        if replanned and best.pending_sync:
            # the copy's deferred gather belongs to the plan it was taken under
            tr.settle_gather(out, best.compressor, best.plan)
        tr._pending_sync = best.pending_sync and not replanned
        if not (flush or replanned):
            out["comp"] = best.restore_into(state, "comp")
            return out
        out = tr.flush_sync(out)
        comp, report = carry_comp_state(
            best.copy_of("comp"), new_compressor=tr.compressor, new_plan=tr.plan,
            params_like=out["params"], step=step, old_interval=best.interval,
            new_interval=tr.tc.interval, policy="flush")
        tr.transitions.append(report)
        out["comp"] = comp
        return out

    def _rewind(self, step: int, trips: list[GuardTrip], state: dict) -> tuple[dict, int]:
        cfg = self._cfg
        if not cfg.ckpt_dir:
            raise RecoveryError(
                f"guard trip at step {step} needs a checkpoint rewind but "
                f"GuardConfig.ckpt_dir is not set", trips=trips)
        last = checkpoint.latest_step(cfg.ckpt_dir)
        if last is None:
            raise RecoveryError(
                f"guard trip at step {step} needs a checkpoint rewind but "
                f"{cfg.ckpt_dir!r} holds no checkpoint yet", trips=trips)
        tr = self.trainer
        t0 = time.perf_counter()
        restored, _ = checkpoint.restore_train_state(cfg.ckpt_dir, state,
                                                     names=tr.leaf_names,
                                                     group=tr.world_group)
        self.timings["restore"].append(time.perf_counter() - t0)
        tr._pending_sync = False          # a checkpoint holds whole params
        return restored, int(last)

    def _save_checkpoint(self, state: dict) -> dict:
        cfg = self._cfg
        tr = self.trainer
        state = tr.flush_sync(state)     # sharded: persist whole params
        t0 = time.perf_counter()
        path = checkpoint.save_train_state(cfg.ckpt_dir, state, interval=tr.tc.interval,
                                           extra={"guard_owned": True},
                                           names=tr.leaf_names, group=tr.world_group,
                                           shared=not tr.hierarchical)
        self.timings["save"].append(time.perf_counter() - t0)
        self._last_saved_step = int(state["step"])
        if self.telemetry.enabled:
            self.telemetry.events.emit("checkpoint", step=int(state["step"]), path=path)
        return state

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _emit_trip(self, t: GuardTrip) -> None:
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.events.emit(
            "guard_trip", step=int(t.step), guard=t.guard, reason=t.reason,
            value=float(t.value) if math.isfinite(t.value) else None,
            threshold=float(t.threshold) if math.isfinite(t.threshold) else None)
        tel.registry.counter("guard_trips_total", "numeric guard trips, by guard",
                             guard=t.guard).inc()

    def _act(self, action: str, step: int, state: dict, *, attempt: int, detail: str,
             rewind_to: int | None = None) -> dict:
        rec = {"step": step, "action": action, "attempt": attempt, "detail": detail}
        if rewind_to is not None:
            rec["rewind_to"] = rewind_to
        self.actions.append(rec)
        tel = self.telemetry
        if tel.enabled:
            kw = {} if rewind_to is None else {"rewind_to": int(rewind_to)}
            tel.events.emit("recovery", step=step, action=action, ok=True,
                            attempt=attempt, detail=detail, **kw)
            tel.registry.counter("recovery_actions_total",
                                 "recovery ladder actions, by rung",
                                 action=action).inc()
        return state

    def summary(self) -> dict:
        out = {
            "trips": len(self.guards.trips) if self.guards else 0,
            "trips_by_guard": {},
            "actions": len(self.actions),
            "actions_by_rung": {},
            "rewinds_used": self._rewinds_used,
        }
        for t in self.guards.trips if self.guards else ():
            out["trips_by_guard"][t.guard] = out["trips_by_guard"].get(t.guard, 0) + 1
        for a in self.actions:
            out["actions_by_rung"][a["action"]] = (
                out["actions_by_rung"].get(a["action"], 0) + 1)
        if self.injector is not None:
            out["faults"] = self.injector.summary()
        return out


__all__ = ["ACTIONS", "RecoveryError", "ResilienceRuntime"]
