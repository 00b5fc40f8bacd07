"""Heartbeat registry: the live in-flight view of a running chain (copy of
processing_chain_tpu/telemetry/heartbeat.py).

The metrics and events answer "what happened" after a run persists them;
this module answers "what is happening NOW". Every in-flight unit of
work — ParallelRunner tasks, engine Jobs, prefetch workers, jitted
device steps, the distributed barrier — registers a `Heartbeat` carrying
label / kind / start time / last-beat time / progress (units done ÷
planned). The watchdog (telemetry/watchdog.py) scans beat ages for
stalls, and the live endpoint / status file (telemetry/live.py) renders
the snapshot for operators.

Semantics that matter:

  * `beat()` means PROGRESS, not mere liveness. Waiting loops (the
    distributed barrier, a blocked queue put) deliberately do NOT beat
    while stuck, so their beat age grows and the watchdog can see them.
    Work loops beat once per unit (chunk, task, poll that advanced).
  * EWMA rate: each beat that advances units folds `d_units/d_t` into an
    exponentially-weighted moving rate, from which `eta_s` extrapolates
    remaining work. Per-stage ETA comes from the stage-level heartbeat
    `telemetry.stage_span` registers (units = jobs done / jobs planned).
  * Cancellation: the watchdog's hard timeout sets `cancelled`;
    cooperative loops call `check_cancelled()` (or poll `.cancelled`)
    and abort with `TaskCancelled` instead of hanging forever.

Same enablement contract as the rest of telemetry: disabled, `register`
returns a shared no-op heartbeat and every method is one attribute check.
"""

from __future__ import annotations

import itertools
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from ..utils import lockdebug
from .events import emit

#: EWMA smoothing: ~the last ten beats dominate the rate estimate.
_EWMA_ALPHA = 0.2
#: Finished tasks kept for the status view's "recent" list.
_RECENT_KEEP = 32


class TaskCancelled(RuntimeError):
    """Raised by cooperative wait loops after a watchdog hard timeout."""


class Heartbeat:
    """One in-flight unit of work. Thread-safe through the registry lock
    (mutations are per-unit — per chunk/task/poll — never per frame)."""

    __slots__ = (
        "id", "label", "kind", "stage", "t_start", "t_beat",
        "units_done", "units_planned", "status", "cancelled",
        "stall_flagged", "_rate", "_registry",
    )

    def __init__(self, registry: "HeartbeatRegistry", label: str, kind: str,
                 stage: Optional[str], planned: Optional[float],
                 now: float) -> None:
        self._registry = registry
        self.id = next(registry._ids)
        self.label = label
        self.kind = kind
        self.stage = stage
        self.t_start = now
        self.t_beat = now  # guarded-by: _lock
        self.units_done = 0.0  # guarded-by: _lock
        self.units_planned = planned  # guarded-by: _lock
        self.status = "running"  # guarded-by: _lock
        # deliberately NOT lock-guarded: a lock-free flag polled by
        # cooperative wait loops (barrier, prefetch puts) — bool
        # store/load is GIL-atomic and staleness only delays the abort
        # by one poll
        self.cancelled = False
        self.stall_flagged = False  # guarded-by: _lock
        self._rate = 0.0  # EWMA units/s  # guarded-by: _lock

    # ------------------------------------------------------------ mutation

    def beat(self, advance: float = 0.0, done: Optional[float] = None) -> None:
        """Record liveness + progress. `advance` adds units; `done` sets
        the absolute units-done count (the barrier knows peers-arrived,
        not a delta)."""
        registry = self._registry
        if not registry.enabled:
            return
        with registry._lock:
            now = registry._clock()
            dt = now - self.t_beat
            if done is not None:
                advance = max(0.0, done - self.units_done)
            if advance > 0.0:
                self.units_done += advance
                if dt > 1e-9:
                    sample = advance / dt
                    self._rate = (
                        sample if self._rate == 0.0
                        else _EWMA_ALPHA * sample + (1 - _EWMA_ALPHA) * self._rate
                    )
            self.t_beat = now
            was_flagged = self.stall_flagged
            self.stall_flagged = False
        if was_flagged:
            # stage rides along (like task_stalled's) so fleet-wide
            # consumers can pair recoveries with the stalls they end
            emit("task_recovered", task=self.label, kind=self.kind,
                 stage=self.stage)

    def set_planned(self, planned: Optional[float]) -> None:
        if not self._registry.enabled:
            return
        with self._registry._lock:
            self.units_planned = planned

    def add_planned(self, extra: float) -> None:
        if not self._registry.enabled:
            return
        with self._registry._lock:
            self.units_planned = (self.units_planned or 0.0) + extra

    def finish(self, status: str = "ok") -> None:
        self._registry._finish(self, status)

    def check_cancelled(self) -> None:
        """Cooperative cancellation point for wait loops."""
        if self.cancelled:
            raise TaskCancelled(
                f"{self.kind} '{self.label}' cancelled by the watchdog "
                "hard timeout (see task_hard_timeout event for forensics)"
            )

    # ------------------------------------------------- views (lock held)

    # holds-lock: _lock
    def progress(self) -> Optional[float]:
        if not self.units_planned:
            return None
        return min(1.0, self.units_done / self.units_planned)

    # holds-lock: _lock
    def eta_s(self) -> Optional[float]:
        """EWMA-extrapolated seconds to completion; None while the rate
        or the plan is unknown."""
        if not self.units_planned or self._rate <= 0.0:
            return None
        remaining = self.units_planned - self.units_done
        if remaining <= 0.0:
            return 0.0
        return remaining / self._rate

    # holds-lock: _lock
    def as_dict(self, now: float) -> dict:
        d = {
            "label": self.label,
            "kind": self.kind,
            "age_s": round(now - self.t_start, 3),
            "beat_age_s": round(now - self.t_beat, 3),
            "units_done": self.units_done,
            "status": self.status,
        }
        if self.stage:
            d["stage"] = self.stage
        if self.units_planned is not None:
            d["units_planned"] = self.units_planned
        progress = self.progress()
        if progress is not None:
            d["progress"] = round(progress, 4)
        eta = self.eta_s()
        if eta is not None:
            d["eta_s"] = round(eta, 1)
        if self.stall_flagged:
            d["stalled"] = True
        if self.cancelled:
            d["cancelled"] = True
        return d


class _NullHeartbeat:
    """Shared no-op returned while the registry is disabled: call sites
    keep one code path and a disabled run pays an attribute check."""

    __slots__ = ()
    label = kind = status = ""
    stage = units_planned = None
    cancelled = stall_flagged = False
    units_done = t_start = t_beat = 0.0

    def beat(self, advance: float = 0.0, done: Optional[float] = None) -> None:
        pass

    def set_planned(self, planned: Optional[float]) -> None:
        pass

    def add_planned(self, extra: float) -> None:
        pass

    def finish(self, status: str = "ok") -> None:
        pass

    def check_cancelled(self) -> None:
        pass

    def progress(self) -> Optional[float]:
        return None

    def eta_s(self) -> Optional[float]:
        return None


NULL_HEARTBEAT = _NullHeartbeat()


class HeartbeatRegistry:
    """Process-wide set of live heartbeats + a bounded recently-finished
    tail. `clock` is injectable (monotonic) so the watchdog tests can
    age tasks without sleeping."""

    def __init__(self, clock=time.monotonic) -> None:
        self._lock = lockdebug.make_lock("heartbeat")
        self._clock = clock
        self._ids = itertools.count(1)
        self._live: dict[int, Heartbeat] = {}  # guarded-by: _lock
        self._recent: list[Heartbeat] = []  # guarded-by: _lock
        self._stages: dict[str, dict] = {}  # guarded-by: _lock
        self._current_stage: Optional[str] = None  # guarded-by: _lock
        self.enabled = False

    # --------------------------------------------------------- lifecycle

    def register(self, label: str, kind: str = "task",
                 planned: Optional[float] = None):
        """New in-flight unit of work; inherits the current stage (set by
        `telemetry.stage_span`) so the status view can group by stage."""
        if not self.enabled:
            return NULL_HEARTBEAT
        with self._lock:
            hb = Heartbeat(
                self, label, kind, self._current_stage, planned, self._clock()
            )
            self._live[hb.id] = hb
            return hb

    def _finish(self, hb: Heartbeat, status: str) -> None:
        if isinstance(hb, _NullHeartbeat):
            return
        with self._lock:
            if self._live.pop(hb.id, None) is None:
                return  # already finished (e.g. watchdog timed it out)
            hb.status = status
            hb.t_beat = self._clock()
            self._recent.append(hb)
            del self._recent[:-_RECENT_KEEP]

    @contextmanager
    def task(self, label: str, kind: str = "task",
             planned: Optional[float] = None) -> Iterator:
        hb = self.register(label, kind, planned)
        try:
            yield hb
        except BaseException:
            hb.finish("fail")
            raise
        else:
            hb.finish("ok")

    # ------------------------------------------------------------- stages

    def stage_begin(self, stage: str):
        """Stage-level heartbeat: units are JOBS (planned by JobRunner.add
        via `stage_add_planned`, advanced by Job completion via
        `stage_advance`), which makes progress self-consistent even when
        a stage runs several job phases (p03 wo_buffer + stalling)."""
        hb = self.register(stage, kind="stage")
        if self.enabled:
            with self._lock:
                self._current_stage = stage
                self._stages[stage] = {"hb": hb, "items": None}
        return hb

    def stage_end(self, stage: str, status: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            entry = self._stages.get(stage)
            self._current_stage = None
        if entry is not None:
            entry["hb"].finish(status)

    def stage_items(self, stage: str, items: float) -> None:
        """Advisory work-item count (the STAGE_ITEMS gauge's live twin)."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._stages.get(stage)
            if entry is not None:
                entry["items"] = items

    def _stage_hb(self, stage: Optional[str]):
        with self._lock:
            entry = self._stages.get(stage or self._current_stage or "")
        return entry["hb"] if entry is not None else None

    def stage_add_planned(self, n: float = 1.0,
                          stage: Optional[str] = None) -> None:
        if not self.enabled:
            return
        hb = self._stage_hb(stage)
        if hb is not None:
            hb.add_planned(n)

    def stage_advance(self, n: float = 1.0,
                      stage: Optional[str] = None) -> None:
        if not self.enabled:
            return
        hb = self._stage_hb(stage)
        if hb is not None:
            hb.beat(advance=n)

    # -------------------------------------------------------------- views

    def live(self) -> list[Heartbeat]:
        with self._lock:
            return list(self._live.values())

    def snapshot(self) -> dict:
        """JSON-able live view: per-stage progress/ETA + every in-flight
        task with ages, plus the recently-finished tail.

        The whole view is materialized UNDER the registry lock: the
        previous copy-then-read shape let `/status` render a heartbeat
        whose `units_done` had advanced but whose `t_beat`/`_rate` had
        not (a torn progress/ETA pair) while worker threads beat
        concurrently — exactly the class chainlint's lock-guard rule
        now rejects. Snapshot cadence is operator-poll (~1 Hz), so
        holding the lock for the render costs nothing measurable."""
        with self._lock:
            now = self._clock()
            live = sorted(self._live.values(), key=lambda h: h.t_start)
            stage_view = {}
            current = self._current_stage
            for stage, entry in self._stages.items():
                hb = entry["hb"]
                d = {
                    "state": hb.status if hb.status != "running" else (
                        "running" if stage == current else "done"
                    ),
                    "jobs_done": hb.units_done,
                    "wall_s": round(
                        (hb.t_beat if hb.status != "running" else now)
                        - hb.t_start, 3,
                    ),
                }
                if hb.units_planned is not None:
                    d["jobs_planned"] = hb.units_planned
                progress = hb.progress()
                if progress is not None:
                    d["progress"] = round(progress, 4)
                eta = hb.eta_s()
                if eta is not None and hb.status == "running":
                    d["eta_s"] = round(eta, 1)
                if entry["items"] is not None:
                    d["items"] = entry["items"]
                stage_view[stage] = d
            return {
                "stages": stage_view,
                "current_stage": current,
                "tasks": [
                    h.as_dict(now) for h in live if h.kind != "stage"
                ],
                "recent": [
                    h.as_dict(now) for h in reversed(self._recent)
                ],
            }

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._recent.clear()
            self._stages.clear()
            self._current_stage = None


HEARTBEATS = HeartbeatRegistry()
