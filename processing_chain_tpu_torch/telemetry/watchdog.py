"""Stall watchdog: a daemon thread over the heartbeat registry (copy of
processing_chain_tpu/telemetry/watchdog.py).

Two thresholds, scanned every `poll_s`:

  * **soft** (default 300 s) — a task whose beat age exceeds it is
    flagged: one structured `task_stalled` event carrying an all-thread
    stack dump (the forensics that distinguish "blocked on a queue put"
    from "stuck in a native decode") plus a console warning. The flag
    re-arms when the task beats again (`task_recovered` event), so a
    task that stalls twice is reported twice.
  * **hard** (opt-in, off by default) — past it the task is *marked
    failed with forensics instead of hanging forever*: a
    `task_hard_timeout` event with the stack dump, the heartbeat is
    removed from the live set with status "timeout", and its
    `cancelled` flag is set so cooperative wait loops abort at their
    next check. In the port the only such loop is the distributed
    barrier (parallel/distributed.fs_barrier): its Prefetcher registers
    no heartbeat and the writer is not ported, so a stalled prefetch or
    writeback is flagged only through the heartbeat of the job or task
    around it. Python cannot kill a hung native call, so cancellation
    is cooperative by design — the event log still records WHERE it
    hung either way.

Beat age measures time since the last *progress* beat (see
telemetry/heartbeat.py), so slow-but-flowing pipelines stay quiet and
genuinely wedged ones surface within one soft threshold.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Optional

from .events import emit
from .heartbeat import HEARTBEATS, HeartbeatRegistry

#: Stack dumps are bounded so one stalled scan can't blow the event
#: log's memory cap (events are capped in count, not record size).
_MAX_STACK_CHARS = 8000

DEFAULT_SOFT_S = 300.0

#: Kinds whose wait loops poll `cancelled` and abort: these the hard
#: timeout genuinely terminates, so their heartbeat is finished as
#: "timeout". The set is the reference's; the port registers only
#: "barrier" today ("prefetch" and "writeback" are the reference's
#: Prefetcher and writer loops). Execution wrappers (job/task/
#: device_step/runner) wrap uninterruptible work — Python cannot kill
#: it — so for those the hard timeout records the same forensics and
#: sets `cancelled`, but leaves the heartbeat live: if the work does
#: eventually finish, its real outcome is recorded instead of a false
#: "timeout" verdict.
CANCELLABLE_KINDS = frozenset({"barrier", "prefetch", "writeback"})


def dump_all_stacks(limit: int = _MAX_STACK_CHARS) -> str:
    """All-thread stack dump, bounded; names threads for readability."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(
            f"--- thread {names.get(ident, '?')} ({ident}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    text = "\n".join(parts)
    if len(text) > limit:
        text = text[:limit] + "\n... [stack dump truncated]"
    return text


class Watchdog:
    """Daemon scanning thread. `start()`/`stop()` are idempotent; `scan()`
    is callable directly (the tests drive it with an injected clock)."""

    def __init__(self, soft_s: float = DEFAULT_SOFT_S,
                 hard_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 registry: HeartbeatRegistry = HEARTBEATS) -> None:
        self.soft_s = float(soft_s)
        self.hard_s = float(hard_s) if hard_s else None
        # scan often enough that a stall is seen well inside one soft
        # threshold, but never busier than 1 Hz
        self.poll_s = float(poll_s) if poll_s else max(1.0, self.soft_s / 10.0)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Watchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="chain-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.scan()
            except Exception:  # pragma: no cover - the watchdog must
                pass  # never take the run down with it

    # --------------------------------------------------------------- scan

    def scan(self) -> list[dict]:
        """One pass over the live heartbeats; returns the incidents found
        ({"task", "incident": "stalled"|"hard_timeout", ...})."""
        from ..utils.log import get_logger

        registry = self._registry
        incidents: list[dict] = []
        # Flag decisions happen UNDER the registry lock: the previous
        # lock-free pass could set `stall_flagged` the instant after a
        # beat() cleared it (ghost-stalling a just-recovered task) and
        # read a `t_beat`/`units_done` pair mid-update. The expensive
        # work — stack dumps, events, logging — stays outside the lock.
        flagged: list[tuple] = []  # (incident, hb, age, units_done)
        with registry._lock:
            now = registry._clock()
            for hb in registry._live.values():
                if hb.kind == "stage":
                    continue  # stages stall iff their jobs do; report those
                age = now - hb.t_beat
                if self.hard_s is not None and age > self.hard_s:
                    if hb.cancelled:
                        continue  # already killed; its loop will see it
                    hb.cancelled = True
                    flagged.append(("hard_timeout", hb, age, hb.units_done))
                elif age > self.soft_s and not hb.stall_flagged:
                    hb.stall_flagged = True
                    flagged.append(("stalled", hb, age, hb.units_done))
        for incident, hb, age, units_done in flagged:
            stacks = dump_all_stacks()
            if incident == "hard_timeout":
                emit(
                    "task_hard_timeout", task=hb.label, kind=hb.kind,
                    stage=hb.stage, beat_age_s=round(age, 1),
                    units_done=units_done, hard_s=self.hard_s,
                    stacks=stacks,
                )
                if hb.kind in CANCELLABLE_KINDS:
                    registry._finish(hb, "timeout")
                    get_logger().error(
                        "watchdog: %s '%s' exceeded the hard timeout "
                        "(%.0fs without progress > %.0fs); cancelled, "
                        "forensics in the event log",
                        hb.kind, hb.label, age, self.hard_s,
                    )
                else:
                    get_logger().error(
                        "watchdog: %s '%s' exceeded the hard timeout "
                        "(%.0fs without progress > %.0fs); cannot be "
                        "interrupted — forensics recorded, left running",
                        hb.kind, hb.label, age, self.hard_s,
                    )
            else:
                emit(
                    "task_stalled", task=hb.label, kind=hb.kind,
                    stage=hb.stage, beat_age_s=round(age, 1),
                    units_done=units_done, soft_s=self.soft_s,
                    stacks=stacks,
                )
                get_logger().warning(
                    "watchdog: %s '%s' has made no progress for %.0fs "
                    "(soft threshold %.0fs) — stack dump in the event log",
                    hb.kind, hb.label, age, self.soft_s,
                )
            incidents.append({
                "task": hb.label, "incident": incident,
                "beat_age_s": age,
            })
        return incidents


def active_stalls(registry: HeartbeatRegistry = HEARTBEATS) -> list[dict]:
    """The live stall/hard-timeout episodes, with stage/task labels —
    what the serve /status section and the fleet view surface so a
    stalled replica is visible beyond its own process (the stack-dump
    events stay replica-local; this list travels). Hard-timeout
    episodes of cancellable kinds finish their heartbeat and leave the
    list; uninterruptible ones stay until the work really ends."""
    out: list[dict] = []
    with registry._lock:
        now = registry._clock()
        for hb in registry._live.values():
            if hb.kind == "stage":
                continue
            if not (hb.stall_flagged or hb.cancelled):
                continue
            out.append({
                "task": hb.label,
                "kind": hb.kind,
                "stage": hb.stage,
                "beat_age_s": round(now - hb.t_beat, 1),
                "units_done": hb.units_done,
                "incident": "hard_timeout" if hb.cancelled
                else "stalled",
            })
    out.sort(key=lambda s: -s["beat_age_s"])
    return out

