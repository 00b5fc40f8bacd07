"""The autoscale signal plane: desired replicas, with evidence.

ROADMAP item 2's remaining piece — "SLO-driven elasticity: the /fleet
queue-wait histograms become a scale signal" — lands here. The
`AutoscaleAdvisor` turns three measurements into one machine-readable
recommendation (`GET /fleet/scale-signal`):

  * **queue-wait burn**: active `slo_burn_queue_wait`/`slo_burn_e2e`
    alerts from the burn-rate engine (telemetry/alerts.py) — latency
    SLOs already breaching is the strongest "add capacity" evidence;
  * **per-class backlog**: queued record counts and predicted seconds
    per priority class (serve/queue.py `backlog()`), which pick the
    drain horizon — interactive backlog must drain inside a 2.5 s
    queue-wait band, bulk backlog gets 300 s;
  * **seconds-of-work-in-queue**: the calibrated cost model's
    predicted outstanding seconds (serve/cost.py) divided by
    per-replica throughput (`workers` predicted-seconds per wall
    second) — the steady-state capacity term.

The recommendation is re-graded by every service maintenance control
tick and journaled (kind=`scale` records in the alert journal — the
same files the alerts live in) whenever the desired count changes, so
a scale decision is always attributable to the evidence that produced
it. Scale-down is held for `scale_down_hold_s` of sustained calm;
scale-up is immediate. Confidence is explicit: a cold cost model or a
young engine marks the signal as low-confidence rather than silently
guessing.

An external autoscaler consumes the signal; this module never starts
or stops replicas itself.

The port's copy of processing_chain_tpu/serve/autoscale.py.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..telemetry import catalog
from ..telemetry.events import emit
from ..telemetry.metrics import gauge
from ..utils import lockdebug

DESIRED = gauge(
    "chain_scale_desired_replicas",
    "replicas the autoscale advisor currently recommends",
)
BACKLOG_S = gauge(
    "chain_scale_backlog_seconds",
    "predicted seconds of queued work behind the scale signal",
)

#: alert rules whose firing is direct scale-up evidence
_BURN_RULES = ("slo_burn_queue_wait", "slo_burn_e2e")

#: sustained-calm seconds before a scale-down is recommended (scaled
#: by window_scale like the alert windows)
DEFAULT_SCALE_DOWN_HOLD_S = 120.0


class AutoscaleAdvisor:
    """Grades the desired replica count from the queue's backlog, the
    cost model's outstanding seconds, and the burn-rate engine's
    active alerts. One advisor per replica; recommendations carry the
    grading replica so concurrent graders stay attributable."""

    def __init__(self, journal, replica: str, *,
                 workers: int = 2,
                 min_replicas: int = 1,
                 max_replicas: int = 32,
                 scale_down_hold_s: float = DEFAULT_SCALE_DOWN_HOLD_S,
                 window_scale: float = 1.0) -> None:
        self.journal = journal  # shared AlertJournal (never raises)
        self.replica = replica
        self.workers = max(1, int(workers))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.scale_down_hold_s = (float(scale_down_hold_s)
                                  * float(window_scale))
        self._lock = lockdebug.make_lock("autoscale")
        self._last: Optional[dict] = None     # guarded-by: _lock
        self._last_desired: Optional[int] = None  # guarded-by: _lock
        self._below_since: Optional[float] = None  # guarded-by: _lock
        self._evaluations = 0                 # guarded-by: _lock

    # ------------------------------------------------------- evaluation

    def evaluate(self, *, current_replicas: int, backlog: dict,
                 outstanding_s: float, active_alerts: list,
                 calibrated: bool = False,
                 now: Optional[float] = None) -> dict:
        """One grading pass; returns (and caches) the scale-signal
        document, journaling it when the desired count moves."""
        now = time.time() if now is None else now
        current = max(1, int(current_replicas))
        outstanding_s = max(0.0, float(outstanding_s))
        reasons: list[str] = []

        # drain horizon: the tightest queue-wait band among classes
        # that actually hold backlog — interactive work waiting means
        # the fleet must drain FAST
        bands = catalog.SLO_BANDS["queue_wait_s"]
        horizons = [bands[cls] for cls, b in (backlog or {}).items()
                    if cls in bands and (b.get("count") or 0) > 0]
        horizon_s = min(horizons) if horizons else max(bands.values())

        # capacity term: replicas needed to drain the predicted
        # outstanding seconds inside the horizon, at `workers`
        # predicted-seconds of throughput per replica-second
        work_based = 1
        if outstanding_s > 0:
            work_based = math.ceil(
                outstanding_s / max(1e-9, horizon_s * self.workers))
            if work_based > 1:
                reasons.append("backlog_pressure")

        # burn term: latency SLOs already breaching — add capacity now
        burning = [a for a in (active_alerts or [])
                   if a.get("rule") in _BURN_RULES]
        burn_based = 1
        if burning:
            burn_based = current + max(1, current // 2)
            reasons.append("queue_wait_burn")

        desired = max(self.min_replicas, work_based, burn_based)
        desired = min(desired, self.max_replicas)
        if desired == self.max_replicas and \
                max(work_based, burn_based) > self.max_replicas:
            reasons.append("max_ceiling")

        # scale-down hold: a quiet moment is not evidence of a quiet
        # hour — recommend fewer replicas only after sustained calm
        with self._lock:
            self._evaluations += 1
            evaluations = self._evaluations
            if desired < current:
                if self._below_since is None:
                    self._below_since = now
                if now - self._below_since < self.scale_down_hold_s:
                    desired = current
                    reasons.append("scale_down_hold")
                else:
                    reasons.append("idle_capacity")
            else:
                self._below_since = None
        if not reasons:
            reasons.append("steady")

        confidence = 0.35
        if calibrated:
            confidence += 0.25
        else:
            reasons.append("cold_cost_model")
        if evaluations >= 3:
            confidence += 0.25  # enough history to trust the windows
        if not burning or desired > current:
            confidence += 0.15  # the evidence and the verdict agree
        confidence = round(min(0.95, confidence), 2)

        signal = {
            "schema": 1,
            "generated_at": round(now, 3),
            "graded_by": self.replica,
            "replicas_current": current,
            "replicas_desired": int(desired),
            "confidence": confidence,
            "reasons": sorted(set(reasons)),
            "inputs": {
                "outstanding_s": round(outstanding_s, 3),
                "horizon_s": horizon_s,
                "workers_per_replica": self.workers,
                "backlog": backlog or {},
                "burning_alerts": [a.get("alert") for a in burning],
            },
        }
        DESIRED.set(desired)
        BACKLOG_S.set(outstanding_s)
        with self._lock:
            moved = self._last_desired != int(desired)
            self._last_desired = int(desired)
            self._last = signal
        if moved:
            self.journal.append({
                "kind": "scale",
                "desired": int(desired), "current": current,
                "confidence": confidence,
                "reasons": signal["reasons"],
                "inputs": signal["inputs"], "ts": round(now, 6),
            })
            emit("scale_signal", desired=int(desired), current=current,
                 confidence=confidence, reasons=signal["reasons"])
        return signal

    def latest(self) -> Optional[dict]:
        """The most recent recommendation (the /fleet/scale-signal
        payload), or None before the first grading pass."""
        with self._lock:
            return dict(self._last) if self._last else None
