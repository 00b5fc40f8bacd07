"""Serve-side LRU pressure on the artifact store.

A daemon that never exits needs the batch CLI's `tools store-admin gc` run
FOR it: after completions, this hook checks the store's object bytes
against the operator's budget and, over budget, runs the shared
`store.gc.enforce_budget` pass with the plans of every UNFINISHED
request passed as ephemeral pins — the cache can evict any completed
cold artifact, but never one a queued request is about to claim.

Throttled (`min_interval_s`) because the budget check walks objects/;
eviction pressure is a trend, not a per-job emergency.

The port's copy of processing_chain_tpu/serve/pressure.py.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .. import telemetry as tm
from ..store import gc as store_gc
from ..utils import lockdebug
from ..utils.log import get_logger

_GC_EVICTED = tm.counter(
    "chain_serve_gc_evicted_bytes_total",
    "bytes freed by serve-side store GC pressure",
)


class StorePressure:
    """Budget enforcement hook wired to scheduler completions."""

    def __init__(
        self,
        store,
        budget_bytes: Optional[int],
        active_plans: Callable[[], set],
        min_interval_s: float = 5.0,
        heat=None,
    ) -> None:
        self.store = store
        self.budget_bytes = budget_bytes
        self.active_plans = active_plans
        #: store.heat.HeatLedger (optional): evictions land in the
        #: forensics journal so later re-reads count as regret
        self.heat = heat
        self.min_interval_s = float(min_interval_s)
        self._lock = lockdebug.make_lock("serve_pressure")
        self._last = 0.0          # guarded-by: _lock
        self._running = False     # guarded-by: _lock

    def _tier_overflow(self) -> bool:
        """True when any non-last tier outgrew its OWN byte budget —
        demotion pressure (store/gc.py "demote before evict") exists
        even when no TOTAL budget is configured."""
        tiers = getattr(self.store, "tiers", None)
        if tiers is None or not tiers.multi:
            return False
        return any(
            t.budget_bytes is not None
            and t.bytes_held() > t.budget_bytes
            for t in tiers.tiers[:-1]
        )

    def maybe_collect(self, force: bool = False) -> Optional[dict]:
        """One throttled budget check; the GC pass itself runs OUTSIDE
        the lock (it walks the store) with reentry suppressed. Returns
        the gc summary when a pass ran, else None. The pass runs when
        the TOTAL budget is exceeded (eviction pressure) or when any
        tier outgrew its own budget (demotion pressure)."""
        if self.store is None:
            return None
        tiers = getattr(self.store, "tiers", None)
        if not self.budget_bytes and (tiers is None or not tiers.multi):
            return None
        with self._lock:
            now = time.monotonic()
            if self._running:
                return None
            if not force and now - self._last < self.min_interval_s:
                return None
            self._last = now
            self._running = True
        try:
            stats = self.store.stats()
            over_total = bool(
                self.budget_bytes and stats["bytes"] > self.budget_bytes)
            if not force and not over_total and not self._tier_overflow():
                return None
            pins = set(self.active_plans())
            summary = store_gc.enforce_budget(
                self.store, self.budget_bytes, extra_pins=pins,
                heat=self.heat,
            )
            _GC_EVICTED.inc(summary["bytes_freed"])
            tm.emit(
                "serve_gc",
                bytes_freed=summary["bytes_freed"],
                objects_evicted=summary["objects_evicted"],
                demoted_bytes=summary.get("demoted_bytes", 0),
                pins_honored=summary["pins_honored"],
                kept_bytes=summary["kept_bytes"],
            )
            if summary["bytes_freed"] or summary.get("demoted_bytes"):
                get_logger().info(
                    "serve gc: freed %d bytes (%d objects), demoted %d "
                    "bytes, %d pin(s) honored, %d bytes kept",
                    summary["bytes_freed"], summary["objects_evicted"],
                    summary.get("demoted_bytes", 0),
                    summary["pins_honored"], summary["kept_bytes"],
                )
            return summary
        finally:
            with self._lock:
                self._running = False
