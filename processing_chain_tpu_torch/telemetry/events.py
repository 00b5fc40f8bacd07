"""Structured run-event log: an append-only list of JSON records (copy of
processing_chain_tpu/telemetry/events.py).

One record per interesting state transition — stage start/end, per-job
planned/start/end/skip/redo/fail, prefetch queue samples, device step
timings, serve request, queue and wave transitions — written out by
`telemetry.write_outputs` as events_<ts>.jsonl and consumed by
telemetry/report.py (`tools run-report`).

Same enablement contract as the metrics registry: `emit()` starts with
one attribute check and allocates nothing while telemetry is off, so the
call can sit on hot-ish paths unguarded (per-chunk, per-job — never
per-frame).

Records may carry OPTIONAL distributed-tracing fields (docs/TELEMETRY.md
"Fleet observability & tracing"): `trace_id` (the request's trace
context — serve request events carry it; job events carry the first of
their trace ids plus `trace_ids` when one execution answers several)
and `request_ids` (every request a job event answers). Emit sites add
them where the context exists; consumers treat absence as "not
serve-originated", never as an error — batch-chain events predate the
serve layer and stay valid without them.
"""

from __future__ import annotations

import json
import os
import time
from ..utils import lockdebug


class EventLog:
    """Thread-safe, in-memory, bounded event recorder.

    The cap exists so a pathological emitter (e.g. a queue-depth sampler
    on a week-long run) degrades to dropped samples + a drop counter,
    never to unbounded host memory; `drops` is exported in the tail
    record so a report can say the log is partial.
    """

    def __init__(self, max_events: int = 200_000) -> None:
        self._lock = lockdebug.make_lock("events")
        self._events: list[dict] = []  # guarded-by: _lock
        self.max_events = max_events
        self.drops = 0  # guarded-by: _lock
        self.enabled = False
        self._t0 = time.time()
        self._t0_perf = time.perf_counter()

    def emit(self, event: str, **fields) -> None:
        if not self.enabled:
            return
        record = {
            "t": round(time.perf_counter() - self._t0_perf, 6),
            "event": event,
        }
        record.update(fields)
        with self._lock:
            if len(self._events) >= self.max_events:
                self.drops += 1
                return
            self._events.append(record)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.drops = 0
        self._t0 = time.time()
        self._t0_perf = time.perf_counter()

    def write_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            events = list(self._events)
            drops = self.drops
            t0 = self._t0
        from ..utils.fsio import atomic_write

        def _write(tmp: str) -> None:
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "event": "log_meta", "t": 0.0, "epoch_t0": round(t0, 3),
                    "n_events": len(events), "dropped": drops,
                }) + "\n")
                for record in events:
                    f.write(json.dumps(record) + "\n")

        atomic_write(path, _write)
        return path


def read_jsonl(path: str) -> list[dict]:
    """Inverse of write_jsonl (used by telemetry/report.py); tolerates a
    truncated final line from an interrupted writer."""
    out: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return out


EVENTS = EventLog()


def emit(event: str, **fields) -> None:
    EVENTS.emit(event, **fields)

