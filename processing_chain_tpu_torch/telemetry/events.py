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
import logging
import os
import time
from typing import Optional

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
        self._stream = None  # guarded-by: _lock

    def open_stream(self, path: str) -> str:
        """Additionally append every record to `path` AS IT IS EMITTED,
        so a run that crashes or hangs still leaves its event history on
        disk for forensics (tools run-report renders such a file as a
        partial run). write_jsonl to the same path at run end replaces
        the stream with the canonical complete file."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # chainlint: disable=atomic-write (live forensics stream: appended per record while the run is alive; read_jsonl tolerates a torn tail, and write_jsonl atomically replaces it with the canonical file at exit)
        f = open(path, "w")
        f.write(json.dumps({
            "event": "log_meta", "t": 0.0,
            "epoch_t0": round(self._t0, 3), "streaming": True,
        }) + "\n")
        f.flush()
        with self._lock:
            old, self._stream = self._stream, f
        if old is not None:
            old.close()
        return path

    def close_stream(self) -> None:
        with self._lock:
            stream, self._stream = self._stream, None
        if stream is not None:
            try:
                stream.close()
            except OSError:
                pass

    def emit(self, event: str, **fields) -> None:
        if not self.enabled:
            return
        record = {
            "t": round(time.perf_counter() - self._t0_perf, 6),
            "event": event,
        }
        record.update(fields)
        with self._lock:
            if self._stream is not None:
                try:
                    # flushed per record, and BEFORE the memory-cap check:
                    # the stream is disk-backed forensics for runs that
                    # never reach an orderly shutdown, so a run that
                    # overflowed the in-memory log still records its tail
                    # (watchdog stalls, the crash) on disk
                    self._stream.write(json.dumps(record) + "\n")
                    self._stream.flush()
                except (OSError, TypeError, ValueError):
                    pass  # forensics stream must never break the run
            if len(self._events) >= self.max_events:
                self.drops += 1
                return
            self._events.append(record)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        self.close_stream()
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
            # the canonical end-of-run file replaces any live stream to
            # the same path; close first so the rewrite wins
            stream, self._stream = self._stream, None
        if stream is not None:
            try:
                stream.close()
            except OSError:
                pass
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


class EventLogHandler(logging.Handler):
    """Bridges WARNING+ chain log records into the event log, so the
    structured record of a run carries the same anomalies the console
    showed (skip-existing warnings, degraded-path notices, errors). Runs
    as a second handler on the "main" logger next to the console
    handler."""

    def __init__(self, log: Optional[EventLog] = None) -> None:
        super().__init__(level=logging.WARNING)
        self._log = log or EVENTS

    def emit(self, record: logging.LogRecord) -> None:  # noqa: A003
        try:
            self._log.emit(
                "log",
                level=record.levelname,
                message=record.getMessage(),
            )
        except Exception:  # pragma: no cover - logging must never raise
            self.handleError(record)


def attach_log_handler(logger: logging.Logger) -> EventLogHandler:
    """Install (idempotently) the event-log bridge on `logger`."""
    for h in logger.handlers:
        if isinstance(h, EventLogHandler):
            return h
    handler = EventLogHandler()
    logger.addHandler(handler)
    return handler


def detach_log_handler(logger: logging.Logger) -> None:
    for h in list(logger.handlers):
        if isinstance(h, EventLogHandler):
            logger.removeHandler(h)
