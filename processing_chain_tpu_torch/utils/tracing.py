"""Host wall-time spans and the device trace (copy of
processing_chain_tpu/utils/tracing.py, the device trace on
`torch.profiler`).

Usage:
    with tracing.span("avpvs P2SXM00_SRC000_HRC000"):
        ...
    tracing.get_tracer().write_report(logs_dir)   # logs_dir/trace_<ts>.json

`Job.run` wraps every job in one span. `DeviceProfiler(trace_dir)` captures
a `torch.profiler` trace (CPU ops, plus the card's kernels, copies and
memsets where CUDA is available) into `trace_dir/trace.json`, which
chrome://tracing and Perfetto open.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

from . import lockdebug
from .log import get_logger


@dataclass
class Span:
    name: str
    start: float
    duration: float
    thread: str
    depth: int
    meta: dict = field(default_factory=dict)


class Tracer:
    """Thread-safe span recorder. Spans nest per-thread (depth tracks the
    nesting so reports can indent); recording is cheap enough to leave on —
    a report is only materialized on demand.

    Bounded like the event log: the per-chunk lane spans a `--profile`
    capture adds (prefetch/writeback/transfer/device) accrue for the
    whole process, and a week-long profiled run must degrade to dropped
    spans + a counter in the report, never to unbounded host memory."""

    def __init__(self, max_spans: int = 200_000) -> None:
        self._lock = lockdebug.make_lock("tracer")
        self._spans: list[Span] = []  # guarded-by: _lock
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self.max_spans = max_spans
        self.dropped = 0  # guarded-by: _lock
        self.enabled = True

    @contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        start = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - start
            self._local.depth = depth
            with self._lock:
                if len(self._spans) >= self.max_spans:
                    self.dropped += 1
                else:
                    self._spans.append(
                        Span(
                            name=name,
                            start=start - self._t0,
                            duration=dur,
                            thread=threading.current_thread().name,
                            depth=depth,
                            meta=meta,
                        )
                    )

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
        self._t0 = time.perf_counter()

    def summary(self) -> dict[str, dict]:
        """Aggregate by span name: {name: {count, total_s, max_s}}."""
        agg: dict[str, dict] = {}
        for s in self.spans():
            entry = agg.setdefault(s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            entry["count"] += 1
            entry["total_s"] += s.duration
            entry["max_s"] = max(entry["max_s"], s.duration)
        for entry in agg.values():
            entry["total_s"] = round(entry["total_s"], 4)
            entry["max_s"] = round(entry["max_s"], 4)
        return agg

    def write_report(self, logs_dir: str, name: str = "") -> str:
        """Write spans + summary as JSON into `logs_dir`. Returns the report
        path. The default stamp is collision-safe: two runs finishing
        within the same second (or two processes sharing a directory)
        must not overwrite each other's report."""
        os.makedirs(logs_dir, exist_ok=True)
        if name:
            stamp = name
        else:
            from .. import telemetry

            stamp = telemetry.unique_stamp()
        path = os.path.join(logs_dir, f"trace_{stamp}.json")
        with self._lock:
            dropped = self.dropped
        payload = {
            "summary": self.summary(),
            **({"dropped_spans": dropped} if dropped else {}),
            "spans": [
                {
                    "name": s.name,
                    "start_s": round(s.start, 4),
                    "duration_s": round(s.duration, 4),
                    "thread": s.thread,
                    "depth": s.depth,
                    **({"meta": s.meta} if s.meta else {}),
                }
                for s in self.spans()
            ],
        }
        from .fsio import atomic_write_json

        atomic_write_json(path, payload)
        return path


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, **meta):
    return _tracer.span(name, **meta)


class DeviceProfiler:
    """`torch.profiler` capture into `trace_dir/trace.json`: CPU ops, and
    where CUDA is available the card's kernels, copies and memsets. A
    profiler that cannot start or write is logged and leaves `error` set
    (never raised): the caller decides whether a missing trace fails it."""

    TRACE_FILE = "trace.json"

    def __init__(self, trace_dir: Optional[str]) -> None:
        self.trace_dir = trace_dir
        self.error: Optional[str] = None
        self._prof = None

    def start(self) -> None:
        if not self.trace_dir:
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            self._prof = prof
            get_logger().info("device trace capturing to %s", self.trace_dir)
        except Exception as exc:  # noqa: BLE001 - reported through `error`
            self.error = f"device trace unavailable: {exc!r}"
            get_logger().warning(self.error)

    def stop(self) -> Optional[str]:
        """Stop and write the trace; returns its path, or None."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        path = os.path.join(self.trace_dir, self.TRACE_FILE)
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as exc:  # noqa: BLE001 - reported through `error`
            self.error = f"device trace not written: {exc!r}"
            get_logger().warning(self.error)
            return None
        get_logger().info("device trace written to %s", path)
        return path

    def __enter__(self) -> "DeviceProfiler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
