"""Host wall-time spans (trimmed copy of
processing_chain_tpu/utils/tracing.py).

`span(name)` records one per-thread-nested wall-time span; `Job.run`
wraps every job in one. The reference's device trace (`jax.profiler`,
tracing.py:172-198) and its report writer are not carried over.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

from . import lockdebug


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


_tracer = Tracer()


def span(name: str, **meta):
    return _tracer.span(name, **meta)
