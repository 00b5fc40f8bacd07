"""Decode-ahead on a worker thread (trimmed copy of `Prefetcher` from
processing_chain_tpu/engine/prefetch.py:130-253, without heartbeats,
profiling spans or queue-depth telemetry)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

_SENTINEL = object()
_EXHAUSTED = object()


def _put_until_stop(q: queue.Queue, item: Any, stop: threading.Event) -> bool:
    """Blocking put that a concurrent close() can always interrupt: close()
    sets `stop` and keeps the queue drained, so either the put lands or the
    worker sees the flag within one timeout tick. Returns whether the item
    landed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _drain_join(q: queue.Queue, thread: threading.Thread) -> None:
    """With the stop flag set, keep the queue drained (so no worker put
    can block) until the worker thread has exited."""
    while thread.is_alive():
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=0.1)


class Prefetcher:
    """Iterate `source` on a background thread, keeping up to `depth`
    items ready. Exceptions raised by the source surface at the consumer's
    next pull, preserving fail-fast semantics. `close()` stops the worker
    and waits for it."""

    def __init__(self, source: Iterable[Any], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def worker() -> None:
            try:
                src = iter(source)
                while True:
                    item = next(src, _EXHAUSTED)
                    if item is _EXHAUSTED or self._stop.is_set():
                        break
                    _put_until_stop(self._q, item, self._stop)
            except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
                self._err = exc
            finally:
                _put_until_stop(self._q, _SENTINEL, self._stop)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                return
            yield item

    def close(self) -> None:
        """Abandon the stream (e.g. on a downstream error). Blocks until the
        worker has exited; the wait is bounded by one in-flight item."""
        self._stop.set()
        _drain_join(self._q, self._thread)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
