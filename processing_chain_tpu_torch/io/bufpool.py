"""Recycling pool of pre-allocated host plane blocks (trimmed copy of
processing_chain_tpu/io/bufpool.py, without its telemetry counters).

`acquire` hands back a previously released block of the same (shape,
dtype) when one is free, else allocates, so the host frame path does not
pay an mmap and page-fault sweep per ~100 MB chunk block.

Ownership protocol:

  * `acquire(shape, dtype)` transfers ownership to the caller.
  * `release(*arrays)` returns ownership; ONLY the exact array object
    returned by `acquire` recycles (views are ignored), so a producer
    that hands a consumer a trimmed view `block[:n]` never has the backing
    block yanked while other views of it are still alive.
  * Releasing a foreign or already-released array is a safe no-op.
  * Dropping a pooled block without releasing it leaks one allocation,
    not pool bookkeeping: outstanding blocks are tracked by weakref.

Thread-safe; the default pool is shared by the decode prefetch threads
and the device loop.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

# free blocks kept per (shape, dtype): chunk blocks run ~100 MB at 1080p x
# 64 frames, so an unbounded free list would pin the high-water mark
_MAX_FREE_PER_KEY = 4


class BufferPool:
    """Keyed free lists of C-contiguous ndarrays (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._outstanding: dict[int, weakref.ref] = {}

    @staticmethod
    def _key(shape, dtype) -> tuple:
        return (tuple(int(s) for s in shape), np.dtype(dtype).str)

    def acquire(self, shape, dtype=np.uint8) -> np.ndarray:
        key = self._key(shape, dtype)
        with self._lock:
            free = self._free.get(key)
            arr = free.pop() if free else None
        if arr is None:
            arr = np.empty(shape, dtype)  # allocate outside the lock
        self._track(arr)
        return arr

    def _track(self, arr: np.ndarray) -> None:
        key = id(arr)

        def _dropped(_ref, *, _self=weakref.ref(self), _key=key):  # noqa: B008 - definition-time capture is the point
            # lock-free: a GC pass can fire this on a thread that already
            # holds the pool lock; a single-key dict.pop is GIL-atomic
            pool = _self()
            if pool is not None:
                pool._outstanding.pop(_key, None)

        with self._lock:
            self._outstanding[key] = weakref.ref(arr, _dropped)

    def release(self, *arrays: np.ndarray) -> None:
        for arr in arrays:
            if not isinstance(arr, np.ndarray):
                continue
            with self._lock:
                ref = self._outstanding.get(id(arr))
                if ref is None or ref() is not arr:
                    continue  # foreign array, a view, or double release
                del self._outstanding[id(arr)]
                free = self._free.setdefault(self._key(arr.shape, arr.dtype), [])
                if len(free) < _MAX_FREE_PER_KEY:
                    free.append(arr)

    def owns(self, arr) -> bool:
        """True when `arr` is exactly an outstanding block of this pool
        (views and foreign arrays are not owned: the release rule)."""
        if not isinstance(arr, np.ndarray):
            return False
        with self._lock:
            ref = self._outstanding.get(id(arr))
            return ref is not None and ref() is arr

    def stats(self) -> dict:
        """Blocks and bytes parked on the free lists and held by the
        pipeline (the resource monitor's pool numbers)."""
        with self._lock:
            # outstanding bytes resolve the weakrefs on demand (a ~1 Hz
            # resource-monitor call, never a hot path): refs whose arrays
            # were dropped without release count as gone. The lock-free
            # weakref callback can still pop concurrently, so retry the
            # iteration the (rare) time it mutates the dict under us.
            for _ in range(4):
                try:
                    live = [ref() for ref in list(self._outstanding.values())]
                    break
                except RuntimeError:
                    continue
            else:
                live = []
            return {
                "free_blocks": sum(len(v) for v in self._free.values()),
                "free_bytes": sum(a.nbytes for v in self._free.values() for a in v),
                "outstanding": len(self._outstanding),
                "outstanding_bytes": sum(a.nbytes for a in live if a is not None),
            }


#: process-wide default pool, shared by the decode and compute stages
DEFAULT_POOL = BufferPool()
