"""Decode-ahead on a worker thread and the streaming frame gathers
(trimmed copies of `Prefetcher`, processing_chain_tpu/engine/prefetch.py:
130-253, without heartbeats, profiling spans or queue-depth telemetry,
and of `stream_monotonic_gather` / `stream_fps_resample` :531-623,
without the decoded-frame counter)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

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


class ChunkFrame(NamedTuple):
    """One frame of a stacked chunk: its Y, U, V planes ([H, W] views)."""

    planes: list


def iter_chunk_frames(chunks: Iterable) -> Iterator[ChunkFrame]:
    """Unstack [T, H, W] plane chunks (tensors, on any device) into frames
    that carry `.planes`, the frame interface of the gathers below."""
    for planes in chunks:
        for i in range(planes[0].shape[0]):
            yield ChunkFrame([p[i] for p in planes])


def stream_monotonic_gather(
    frames: Iterable,
    out_index: Callable[[int], int],
    n_out: Optional[int],
    chunk: int = 64,
) -> Iterator[list[torch.Tensor]]:
    """Streaming version of `planes[idx]` for a nondecreasing index map.

    `out_index(k)` gives the (unclamped) source-frame index of output k;
    frames beyond the end of the stream clamp to the last frame (the
    reference's repeat-last-frame behavior). `frames` yields objects with
    `.planes` (tensors); each output chunk is one `torch.stack` per plane,
    on the frames' device. When `n_out` is None the output length is the
    number of outputs before the source ran out."""
    return _stream_gather_impl(frames, out_index, n_out, None, chunk)


def stream_fps_resample(
    frames: Iterable,
    src_fps: float,
    dst_fps: float,
    chunk: int = 64,
) -> Iterator[list[torch.Tensor]]:
    """Streaming ffmpeg `fps=` filter (ops/fps.fps_resample_indices
    semantics): output k at time k/dst_fps takes source frame
    floor(t*src_fps + 0.5); total output length round(n/src_fps*dst_fps)
    resolved when the source ends."""
    def out_index(k: int) -> int:
        return int(np.floor(k / dst_fps * src_fps + 0.5))

    def n_out_fn(n_src: int) -> int:
        return int(round(n_src / src_fps * dst_fps))

    return _stream_gather_impl(frames, out_index, None, n_out_fn, chunk)


def _stream_gather_impl(
    frames: Iterable,
    out_index: Callable[[int], int],
    n_out: Optional[int],
    n_out_fn: Optional[Callable[[int], int]],
    chunk: int,
) -> Iterator[list[torch.Tensor]]:
    buf: list[list[torch.Tensor]] = []

    def flush():
        nonlocal buf
        if buf:
            stacked = [
                torch.stack([planes[p] for planes in buf])
                for p in range(len(buf[0]))
            ]
            buf = []
            return stacked
        return None

    k = 0  # next output index
    cur = -1  # index of the last frame read
    last_planes: Optional[list[torch.Tensor]] = None
    it = iter(frames)
    exhausted = False
    while n_out is None or k < n_out:
        # read forward until the current frame is the one output k wants
        target = out_index(k)
        while not exhausted and cur < target:
            try:
                frame = next(it)
            except StopIteration:
                exhausted = True
                if n_out is None:
                    n_out = n_out_fn(cur + 1) if n_out_fn is not None else k
                break
            cur += 1
            last_planes = list(frame.planes)
        if n_out is not None and k >= n_out:
            break
        if last_planes is None:  # empty source
            break
        # past-the-end outputs repeat the last frame (clamp)
        buf.append(last_planes)
        k += 1
        if len(buf) == chunk:
            yield flush()
    tail = flush()
    if tail is not None:
        yield tail
