"""Decode-ahead on a worker thread, background writeback, and the
streaming frame gathers (trimmed copies of `Prefetcher`,
processing_chain_tpu/engine/prefetch.py:40-253, `AsyncWriter` :254-376
and `MultiSegmentPrefetcher` :378-505, all without heartbeats;
`iter_plane_chunks` :506-530; and `stream_monotonic_gather` /
`stream_fps_resample` :531-623, without the decoded-frame counter).

Each prefetch queue registers in the live-queue registry the resource
monitor samples (`live_queue_depths`), and each consumer pull records the
queue depth (`chain_queue_depth`) and the time the consumer sat blocked
(`chain_pipeline_wait_seconds_total{side="consumer"}`, the attribution
engine's decode component) while telemetry is on; under a profile
capture each decode lands in the timeline as a `prefetch:decode` span."""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry as tm
from ..telemetry import profiling
from ..utils import lockdebug

_SENTINEL = object()
_EXHAUSTED = object()

# Live bounded-queue registry: the resource monitor samples current
# depths by NAME (telemetry/profiling.sample_resources) without holding
# any pipeline object alive. Entries self-prune via the weakref callback
# when their queue dies.
_QUEUE_REGISTRY: dict[int, tuple[str, "weakref.ref"]] = {}
_QUEUE_REG_LOCK = lockdebug.make_lock("queue_registry")


def _register_queue(name: str, q: queue.Queue) -> None:
    key = id(q)

    def _gone(_ref, *, _key=key):
        # lock-free like bufpool's weakref callback: a GC sweep can fire
        # this on a thread already holding the registry lock, and a
        # single-key dict.pop is GIL-atomic
        _QUEUE_REGISTRY.pop(_key, None)

    with _QUEUE_REG_LOCK:
        _QUEUE_REGISTRY[key] = (name, weakref.ref(q, _gone))


def live_queue_depths() -> dict[str, dict]:
    """{queue name: {"queues": live instances, "depth": summed qsize}} of
    every registered pipeline queue still alive."""
    out: dict[str, dict] = {}
    with _QUEUE_REG_LOCK:
        # the lock-free callback can pop mid-iteration: retry the (rare)
        # race instead of excluding it
        for _ in range(4):
            try:
                entries = list(_QUEUE_REGISTRY.values())
                break
            except RuntimeError:
                continue
        else:
            entries = []
    for name, ref in entries:
        q = ref()
        if q is None:
            continue  # the callback will prune it
        entry = out.setdefault(name, {"queues": 0, "depth": 0})
        entry["queues"] += 1
        entry["depth"] += q.qsize()
    return out


# Telemetry handles, bound once at import; the consumer loop guards with
# `tm.enabled()` so a disabled run never calls qsize() or perf_counter().
# Granularity is per chunk, never per frame.
_Q_DEPTH = tm.histogram(
    "chain_queue_depth",
    "bounded-queue depth sampled at each consumer pull / producer push",
    ("queue",),
    buckets=tm.DEFAULT_DEPTH_BUCKETS,
)
_Q_DECODE = _Q_DEPTH.labels(queue="decode")
_WAIT = tm.counter(
    "chain_pipeline_wait_seconds_total",
    "time the pipeline spent blocked on a bounded queue, by side",
    ("side",),
)
_WAIT_CONSUMER = _WAIT.labels(side="consumer")
_Q_ENCODE = _Q_DEPTH.labels(queue="encode")
_WAIT_PRODUCER = _WAIT.labels(side="producer")
_EVENT_SAMPLE_EVERY = 64  # every Nth depth sample also lands in the event log


class _DepthSampler:
    """Per-pipeline-object sampling helper: histogram every sample, event
    log every Nth (events are for forensics; the histogram carries the
    distribution)."""

    __slots__ = ("_bound", "_queue_name", "_n")

    def __init__(self, bound, queue_name: str) -> None:
        self._bound = bound
        self._queue_name = queue_name
        self._n = 0

    def sample(self, depth: int) -> None:
        self._bound.observe(depth)
        self._n += 1
        if self._n % _EVENT_SAMPLE_EVERY == 1:
            tm.emit("queue_depth", queue=self._queue_name, depth=depth)


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


def _drain_join(queues: list, threads: list) -> None:
    """With the stop flag set, keep every queue drained (so no worker put
    can block) until every worker thread has exited: callers tear down
    native readers right after, which must not race a live decode."""
    while any(t.is_alive() for t in threads):
        for q in queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in threads:
            t.join(timeout=0.1)


class Prefetcher:
    """Iterate `source` on a background thread, keeping up to `depth`
    items ready. Exceptions raised by the source surface at the consumer's
    next pull, preserving fail-fast semantics. `close()` stops the worker
    and waits for it."""

    def __init__(self, source: Iterable[Any], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        _register_queue("decode", self._q)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._depth_sampler = _DepthSampler(_Q_DECODE, "decode")

        def worker() -> None:
            try:
                src = iter(source)
                while True:
                    # under a profile capture each pull (the decode of one
                    # chunk) lands in the span timeline as the decode lane
                    with profiling.maybe_span("prefetch:decode"):
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
            if tm.enabled():
                self._depth_sampler.sample(self._q.qsize())
                t0 = time.perf_counter()
                item = self._q.get()
                _WAIT_CONSUMER.inc(time.perf_counter() - t0)
            else:
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
        _drain_join([self._q], [self._thread])

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MultiSegmentPrefetcher:
    """Decode several segment chunk-streams concurrently, yielding chunks
    strictly in stream order (stream 0's chunks, then stream 1's, ...).

    `factories[i]` is a zero-argument callable returning segment i's chunk
    iterator; up to `workers` of them run on worker threads at once, each
    buffering into its own bounded queue of `depth` chunks. The consumer
    sees exactly the serially chained stream, while decode overlaps the
    segment joins (native decode releases the GIL).

    An error in stream k is raised when the consumer reaches stream k's
    position (earlier streams' chunks still flow), and `close()` stops
    every worker and waits for it."""

    def __init__(self, factories, workers: int = 2, depth: int = 2) -> None:
        self._factories = list(factories)
        self._n = len(self._factories)
        self._queues = [queue.Queue(maxsize=max(1, depth)) for _ in range(self._n)]
        for q in self._queues:
            _register_queue("decode", q)
        self._errs: list[Optional[BaseException]] = [None] * self._n
        self._stop = threading.Event()
        self._next = 0  # next unclaimed stream index
        self._claim_lock = lockdebug.make_lock("prefetch_claim")
        self._depth_sampler = _DepthSampler(_Q_DECODE, "decode")

        def worker() -> None:
            while not self._stop.is_set():
                with self._claim_lock:
                    idx = self._next
                    if idx >= self._n:
                        return
                    self._next = idx + 1
                q = self._queues[idx]
                try:
                    src = iter(self._factories[idx]())
                    while True:
                        with profiling.maybe_span("prefetch:decode"):
                            item = next(src, _EXHAUSTED)
                        if item is _EXHAUSTED:
                            break
                        _put_until_stop(q, item, self._stop)
                        if self._stop.is_set():
                            return
                except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
                    self._errs[idx] = exc
                _put_until_stop(q, _SENTINEL, self._stop)

        self._threads = [threading.Thread(target=worker, daemon=True)
                         for _ in range(max(1, min(workers, self._n)))]
        for t in self._threads:
            t.start()

    def __iter__(self) -> Iterator[Any]:
        for idx, q in enumerate(self._queues):
            while True:
                if tm.enabled():
                    self._depth_sampler.sample(q.qsize())
                    t0 = time.perf_counter()
                    item = q.get()
                    _WAIT_CONSUMER.inc(time.perf_counter() - t0)
                else:
                    item = q.get()
                if item is _SENTINEL:
                    err, self._errs[idx] = self._errs[idx], None
                    if err is not None:
                        raise err
                    break
                yield item

    def close(self) -> None:
        """Abandon every stream. Blocks until every worker has exited (they
        own native readers whose teardown must not race the caller's)."""
        self._stop.set()
        with self._claim_lock:
            self._next = self._n  # no new claims
        _drain_join(self._queues, self._threads)

    def __enter__(self) -> "MultiSegmentPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def to_host(x) -> np.ndarray:
    """An array on the host: tensors are fetched (a device tensor's fetch
    waits for the computation that produced it), arrays pass."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class AsyncWriter:
    """Background writeback onto a `VideoWriter`: `put` enqueues a chunk of
    stacked planes ([T, H, W] per plane, host arrays or tensors on any
    device — device tensors are fetched on the writer thread so the main
    loop never blocks on a copy); the worker hands whole chunks to the
    writer's batched encode (one native crossing) when it has one, else
    writes frame by frame. `close()` drains the queue, closes the writer,
    and re-raises any worker error.

    `put(..., recycle=blocks)` returns the given pooled host blocks to
    `pool` (default: bufpool.DEFAULT_POOL) AFTER the chunk is encoded: the
    fetch of the device outputs waits for the computation that consumed
    those blocks, so this is the earliest point their reuse is provably
    safe (a CPU tensor made with torch.from_numpy aliases its block).

    `fetch` maps each plane to a host array on the writer thread
    (default `to_host`)."""

    def __init__(self, writer, depth: int = 4, pool=None, fetch=None) -> None:
        from ..io import bufpool

        self._writer = writer
        fetch = fetch or to_host
        self._pool = pool or bufpool.DEFAULT_POOL
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        _register_queue("encode", self._q)
        self._err: Optional[BaseException] = None
        #: seconds the worker spent fetching and encoding (writeback time)
        self.busy_s = 0.0

        def worker() -> None:
            write_batch = getattr(self._writer, "write_batch", None)
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    return
                chunk, recycle = item
                if self._err is not None:
                    # drain without writing after a failure; recycle blocks
                    # are dropped, not released: their consuming
                    # computation was never waited for
                    continue
                try:
                    t0 = time.perf_counter()
                    with profiling.maybe_span("writeback:encode"):
                        planes = [fetch(p) for p in chunk]
                        if write_batch is not None:
                            write_batch(*planes)
                        else:
                            for i in range(planes[0].shape[0]):
                                self._writer.write(*(p[i] for p in planes))
                    self.busy_s += time.perf_counter() - t0
                    # outputs are on the host now, so any computation that
                    # read the recycled input blocks has completed
                    if recycle:
                        self._pool.release(*recycle)
                    if tm.enabled():
                        tm.FRAMES_ENCODED.inc(planes[0].shape[0])
                        tm.BYTES_ENCODED.inc(sum(p.nbytes for p in planes))
                except BaseException as exc:  # noqa: BLE001 - re-raised in close
                    self._err = exc

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._depth_sampler = _DepthSampler(_Q_ENCODE, "encode")

    def put(self, planes_chunk, recycle=None) -> None:
        if self._err is not None:
            self._finish()
        item = (list(planes_chunk), list(recycle) if recycle else None)
        if tm.enabled():
            self._depth_sampler.sample(self._q.qsize())
            t0 = time.perf_counter()
            self._q.put(item)
            _WAIT_PRODUCER.inc(time.perf_counter() - t0)
        else:
            self._q.put(item)

    def write_audio(self, samples: np.ndarray) -> None:
        """Audio goes straight through (written once, before video)."""
        self._writer.write_audio(samples)

    def _finish(self) -> None:
        self._q.put(_SENTINEL)
        self._thread.join()
        self._writer.close()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self._finish()

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:  # don't mask the original error; still stop the thread
            try:
                self.close()
            except Exception:
                pass


def iter_plane_chunks(reader, chunk: int = 64, pool=None) -> Iterator[list[np.ndarray]]:
    """Stream a `VideoReader` as per-plane [T, H, W] stacks of up to
    `chunk` frames without materializing the whole clip: each chunk is
    decoded through ONE native crossing into pooled blocks (hand them back
    with `AsyncWriter.put(..., recycle=chunk)`). Any other iterable of
    Frames is stacked frame by frame."""
    it = getattr(reader, "iter_chunks", None)
    if it is not None:
        chunks = it(chunk, pool=pool)
    else:
        from ..io.video import iter_stacked_frame_chunks

        chunks = iter_stacked_frame_chunks(reader, chunk)
    for planes in chunks:
        if tm.enabled():
            tm.FRAMES_DECODED.inc(planes[0].shape[0])
        yield planes


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
