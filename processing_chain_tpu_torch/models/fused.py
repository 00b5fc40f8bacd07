"""The stall fan-out of the fused p03+p04 driver (trimmed port of
processing_chain_tpu/models/fused.py: `_StallSchedule` :85-130,
`_SkipSchedule` :133-178, `streamed_stall_plan` :181-208, `StallStream`
:211-258, `_ContextPipeline` :264-368, `_PreviewPipeline` :371-399 and
the stream part of `FusedFanout` :561-670).

Every downstream artifact renders from the quantized AVPVS stream the
device pass already holds, without decoding an artifact again:

    quantized AVPVS chunks (device)
        ├─▶ StallStream ─▶ stall composite ─▶ stalled-AVPVS writer
        │                          └─▶ (final stream)
        └─▶ per-PostProcessing CPVS pipelines + preview

In the port the composited chunks stay on the device and feed the
context pipelines from there; only the writers fetch to the host. The
transforms and the composite are the same functions the staged paths run
(models/cpvs, models/avpvs.make_stall_compositor); `StallStream` is an
incremental replay of ops/overlay.plan_stalling + the monotonic gather
that needs no frame count up front (`streamed_stall_plan` holds the two
record for record).

Not ported: the `Pvs`/job/store side of `FusedFanout` (member jobs,
crash sentinels, commits, telemetry, per-member degrade), the writers it
opens and `SegmentOrderedTap`. Writers are passed in: objects with
`put(planes)` and `close()`.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import overlay as ov
from . import cpvs as cp

# ---------------------------------------------------------------- stall replay


class _StallSchedule:
    """plan_stalling's spinner/black insertion mode, replayed
    incrementally: events fire as the source position reaches them,
    with trailing (past-stream-end) events flushed by finish() — the
    min(n, event_frame) clamp of the batch formulation, without
    knowing n up front. emit(src_idx, stall, black, phase)."""

    def __init__(self, fps: float, events, emit: Callable,
                 black_frame: bool = True, spinner_rps: float = 1.0,
                 n_rotations: int = 64) -> None:
        self._fps = float(fps)
        self._events = sorted((float(e[0]), float(e[1])) for e in events)
        self._emit = emit
        self._black = 1 if black_frame else 0
        self._rps = spinner_rps
        self._n_rot = n_rotations
        self._ei = 0
        self._spin = 0
        self._next_src = 0
        #: stall backgrounds are always the previous played frame; no
        #: long-range retention needed (StallStream contract)
        self.anchors: frozenset = frozenset()

    def _emit_stalls(self, ei: int) -> None:
        n_stall = int(round(self._events[ei][1] * self._fps))
        bg = max(0, self._next_src - 1)
        for _ in range(n_stall):
            phase = int(
                self._spin * self._rps * self._n_rot / self._fps
            ) % self._n_rot
            self._emit(bg, 1, self._black, phase)
            self._spin += 1

    def on_source(self, k: int) -> None:
        while self._ei < len(self._events) and int(round(
            self._events[self._ei][0] * self._fps
        )) <= self._next_src:
            self._emit_stalls(self._ei)
            self._ei += 1
        self._emit(self._next_src, 0, 0, 0)
        self._next_src += 1

    def finish(self) -> None:
        while self._ei < len(self._events):
            self._emit_stalls(self._ei)
            self._ei += 1


class _SkipSchedule:
    """plan_stalling's frame-freeze (skipping) mode, replayed
    incrementally. The batch form mutates src_idx sequentially
    (`src_idx[start:end] = src_idx[start]` per event, in the given
    order); `anchors[i]` is the value that assignment reads — the
    array state after events < i — so per-position resolution needs no
    array. Length-preserving: one record per source frame."""

    def __init__(self, fps: float, events, emit: Callable) -> None:
        fps = float(fps)
        self._ranges = [
            (int(round(t * fps)), int(round((t + d) * fps)))
            for t, d in ov.buff_event_pairs(events)  # plan_stalling parity
        ]
        self._emit = emit
        anchors: list[int] = []
        for i, (s, _e) in enumerate(self._ranges):
            v = s
            for j in range(i):
                sj, ej = self._ranges[j]
                if sj <= s < ej:
                    v = anchors[j]
            anchors.append(v)
        self._anchors = anchors
        self.anchors = frozenset(anchors)

    def on_source(self, k: int) -> None:
        v = k
        stall = 0
        for i, (s, e) in enumerate(self._ranges):
            if s <= k < e:
                v = self._anchors[i]
                stall = 1
        self._emit(v, stall, 0, 0)

    def finish(self) -> None:
        pass


def streamed_stall_plan(
    n_frames: int,
    fps: float,
    buff_events: list,
    skipping: bool = False,
    black_frame: bool = True,
    spinner_rps: float = 1.0,
    n_rotations: int = 64,
) -> ov.StallPlan:
    """Run the incremental schedule over `n_frames` sources and return
    the records as a StallPlan — the parity surface tests diff against
    ov.plan_stalling(n_frames, ...) field by field."""
    recs: list[tuple] = []
    emit = lambda *r: recs.append(r)  # noqa: E731 - record capture
    sched = (
        _SkipSchedule(fps, buff_events, emit) if skipping
        else _StallSchedule(fps, buff_events, emit, black_frame=black_frame,
                            spinner_rps=spinner_rps, n_rotations=n_rotations)
    )
    for k in range(n_frames):
        sched.on_source(k)
    sched.finish()
    return ov.StallPlan(
        src_idx=np.array([r[0] for r in recs], np.int32),
        stall_mask=np.array([r[1] for r in recs], np.int8),
        black_mask=np.array([r[2] for r in recs], np.int8),
        phase=np.array([r[3] for r in recs], np.int32),
    )


class StallStream:
    """Bind the incremental schedule to pushed frames: feed() source
    frames in order, receive output records via
    emit(frame_planes, stall, black, phase). Bounded retention: the
    previous frame (stall backgrounds) plus the freeze anchors the
    schedule precomputed — never the whole stream. An anchor is cloned
    when retained, so it does not keep the chunk it is a view of alive."""

    def __init__(self, fps: float, events, skipping: bool, emit: Callable,
                 n_rotations: int = 64) -> None:
        self._emit = emit
        self._sched = (
            _SkipSchedule(fps, events, self._on_record) if skipping
            else _StallSchedule(fps, events, self._on_record,
                                n_rotations=n_rotations)
        )
        self._retain = self._sched.anchors
        self._k = -1
        self._cur = None
        self._prev = None
        self._retained: dict[int, list] = {}

    def feed(self, planes: list) -> None:
        self._k += 1
        self._cur = planes
        if self._k in self._retain:
            self._retained[self._k] = [p.clone() for p in planes]
        self._sched.on_source(self._k)
        self._prev = planes

    def finish(self) -> None:
        # an empty source emits nothing, trailing events included —
        # stream_monotonic_gather parity (no frames, no gather output)
        if self._k >= 0:
            self._sched.finish()

    def _on_record(self, src: int, stall: int, black: int, phase: int) -> None:
        if src == self._k:
            planes = self._cur
        elif src == self._k - 1:
            planes = self._prev
        else:
            planes = self._retained.get(src)
        if planes is None:
            raise RuntimeError(
                f"fused stalling: source frame {src} not retained at "
                f"position {self._k} (schedule/retention bug)"
            )
        self._emit(planes, stall, black, phase)


# ------------------------------------------------------------ fan-out pipelines


class _ContextPipeline:
    """One CPVS render fed from the final-AVPVS stream: optional
    display-rate resample (push-based stream_fps_resample, the same index
    math), the `-t` output cap, the shared per-chunk transform, and the
    writer it is given (`put(planes)`, `close()`)."""

    def __init__(self, writer, plan: dict, pp, pix_fmt: str,
                 avpvs_fps: float, rawvideo: bool, chunk: int) -> None:
        self._transform = cp.make_cpvs_transform(plan, pp, pix_fmt, rawvideo)
        out_rate = cp.cpvs_out_rate(plan, avpvs_fps)
        self._writer = writer
        dst = plan["fps"]
        self._resample = dst is not None and dst != avpvs_fps
        self._src_fps = avpvs_fps
        self._dst_fps = dst
        self._cap = (
            cp.t_cap_frames(plan["t"], out_rate)
            if plan["t"] is not None else None
        )
        self._chunk = chunk
        self._out_n = 0       # output frames emitted (cap accounting)
        self._buf: list = []  # pending frames on the resample path
        self._gather_k = 0    # next output index (resample)
        self._cur = -1        # last source frame index seen
        self._last = None
        self._finished = False

    # -- chunk fast path (no rate change: frames map 1:1)

    def _put_chunk(self, planes: list) -> None:
        if self._cap is not None:
            left = self._cap - self._out_n
            if left <= 0:
                return
            if planes[0].shape[0] > left:
                planes = [p[:left] for p in planes]
        if planes[0].shape[0] == 0:
            return
        self._out_n += planes[0].shape[0]
        self._writer.put(self._transform(planes))

    # -- frame path (display-rate resample)

    def _out_index(self, k: int) -> int:
        # stream_fps_resample's ffmpeg `fps=` index math, verbatim
        return int(np.floor(k / self._dst_fps * self._src_fps + 0.5))

    def _emit_frame(self, planes: list) -> None:
        if self._cap is not None and self._out_n >= self._cap:
            return
        self._out_n += 1
        self._buf.append(planes)
        if len(self._buf) >= self._chunk:
            self._flush_buf()

    def _flush_buf(self) -> None:
        if not self._buf:
            return
        stacked = [torch.stack([f[p] for f in self._buf]) for p in range(3)]
        self._buf = []
        self._writer.put(self._transform(stacked))

    def feed(self, planes: list) -> None:
        if not self._resample:
            self._put_chunk(planes)
            return
        t = planes[0].shape[0]
        for i in range(t):
            frame = [p[i] for p in planes]
            self._cur += 1
            self._last = frame
            while self._out_index(self._gather_k) <= self._cur:
                self._emit_frame(frame)
                self._gather_k += 1

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._resample and self._last is not None:
            # fps= output length: round(n_src / src_fps * dst_fps);
            # past-the-end outputs repeat the last frame (clamp)
            n_out = int(round(
                (self._cur + 1) / self._src_fps * self._dst_fps
            ))
            while self._gather_k < n_out:
                self._emit_frame(self._last)
                self._gather_k += 1
        self._flush_buf()
        self._writer.close()

    def abort(self) -> None:
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - teardown on the failure path
            pass


class _PreviewPipeline:
    """The ProRes preview fed from the final stream (no resample, no
    cap — preview parity with create_preview), into the writer given."""

    def __init__(self, writer, pix_fmt: str) -> None:
        self._transform = cp.make_preview_transform(pix_fmt)
        self._writer = writer
        self._finished = False

    def feed(self, planes: list) -> None:
        self._writer.put(self._transform(planes))

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self._writer.close()

    def abort(self) -> None:
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - teardown on the failure path
            pass


def avpvs_rate(rate: float) -> float:
    """The AVPVS canvas rate rationalized the way its writer muxes it, so
    resample decisions match what a reader of the artifact would see."""
    frac = Fraction(rate).limit_denominator(1001)
    return frac.numerator / frac.denominator


class FusedFanout:
    """The fused fan-out of one PVS's quantized AVPVS stream. `feed()`
    takes every quantized chunk (a list of [T, H, W] Y, U, V tensors);
    with a `compositor` (models/avpvs.make_stall_compositor) the stream
    first goes through `StallStream` at `fps` with the buffer `events`,
    each `chunk` composited records go to `stall_writer` (may be None)
    and on, still on the device, to every pipeline; without one, chunks
    go to the pipelines as they come. `finish_streams()` flushes the
    tails and closes every writer; `abort()` closes them on a failure
    path."""

    def __init__(self, pipelines: list, *, compositor: Optional[Callable] = None,
                 stall_writer=None, fps: Optional[float] = None, events=(),
                 skipping: bool = False, n_rotations: int = 64,
                 chunk: int = 64) -> None:
        self._pipelines = list(pipelines)
        self._compositor = compositor
        self._stall_writer = stall_writer
        self._schunk = chunk
        self._srec: list = []
        self._finished = False
        self._stall_stream = None
        if compositor is not None:
            self._stall_stream = StallStream(
                avpvs_rate(fps), events, skipping,
                emit=self._on_stall_record, n_rotations=n_rotations,
            )

    def feed(self, planes: list) -> None:
        """One quantized AVPVS chunk ([T, H, W] tensors)."""
        if self._stall_stream is None:
            self._feed_final(planes)
            return
        t = planes[0].shape[0]
        for i in range(t):
            frame = [p[i] for p in planes]
            if i == t - 1:
                # the stream keeps the previous frame past this chunk:
                # a clone, not a view that would keep the chunk alive
                frame = [p.clone() for p in frame]
            self._stall_stream.feed(frame)

    def _feed_final(self, planes: list) -> None:
        for pipe in self._pipelines:
            pipe.feed(planes)

    def _on_stall_record(self, frame_planes, stall, black, phase) -> None:
        self._srec.append((frame_planes, stall, black, phase))
        if len(self._srec) >= self._schunk:
            self._flush_stall_chunk()

    def _flush_stall_chunk(self) -> None:
        if not self._srec:
            return
        recs, self._srec = self._srec, []
        gathered = [torch.stack([r[0][p] for r in recs]) for p in range(3)]
        stall = np.array([r[1] for r in recs], np.int8)
        black = np.array([r[2] for r in recs], np.int8)
        phase = np.array([r[3] for r in recs], np.int32)
        outs = self._compositor(gathered, stall, black, phase)
        del gathered
        # the same device tensors go to the stalled writer and to every
        # context pipeline: what a decoder of the stalled artifact would
        # produce (lossless writeback)
        if self._stall_writer is not None:
            self._stall_writer.put(outs)
        self._feed_final(outs)

    def finish_streams(self) -> None:
        """Flush tails and close every downstream writer (idempotent)."""
        if self._finished:
            return
        self._finished = True
        if self._stall_stream is not None:
            self._stall_stream.finish()
            self._flush_stall_chunk()
            if self._stall_writer is not None:
                self._stall_writer.close()
        for pipe in self._pipelines:
            pipe.finish()

    def abort(self) -> None:
        """Failure path: close every writer, ignoring their errors."""
        self._finished = True
        if self._stall_writer is not None:
            try:
                self._stall_writer.close()
            except Exception:  # noqa: BLE001 - teardown on the failure path
                pass
        for pipe in self._pipelines:
            pipe.abort()
