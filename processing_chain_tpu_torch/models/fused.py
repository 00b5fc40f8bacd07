"""The fused p03+p04 route, PC_FUSE_P04 (port of
processing_chain_tpu/models/fused.py: `fused_p04_enabled` :72,
`_StallSchedule` :85-130, `_SkipSchedule` :133-178, `streamed_stall_plan`
:181-208, `StallStream` :211-258, `_ContextPipeline` :264-368,
`_PreviewPipeline` :371-399 and `FusedFanout` :402-710).

Every downstream artifact renders from the quantized AVPVS stream the
device pass already holds, without decoding an artifact again:

    SRC decode ─▶ device resize ─▶ quantized AVPVS chunks (device)
                                       ├─▶ AVPVS writer
                                       ├─▶ StallStream ─▶ stall composite
                                       │        ├─▶ stalled-AVPVS writer
                                       │        └─▶ (final stream)
                                       └─▶ per-PostProcessing CPVS
                                           pipelines + preview

`FanoutStream` is the stream half: in the port the composited chunks stay
on the device and feed the context pipelines from there; only the writers
fetch to the host. The transforms and the composite are the functions
the staged paths run (models/cpvs, models/avpvs.make_stall_compositor);
`StallStream` is an incremental replay of ops/overlay.plan_stalling +
the monotonic gather that needs no frame count up front
(`streamed_stall_plan` holds the two record for record).

`FusedFanout` is the member side for one PVS: its member jobs are the
staged jobs (`apply_stalling`, one `create_cpvs` a context,
`create_preview`), never run, which carry the plan hashes; it opens their
writers, marks their crash sentinels, and commits each under its own
plan hash (`Job.complete_externally`), so a warm run plans nothing and
p04 after a fused p03 plans nothing. A member whose writer fails is
dropped alone (`chain_fused_members_degraded_total`,
`fused_member_degraded`) and left to the staged pass on the same device:
p03's stall pass for the stalled AVPVS, the next p04 for a CPVS. The stall
member is the port's `apply_stalling` job, which takes a freeze HRC
where the JAX package's raises (ROADMAP Queue C).

Not ported: `SegmentOrderedTap` and the batch route's fan-out (ROADMAP
Queue A item 7).
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Callable, Optional

import numpy as np
import torch

from .. import telemetry as tm
from ..engine import prefetch as pfe
from ..engine.jobs import clear_inprogress, mark_inprogress
from ..ops import overlay as ov
from ..utils.log import get_logger
from ..utils.runner import ChainError
from . import avpvs as av
from . import cpvs as cp

_MEMBERS_DEGRADED = tm.counter(
    "chain_fused_members_degraded_total",
    "fused fan-out members aborted mid-stream and left to the staged "
    "partial path",
)


def fused_p04_enabled() -> bool:
    """The PC_FUSE_P04 gate. Routing only: the fused path renders
    decoded-identical artifacts under unchanged plan hashes, so the flag
    never reaches a plan payload."""
    # plan-exempt: (fused-vs-staged CPVS/AVPVS bytes are decoded-identical and plan hashes unchanged; pinned by tests/test_torch_fused_file.py)
    return os.environ.get("PC_FUSE_P04", "").strip().lower() in ("1", "true", "yes", "on")

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


class FanoutStream:
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
                getattr(self._stall_writer, "abort", self._stall_writer.close)()
            except Exception:  # noqa: BLE001 - teardown on the failure path
                pass
        for pipe in self._pipelines:
            pipe.abort()


class _GuardedPipeline:
    """A context or preview pipeline whose failure degrades its member
    alone: the pipeline is aborted, `on_fail(out_path, exc)` drops the
    member, and its later feeds are ignored, while every other member
    keeps streaming."""

    def __init__(self, pipe, out_path: str, on_fail: Callable) -> None:
        self.pipe = pipe
        self.out_path = out_path
        self._on_fail = on_fail
        self.dead = False

    def _guard(self, step: Callable) -> None:
        if self.dead:
            return
        try:
            step()
        except Exception as exc:  # noqa: BLE001 - member containment
            self.dead = True
            self.pipe.abort()
            self._on_fail(self.out_path, exc)

    def feed(self, planes: list) -> None:
        self._guard(lambda: self.pipe.feed(planes))

    def finish(self) -> None:
        self._guard(self.pipe.finish)

    def abort(self) -> None:
        if not self.dead:
            self.pipe.abort()


class _GuardedStallWriter:
    """The stalled-AVPVS writer: a failure drops its member and its
    output, but compositing goes on, since the context pipelines consume
    the composited frames from the device regardless."""

    def __init__(self, writer, out_path: str, on_fail: Callable) -> None:
        self.writer = writer
        self.out_path = out_path
        self._on_fail = on_fail
        self.dead = False

    def _fail(self, exc: BaseException) -> None:
        self.dead = True
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 - teardown on the failure path
            pass
        self._on_fail(self.out_path, exc)

    def put(self, planes: list) -> None:
        if self.dead:
            return
        try:
            self.writer.put(planes)
        except Exception as exc:  # noqa: BLE001 - member containment
            self._fail(exc)

    def close(self) -> None:
        if self.dead:
            return
        try:
            self.writer.close()
        except Exception as exc:  # noqa: BLE001 - member containment
            self._fail(exc)

    def abort(self) -> None:
        if not self.dead:
            try:
                self.writer.close()
            except Exception:  # noqa: BLE001 - teardown on the failure path
                pass


class FusedFanout:
    """The fused p04 fan-out of one PVS. Built by the p03 stage with the
    run's knobs; `start()` is called by the render body once rate and
    audio are known (returns the chunk tap), `feed()` receives every
    quantized AVPVS chunk (device tensors), `finish_streams()` flushes and
    closes the downstream writers, and `close()` commits every member
    artifact under its existing plan hash. `abort()` removes partial
    outputs and clears their crash sentinels. `device` is the render's
    (`None` means `cuda:0`): the member jobs' plans and the stall
    composite are the staged ones on that device."""

    def __init__(self, pvs, *, spinner_path: Optional[str] = None,
                 n_rotations: int = 64, rawvideo: bool = False,
                 nonraw_crf: int = 17, mobile_vprofile: str = "high",
                 mobile_preset: str = "fast", preview: bool = False,
                 device=None) -> None:
        self.pvs = pvs
        self._spinner = spinner_path
        self._n_rot = n_rotations
        self._rawvideo = rawvideo
        self._crf = nonraw_crf
        self._vprofile = mobile_vprofile
        self._preset = mobile_preset
        self._device = device
        self._buffering = pvs.has_buffering()
        self._skipping = pvs.has_framefreeze() if self._buffering else False
        self._events = pvs.get_buff_events_media_time() if self._buffering else []
        self.engaged = False
        self._closed = False
        self._stream: Optional[FanoutStream] = None
        self._pipelines: list = []
        self._writers: list = []
        self._marked: list[str] = []
        #: output path -> error summary of each member that failed: it is
        #: dropped (partial output removed, sentinel cleared, job not
        #: completed) while every healthy member keeps streaming; the
        #: staged pass rebuilds exactly the degraded members
        self.degraded: dict[str, str] = {}
        self._stall_writer: Optional[_GuardedStallWriter] = None
        #: a models/avpvs.DeviceTimer the render sets: the composite and
        #: the member transforms are timed as device work
        self.timer = None
        # member jobs: the staged per-artifact jobs, never run; they carry
        # the plan identity, provenance and commit surface
        self.stall_job = av.apply_stalling(
            pvs, spinner_path=spinner_path, n_rotations=n_rotations, device=device)
        self.cpvs_jobs = [
            cp.create_cpvs(pvs, pp, rawvideo, nonraw_crf, mobile_vprofile, mobile_preset,
                           device=device)
            for pp in pvs.test_config.post_processings
        ]
        self.preview_job = cp.create_preview(pvs, device=device) if preview else None
        outs = [j.output_path for j in self.member_jobs()]
        dups = sorted({o for o in outs if outs.count(o) > 1})
        if dups:
            raise ChainError(
                f"fused p04 fan-out for {pvs.pvs_id}: multiple contexts "
                f"write {dups} — write-write race")

    def member_jobs(self) -> list:
        jobs = [self.stall_job] if self.stall_job is not None else []
        jobs.extend(self.cpvs_jobs)
        if self.preview_job is not None:
            jobs.append(self.preview_job)
        return jobs

    def stall_settled(self) -> bool:
        """True when the staged stall pass has nothing to redo for this
        PVS: there is no stall member, or the fused render carried it to
        completion. False: it degraded, and p03 plans the staged
        `apply_stalling` instead."""
        return self.stall_job is None or self.stall_job.output_path not in self.degraded

    def writeback_s(self) -> float:
        """Seconds the member writers spent fetching and encoding."""
        return sum(w.busy_s for w in self._writers)

    def _writer(self, vw) -> pfe.AsyncWriter:
        w = pfe.AsyncWriter(vw)
        self._writers.append(w)
        return w

    def _mark(self, out: str) -> None:
        mark_inprogress(out)
        self._marked.append(out)

    def start(self, rate: float, audio, srate: int, w: int, h: int,
              pix_fmt: str) -> Callable:
        """Open every downstream writer (audio first, as the staged paths
        do) and return the chunk tap. `rate` is the AVPVS canvas rate,
        rationalized the way its writer muxes it, so the resample
        decisions match what a reader of the artifact would see."""
        fps = avpvs_rate(rate)
        tc = self.pvs.test_config
        self.engaged = True
        chunk = av.chunk_frames(self._device)
        final_audio = audio
        compositor = None
        if self._buffering:
            if audio is not None and audio.size and not self._skipping:
                final_audio = av.insert_stall_silence(audio, srate, self._events)
            stall_out = self.stall_job.output_path
            self._mark(stall_out)
            has_audio = final_audio is not None and final_audio.size > 0
            writer = self._writer(av._ffv1_writer(
                stall_out, w, h, pix_fmt, fps, with_audio=has_audio, sample_rate=srate))
            if has_audio:
                writer.write_audio(final_audio)
            self._stall_writer = _GuardedStallWriter(writer, stall_out, self._drop_member)
            compositor = av.make_stall_compositor(
                pix_fmt, self._spinner, self._skipping, self._n_rot, device=self._device)
            if self.timer is not None:
                compositor = self.timer.wrap(compositor)
        for job, pp in zip(self.cpvs_jobs, tc.post_processings):
            plan = cp.cpvs_plan(self.pvs, pp, h, self._rawvideo, self._crf,
                                self._vprofile, self._preset)
            ctx_audio = None
            if tc.is_long() and final_audio is not None and final_audio.size:
                ctx_audio = cp.trim_normalize_long_audio(
                    final_audio, srate, self.pvs, plan["normalize"])
            self._mark(job.output_path)
            try:
                vw, has_audio = cp.open_cpvs_writer(
                    job.output_path, plan, pp, w, h, cp.cpvs_out_rate(plan, fps),
                    ctx_audio, srate)
                writer = self._writer(vw)
                if has_audio:
                    writer.write_audio(ctx_audio)
                pipe = _ContextPipeline(writer, plan, pp, pix_fmt, fps, self._rawvideo, chunk)
                self._time(pipe)
            except Exception as exc:  # noqa: BLE001 - member containment
                # a member whose writer cannot even open degrades like a
                # mid-stream failure: dropped, siblings unharmed
                self._drop_member(job.output_path, exc)
                continue
            self._pipelines.append(_GuardedPipeline(pipe, job.output_path, self._drop_member))
        if self.preview_job is not None:
            out = self.preview_job.output_path
            self._mark(out)
            try:
                vw, has_audio = cp.open_preview_writer(out, w, h, fps, final_audio, srate)
                writer = self._writer(vw)
                if has_audio:
                    writer.write_audio(final_audio)
                pipe = _PreviewPipeline(writer, pix_fmt)
                self._time(pipe)
                self._pipelines.append(_GuardedPipeline(pipe, out, self._drop_member))
            except Exception as exc:  # noqa: BLE001 - member containment
                self._drop_member(out, exc)
        self._stream = FanoutStream(
            self._pipelines, compositor=compositor, stall_writer=self._stall_writer,
            fps=fps, events=self._events, skipping=self._skipping,
            n_rotations=self._n_rot, chunk=chunk)
        return self.feed

    def _time(self, pipe) -> None:
        if self.timer is not None:
            pipe._transform = self.timer.wrap(pipe._transform)

    def feed(self, planes: list) -> None:
        """One quantized AVPVS chunk (a list of [T, H, W] tensors)."""
        self._stream.feed(planes)

    def _drop_member(self, out: str, exc: BaseException) -> None:
        self.degraded[out] = f"{type(exc).__name__}: {exc}"[:500]
        if out in self._marked:
            self._marked.remove(out)
        if os.path.isfile(out):
            try:
                os.unlink(out)
            except OSError:
                pass
        clear_inprogress(out)
        _MEMBERS_DEGRADED.inc()
        tm.emit("fused_member_degraded", output=os.path.basename(out),
                pvs=self.pvs.pvs_id, error=self.degraded[out])
        live = sum(not p.dead for p in self._pipelines)
        get_logger().warning(
            "fused fan-out %s: member %s aborted mid-stream (%s) — falling back "
            "to the staged partial path; %d member(s) still streaming",
            self.pvs.pvs_id, os.path.basename(out), self.degraded[out], live)

    def finish_streams(self) -> None:
        """Flush the tails and close every downstream writer (idempotent)."""
        if self._stream is not None:
            self._stream.finish_streams()

    def close(self) -> None:
        """Finalize: flush, then commit every member artifact under its
        own plan hash (provenance, store commit, sentinel clear: the tail
        a staged job's run has)."""
        if self._closed:
            return
        try:
            self.finish_streams()
        except BaseException:
            self.abort()
            raise
        self._closed = True
        if not self.engaged:
            return
        for job in self.member_jobs():
            # a degraded member commits nothing: its job stays un-run, so
            # the staged pass sees it as due and rebuilds exactly it
            if job.output_path in self.degraded:
                continue
            job.complete_externally()

    def abort(self) -> None:
        """Failure path: no partial artifact may survive to satisfy a
        later run's skip-existing check."""
        if self._closed:
            return
        self._closed = True
        if self._stream is not None:
            self._stream.abort()
        for out in self._marked:
            if os.path.isfile(out):
                os.unlink(out)
            clear_inprogress(out)
