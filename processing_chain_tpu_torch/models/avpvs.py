"""AVPVS model — the p03 pixel-domain core (port of
processing_chain_tpu/models/avpvs.py: CHUNK/chunk_frames :47-78,
`_decode_workers` :80-91, the canvas geometry and writeback knobs
:93-257, `_ffv1_writer` :260-297, `_segment_canvas_chunks` :300-321, the
short path's `_short_rate_chunks`, `_decode_stereo` and
`_short_segment_audio` :324-367, the SI/TI sidecar :370-432, the
wo_buffer plan and provenance :435-501, `_pump_ready` :504-534,
`_render_wo_buffer` and `create_avpvs_wo_buffer` :537-643 with the
fused fan-out's hooks, and the stalling pass: SPINNER_KINEMATICS,
`load_spinner`, `insert_stall_silence`, `make_stall_compositor` and
`apply_stalling` :1069-1331).

Short tests: decode the single encoded segment → per chunk, host→device
copy (double-buffered, parallel/pipeline.iter_device_ahead) → bicubic
resize of Y, U and V to the AVPVS canvas (models/frames.scale_yuv_frames)
→ round and saturate to the container depth (quantize_device) → per-frame
SI and TI of the quantized luma, TI carried across chunk edges
(SiTiAccumulator) → FFV1 (+FLAC) AVI on the writer thread
(engine/prefetch.AsyncWriter). Long tests: every segment is decoded onto
the canvas time grid (`_segment_canvas_chunks`), several at once
(engine/prefetch.MultiSegmentPrefetcher), and the chained stream takes
the same device path, TI carried across the segment joins, beside the
SRC's stereo audio over the PVS's duration. The stalling pass re-reads
that AVPVS and composites a spinner (or freezes frames) on the device
(`pump_stalled`), with silence inserted into the audio of a stall.
With a fan-out (models/fused.FusedFanout, PC_FUSE_P04) the quantized
chunks also feed the stalling pass and every CPVS render on the device,
so neither decodes the AVPVS again.
"""

from __future__ import annotations

import os
import threading
import time
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..config.domain import Pvs
from ..engine import prefetch as pfe
from ..engine.jobs import Job
from ..io import medialib
from ..io.video import VideoReader, VideoWriter
from ..ops import overlay as ov
from ..ops import siti as siti_ops
from ..parallel.pipeline import iter_device_ahead
from ..store import keys as store_keys
from ..utils import fsio
from ..utils.device import resolve_device
from ..utils.log import get_logger
from . import frames as fr

CHUNK = 64  # frames per device batch (accelerator default; see chunk_frames)

DEFAULT_SPINNER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "spinner-128-white.png",
)


class RenderTotals:
    """Seconds and frames of a stage's renders in this process, by part:
    the decode threads' (summed over threads), the device work's (CUDA
    events on a card) and the writer threads' (fetch, encode; summed over
    writers). A stage reports the deltas of its own run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals = {"decode_s": 0.0, "device_s": 0.0, "writeback_s": 0.0, "frames": 0}

    def add(self, **parts) -> None:
        with self._lock:
            for k, v in parts.items():
                self._totals[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._totals)


#: p03's renders: wo_buffer renders with their fan-outs, and stall passes
RENDER_TOTALS = RenderTotals()


def _timed(items, seconds: list):
    """`items`, adding the seconds each next() takes to seconds[0] (on
    the thread that pulls it: the decode time)."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        seconds[0] += time.perf_counter() - t0
        if item is None:
            return
        yield item


class DeviceTimer:
    """Seconds of the device work of the calls it wraps: CUDA events
    around each call on a card (read once, by `seconds()`), the host
    clock elsewhere."""

    def __init__(self, device=None) -> None:
        self._cuda = resolve_device(device).type == "cuda"
        self._pairs: list = []
        self._host_s = 0.0

    def wrap(self, fn):
        def timed(*args, **kwargs):
            if self._cuda:
                ends = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                ends[0].record()
                out = fn(*args, **kwargs)
                ends[1].record()
                self._pairs.append(ends)
                return out
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._host_s += time.perf_counter() - t0
            return out

        return timed

    def seconds(self) -> float:
        if self._pairs:
            self._pairs[-1][1].synchronize()
        return self._host_s + sum(a.elapsed_time(b) for a, b in self._pairs) / 1000.0


def _env_int(name: str) -> Optional[int]:
    """Integer env knob, loudly rejected on a typo; None when unset/empty."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None


def chunk_frames(device=None) -> int:
    """Effective frames per pipeline chunk. PC_CHUNK_FRAMES pins it;
    default CHUNK (64) on a CUDA device (launch efficiency and transfer
    amortization dominate), 16 on the CPU, where the decode → compute →
    encode pipeline only overlaps at chunk granularity."""
    # plan-exempt: (chunk granularity batches the identical frame stream; pinned by the batch-vs-single parity tests)
    pinned = _env_int("PC_CHUNK_FRAMES")
    if pinned is not None:
        return max(1, pinned)
    return CHUNK if resolve_device(device).type == "cuda" else 16


def _decode_workers() -> int:
    """Concurrent segment decoders for the long path
    (engine/prefetch.MultiSegmentPrefetcher). Default 2: decode overlaps
    the segment joins with bounded memory; PC_DECODE_WORKERS raises it
    where host decode feeds the card too slowly, and 1 decodes the
    segments strictly one after another."""
    try:
        # plan-exempt: (prefetch width; MultiSegmentPrefetcher preserves segment order, identical stream at any width)
        return max(1, int(os.environ.get("PC_DECODE_WORKERS", "2")))
    except ValueError:
        return 2


def avpvs_dimensions(pvs: Pvs, post_proc_id: int = 0) -> tuple[int, int]:
    """(width, height) of the AVPVS canvas: aspect-aware dims vs the
    post-processing coding size, overridden upward when the encoded segment
    is taller (reference create_avpvs_short :976-986).

    Documented deviation: the reference feeds the SRC's CODED dims into
    this math (stream_info['coded_width'/'coded_height'], :975-976) — for
    a non-mod-16 h264 master (e.g. 1920x1080, coded 1920x1088) that
    distorts the canvas aspect. We use the display dims; for the usual
    lossless (FFV1/rawvideo) masters the two are identical. Interop of
    the sidecars carrying both is oracle-tested
    (tests/test_reference_oracle.py::test_src_sidecar_interop_with_reference)."""
    pp = pvs.test_config.post_processings[post_proc_id]
    w, h = fr.calculate_avpvs_video_dimensions(
        pvs.src.stream_info["width"],
        pvs.src.stream_info["height"],
        pp.coding_width,
        pp.coding_height,
    )
    ql = pvs.segments[0].quality_level
    if ql.height > h:
        w, h = ql.width, ql.height
    return w, h


def canvas_fps(pvs: Pvs, avpvs_src_fps: bool = False) -> float:
    """AVPVS canvas frame rate: 60 by default, SRC fps with -z
    (reference create_avpvs_segment :1030-1033, p03 flags)."""
    return pvs.src.get_fps() if avpvs_src_fps else 60.0


def avpvs_codec() -> str:
    """AVPVS intermediate codec: `ffv1` (reference parity, default) or
    `rawvideo` (PC_AVPVS_CODEC=rawvideo: a cheaper lossless intermediate
    for hosts where FFV1 compression — not decode or device work — is the
    p03 bottleneck; ~6x the disk footprint, near-memcpy writeback).
    Decoded frames are identical either way; provenance records which
    codec produced each artifact."""
    codec = os.environ.get("PC_AVPVS_CODEC", "ffv1").strip().lower()
    if codec not in ("ffv1", "rawvideo"):
        raise ValueError(
            f"PC_AVPVS_CODEC={codec!r}: expected 'ffv1' or 'rawvideo'"
        )
    return codec


def effective_avpvs_codec(pix_fmt: str) -> str:
    """The codec that will actually be written for this pix_fmt: the
    requested intermediate codec, except that 10-bit rawvideo degrades to
    ffv1 (`_ffv1_writer`'s AVI-fourcc fallback). Provenance and plan
    payloads record THIS, so artifacts stay attributable to the encoder
    that really produced them."""
    codec = avpvs_codec()
    if codec == "rawvideo" and "10" in pix_fmt:
        return "ffv1"
    return codec


def ffv1_workers() -> int:
    """Frame-parallel FFV1 encoder contexts (native/media.cpp fp mode).
    PC_FFV1_WORKERS=N pins it; default: one worker per spare core, capped
    at 8 (0 on a 1-2 core host — the pool only adds queue overhead when
    there is no core for it to run on). The p03 stage refines the default
    to (spare cores)/(job-pool width) so `-p` runs don't oversubscribe
    (stages/p03_generate_avpvs). FFV1 is intra-only, so frames encode
    independently on private contexts and scale with cores where slice
    threading (the reference's `-threads 4`, lib/ffmpeg.py:1047) tops
    out at slices-per-frame."""
    # plan-exempt: (worker count schedules whole-frame encodes; the slices=0 regime it selects is recorded as ffv1_slices in the plan)
    raw = os.environ.get("PC_FFV1_WORKERS", "").strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            # loud, like PC_AVPVS_CODEC: a typo'd value silently running
            # serial would erase the advertised scaling with no signal
            raise ValueError(
                f"PC_FFV1_WORKERS={raw!r}: expected an integer"
            ) from None
    ncpu = os.cpu_count() or 1
    return 0 if ncpu <= 2 else min(ncpu - 1, 8)


def set_default_fp_workers(pool_width: int) -> None:
    """Install the POOL-AWARE fp-worker default into the env (no-op when
    PC_FFV1_WORKERS is already pinned by the operator or a flag):
    `pool_width` concurrent jobs each opening (cores-1) contexts would
    oversubscribe the host, so the spare cores are divided across the
    pool. Called by the p03 stage."""
    # plan-exempt: (presence probe for the pool-aware default; the byte-relevant outcome is the recorded ffv1_slices)
    if "PC_FFV1_WORKERS" not in os.environ:
        ncpu = os.cpu_count() or 1
        per_job = (ncpu - 1) // max(1, pool_width) if ncpu > 2 else 0
        # plan-exempt: (the pool-aware default; the worker count does not alter encoded bytes)
        os.environ["PC_FFV1_WORKERS"] = str(max(0, min(per_job, 8)))
    # plan-exempt: (presence probe for the pool-aware default; the byte-relevant outcome is the recorded ffv1_slices)
    if "PC_FFV1_THREADS" not in os.environ:
        # the serial writers' slice-threading default must also divide
        # across the pool
        ncpu = os.cpu_count() or 1
        # plan-exempt: (the pool-aware default; its slice effect is the recorded ffv1_slices)
        os.environ["PC_FFV1_THREADS"] = str(max(1, ncpu // max(1, pool_width)))


#: slice counts the FFV1 encoder accepts (ffv1enc slice tiling table)
FFV1_SLICE_COUNTS = (4, 6, 9, 12, 16, 24, 30)


def ffv1_coding_threads() -> int:
    """Slice-threading width for serial (non-fp) FFV1 writes. Default:
    one per core (the reference pins `-threads 4`, lib/ffmpeg.py:1047 —
    which WASTES cores above 4 and oversubscribes below);
    PC_FFV1_THREADS pins it."""
    # plan-exempt: (thread count does not alter encoded bytes; its effect on the default slice count is captured by the recorded ffv1_slices)
    pinned = _env_int("PC_FFV1_THREADS")
    if pinned is not None:
        return max(1, pinned)
    return os.cpu_count() or 1


def ffv1_slices(threads: int) -> int:
    """Slices per FFV1 frame: the smallest count the encoder accepts that
    keeps every slice thread busy (slice threading tops out at
    slices-per-frame). PC_FFV1_SLICES pins it (must be a valid count)."""
    pinned = _env_int("PC_FFV1_SLICES")
    if pinned is not None:
        if pinned not in FFV1_SLICE_COUNTS:
            raise ValueError(
                f"PC_FFV1_SLICES={pinned}: ffv1 accepts {FFV1_SLICE_COUNTS}"
            )
        return pinned
    for s in FFV1_SLICE_COUNTS:
        if s >= threads:
            return s
    return FFV1_SLICE_COUNTS[-1]


def ffv1_effective_coding() -> dict:
    """The FFV1 writeback configuration `_ffv1_writer` will actually use,
    resolved once so the writer, the plan payload and store provenance
    cannot drift. The SLICE layout shapes the bitstream (decoded frames
    stay identical), so the effective slice count is part of every
    ffv1-writing plan hash via `ffv1_effective_slices` — the store
    serves BYTES by plan hash, and two slice layouts are two byte
    streams (store/plan_schema.py). Thread and fp-worker counts only
    parallelize the layout the plan already records; they stay out of
    the hash and land in provenance for attributability."""
    workers = ffv1_workers()
    if workers > 0:
        return {"fp_workers": workers, "threads": 1, "slices": 0}
    threads = ffv1_coding_threads()
    return {"fp_workers": 0, "threads": threads,
            "slices": ffv1_slices(threads)}


def ffv1_effective_slices() -> int:
    """The byte-relevant projection of the writeback knobs, for plan
    payloads: the slice layout `_ffv1_writer` will emit (0 = the
    frame-parallel single-slice regime). PC_FFV1_SLICES and the
    PC_FFV1_THREADS-derived default both flow into cache keys through
    THIS value — fold it into any plan whose artifact is FFV1-encoded."""
    return ffv1_effective_coding()["slices"]


def _ffv1_writer(path: str, w: int, h: int, pix_fmt: str, rate: float,
                 with_audio: bool, sample_rate: int = 48000,
                 audio_codec: str = "pcm_s16le") -> VideoWriter:
    frac = Fraction(rate).limit_denominator(1001)
    audio = dict(audio_codec=audio_codec, sample_rate=sample_rate, channels=2) if with_audio else {}
    if avpvs_codec() == "rawvideo":
        if "10" in pix_fmt:
            # AVI has no fourcc for planar 10-bit rawvideo: every later
            # read would decode garbage. FFV1 carries 10-bit losslessly.
            get_logger().warning(
                "%s: rawvideo cannot carry 10-bit %s in AVI (no fourcc; "
                "reads back as garbage) — falling back to ffv1",
                path, pix_fmt,
            )
        else:
            return VideoWriter(path, "rawvideo", w, h, pix_fmt,
                               (frac.numerator, frac.denominator), **audio)
    # FFV1 level 3 + slicecrc stream integrity (reference :1047: -level 3
    # -coder 1 -context 1 -slicecrc 1). Serial writes get slice threading
    # sized to the thread count; with fp workers, parallelism moves from
    # slices to whole frames (gop=1) and per-context threading drops to 1.
    eff = ffv1_effective_coding()
    opts = "level=3:coder=1:context=1:slicecrc=1"
    if eff["fp_workers"] > 0:
        opts += f":pc_fp_workers={eff['fp_workers']}"
    else:
        opts += f":slices={eff['slices']}"
    return VideoWriter(path, "ffv1", w, h, pix_fmt, (frac.numerator, frac.denominator),
                       threads=eff["threads"], opts=opts, **audio)


def _frames_as_tensors(reader):
    """A reader's Frames as `.planes` CPU tensors (no copy): the frame
    interface of the port's streaming gathers."""
    for frame in reader:
        yield pfe.ChunkFrame([torch.from_numpy(p) for p in frame.planes])


def _segment_canvas_chunks(seg, rate: float, device=None):
    """Decode one encoded segment and yield [T, H, W] plane chunks (CPU
    tensors) on the canvas time grid: exactly round(duration * rate)
    frames, trailing outputs repeating the last decoded frame (the
    reference's nullsrc-canvas semantics, lib/ffmpeg.py:1037-1038).
    Never holds more than one chunk of decoded frames; `device` is the
    render's, which sets the chunk length."""
    with VideoReader(seg.file_path) as reader:
        seg_fps = reader.fps
        n_out = int(round(seg.duration * rate))
        got_any = False
        for chunk in pfe.stream_monotonic_gather(
            _frames_as_tensors(reader),
            lambda k: int(np.floor(k / rate * seg_fps + 0.5)),
            n_out,
            chunk_frames(device),
        ):
            got_any = True
            yield chunk
    # a segment whose duration rounds to zero canvas frames yields
    # nothing; only a frameless source is an error
    if not got_any and n_out > 0:
        raise medialib.MediaError(f"no frames in segment {seg.file_path}")


def _short_rate_chunks(pvs: Pvs, reader: VideoReader, avpvs_src_fps: bool,
                       force_60_fps: bool, device=None):
    """(canvas rate, decoded chunk stream) for the short path: native
    segment frame rate unless -z/-f60 (reference create_avpvs_short
    :940-1000)."""
    seg_fps = reader.fps
    rate = pvs.src.get_fps() if avpvs_src_fps else (60.0 if force_60_fps else seg_fps)
    chunk = chunk_frames(device)
    chunks = (
        pfe.stream_fps_resample(_frames_as_tensors(reader), seg_fps, rate, chunk)
        if rate != seg_fps
        else pfe.iter_plane_chunks(reader, chunk)
    )
    return rate, chunks


def _decode_stereo(path: str, start: float = 0.0, duration: float = 0.0):
    """(samples[n, 2] int16, rate): decode with libswresample's stereo
    remix — the ffmpeg `-ac 2` the reference applies in audio_mux
    (lib/ffmpeg.py:1284)."""
    return medialib.decode_audio_s16(path, start, duration, channels=2)


def _short_segment_audio(seg):
    """The short path carries the encoded segment's audio into the AVPVS
    as FLAC (reference create_avpvs_short's `-c:a flac`,
    lib/ffmpeg.py:995). (samples, rate) or (None, rate)."""
    try:
        samples, srate = _decode_stereo(seg.file_path)
    except medialib.MediaError as exc:
        # no-audio-stream and decode-failure are one exception type; the
        # warning keeps a real failure from silently shipping an
        # audio-less AVPVS
        get_logger().warning("%s: no audio carried into AVPVS (%s)", seg.filename, exc)
        return None, 48000
    if samples.size == 0:
        return None, srate
    return samples, srate


def _wo_buffer_out_path(pvs: Pvs) -> str:
    return (
        pvs.get_avpvs_wo_buffer_file_path()
        if pvs.has_buffering()
        else pvs.get_avpvs_file_path()
    )


def _wo_buffer_plan(
    pvs: Pvs, w: int, h: int, pix_fmt: str,
    avpvs_src_fps: bool, force_60_fps: bool, device=None,
) -> dict:
    """Plan payload for the wo_buffer render: encoded segment digests,
    the SRC (long tests mux its audio), canvas geometry, and every
    byte-affecting knob — the effective codec, its slice layout (FFV1
    bitstream structure; store/plan_schema.py) and the resize-method
    identity. fp-worker and thread COUNTS stay out: they parallelize
    the recorded layout without changing the bytes (plan-exempt).
    `device` is the render's device (`None` means `cuda:0`): the port's
    resize identity names the tensor route it takes there."""
    from ..ops import resize as resize_ops

    tc = pvs.test_config
    codec = effective_avpvs_codec(pix_fmt)
    return {
        "op": "avpvs_wo_buffer",
        "segments": [store_keys.file_ref(s.file_path) for s in pvs.segments],
        "src_audio": (
            store_keys.file_ref(pvs.src.file_path) if tc.is_long() else None
        ),
        "canvas": [w, h],
        "pix_fmt": pix_fmt,
        "codec": codec,
        "ffv1_slices": ffv1_effective_slices() if codec == "ffv1" else None,
        "resize": resize_ops.plan_resize_method(device),
        "rate": {
            "avpvs_src_fps": bool(avpvs_src_fps),
            "force_60_fps": bool(force_60_fps),
        },
        "durations": [float(s.get_segment_duration()) for s in pvs.segments]
        if tc.is_long() else None,
    }


def _wo_buffer_provenance(pvs: Pvs, w: int, h: int, pix_fmt: str) -> dict:
    codec = effective_avpvs_codec(pix_fmt)
    if codec == "ffv1":
        # record the EFFECTIVE codec-threading knobs (fp workers, slice
        # threading, slices): they shape the byte stream, so an artifact
        # must stay attributable to the writer configuration that
        # produced it — while plan hashes keep tracking semantic content
        # only (decoded frames are identical across these knobs)
        eff = ffv1_effective_coding()
        tuning = (
            f"fp_workers={eff['fp_workers']}" if eff["fp_workers"]
            else f"threads={eff['threads']},slices={eff['slices']}"
        )
        codec_desc = f"ffv1(level3,slicecrc,{tuning})"
    else:
        codec_desc = "rawvideo"
    return {
        "pvs": pvs.pvs_id,
        "pipeline": {
            "canvas": [w, h],
            "pix_fmt": pix_fmt,
            "segments": [s.filename for s in pvs.segments],
            "codec": codec_desc,
        },
    }


def siti_sidecar_path(avpvs_path: str) -> str:
    """Per-frame feature sidecar written by the p03 device pass."""
    return avpvs_path + ".siti.csv"


class SiTiAccumulator:
    """Per-frame SI/TI of the upscaled luma, computed on the device during
    the AVPVS render while the frames are already there, so downstream
    consumers read a sidecar instead of decoding the AVPVS again. Features
    are computed on the QUANTIZED luma (container bit depth): exactly what
    a tool decoding the file would see. TI[0] = 0; TI carries across chunk
    boundaries."""

    def __init__(self) -> None:
        # device tensors until write(): the [T]-sized features must not
        # force a device->host sync inside the pump loop
        self.si: list = []
        self.ti: list = []
        self._prev = None  # last quantized luma frame of the previous chunk

    def update(self, y_quant) -> None:
        self.si.append(siti_ops.si_frames(y_quant))
        ti, self._prev = siti_ops.ti_frames_continued(y_quant, self._prev)
        self.ti.append(ti)

    def extend(self, si, ti) -> None:
        """Batch-path entry: features already computed by the wave step
        (numpy arrays or tensors)."""
        self.si.append(si)
        self.ti.append(ti)

    def write(self, avpvs_path: str) -> Optional[str]:
        if not self.si:
            return None
        path = siti_sidecar_path(avpvs_path)
        si = np.concatenate([pfe.to_host(s) for s in self.si])
        ti = np.concatenate([pfe.to_host(t) for t in self.ti])

        # atomic: an interrupted write must never leave a truncated
        # sidecar next to a complete AVPVS
        def _write(tmp: str) -> None:
            with open(tmp, "w") as f:
                f.write("frame,si,ti\n")
                for k, (s, t) in enumerate(zip(si, ti)):
                    f.write(f"{k},{s:.6f},{t:.6f}\n")

        fsio.atomic_write(path, _write)
        return path

    @staticmethod
    def discard(avpvs_path: str) -> None:
        """Remove a (possibly stale) sidecar: called before re-rendering
        and on render failure, so a sidecar can never describe an AVPVS
        from a different render."""
        p = siti_sidecar_path(avpvs_path)
        if os.path.isfile(p):
            os.unlink(p)


def pump_ready(ready, writer, feat: SiTiAccumulator, h: int, w: int,
               pix_fmt: str, device=None, tap=None, timer: Optional[DeviceTimer] = None) -> int:
    """Host chunks (lists of [T, H, W] Y, U, V planes) → device resize to
    the h×w canvas (+ SI/TI features) → `writer.put(planes, recycle=chunk)`
    with `planes` the quantized device tensors; the writer owns their
    device→host fetch. Copies are double-buffered (iter_device_ahead):
    chunk k+1's copy is issued while chunk k's compute is queued.

    With `tap` set (the fused p04 fan-out, models/fused) the same device
    tensors go on to the tap after the writer. On the CPU they may alias
    the pooled host block (a same-size resize passes it through), which
    the tap may still hold, so there the blocks are not recycled.
    `timer` (a DeviceTimer) times the canvas work. Returns the frames
    rendered."""
    device = resolve_device(device)
    sub = fr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt

    def canvas(dev):
        scaled = fr.scale_yuv_frames(dev, h, w, "bicubic", sub)
        quant = fr.quantize_device(scaled, ten_bit)
        feat.update(quant[0])
        return quant

    if timer is not None:
        canvas = timer.wrap(canvas)
    frames = 0
    for chunk, dev in iter_device_ahead(ready, device):
        quant = canvas(dev)
        frames += int(quant[0].shape[0])
        if tap is None:
            writer.put(quant, recycle=chunk)
        else:
            writer.put(quant, recycle=chunk if device.type == "cuda" else None)
            tap(quant)
    return frames


def _render_wo_buffer(pvs: Pvs, out_path: str, w: int, h: int, pix_fmt: str,
                      avpvs_src_fps: bool, force_60_fps: bool, feat: SiTiAccumulator,
                      device=None, fanout=None) -> None:
    """The decode → device rescale → FFV1(+audio) render body, decoded
    ahead on prefetch threads and encoded on the writer thread. A short
    test renders its single segment at its native frame rate unless
    -z/-f60, with the segment's audio; a long test every segment on the
    canvas time grid, chained in order, with the SRC's stereo audio over
    the PVS's total duration. With `fanout` set (models/fused.
    FusedFanout), `fanout.start(...)` is called once rate and audio are
    known and every quantized chunk goes to its tap after the AVPVS
    writer: one decode of each segment feeds the AVPVS, the stalling pass
    and every CPVS and preview render. Adds its seconds and frames to
    RENDER_TOTALS."""
    decode_s = [0.0]
    timer = DeviceTimer(device)
    if fanout is not None:
        # the fan-out's composite and transforms count as device work
        fanout.timer = timer

    def pump(ready, writer, tap):
        frames = pump_ready(ready, writer, feat, h, w, pix_fmt, device, tap, timer)
        RENDER_TOTALS.add(frames=frames)
        if fanout is not None:
            # flush the fan-out's tails (timed); its commits come with close()
            fanout.finish_streams()

    try:
        if pvs.test_config.is_short():
            seg = pvs.segments[0]
            audio, srate = _short_segment_audio(seg)
            with VideoReader(seg.file_path) as reader:
                rate, chunks = _short_rate_chunks(pvs, reader, avpvs_src_fps, force_60_fps,
                                                  device)
                tap = fanout.start(rate, audio, srate, w, h, pix_fmt) if fanout else None
                with pfe.AsyncWriter(_ffv1_writer(
                    out_path, w, h, pix_fmt, rate, with_audio=audio is not None,
                    sample_rate=srate, audio_codec="flac",
                )) as writer:
                    if audio is not None:
                        writer.write_audio(audio)
                    with pfe.Prefetcher(_timed(chunks, decode_s), depth=2) as pre:
                        pump(pre, writer, tap)
                RENDER_TOTALS.add(writeback_s=writer.busy_s)
            return
        rate = canvas_fps(pvs, avpvs_src_fps)
        total = float(sum(s.get_segment_duration() for s in pvs.segments))
        samples, srate = _decode_stereo(pvs.src.file_path, 0.0, total)
        tap = fanout.start(rate, samples, srate, w, h, pix_fmt) if fanout else None
        with pfe.AsyncWriter(_ffv1_writer(
            out_path, w, h, pix_fmt, rate, with_audio=True, sample_rate=srate,
        )) as writer:
            writer.write_audio(samples)
            seg_s = [[0.0] for _ in pvs.segments]
            factories = [(lambda s=seg, t=t: _timed(_segment_canvas_chunks(s, rate, device), t))
                         for seg, t in zip(pvs.segments, seg_s)]
            with pfe.MultiSegmentPrefetcher(factories, workers=_decode_workers(),
                                            depth=2) as pre:
                pump(pre, writer, tap)
            decode_s[0] += sum(t[0] for t in seg_s)
        RENDER_TOTALS.add(writeback_s=writer.busy_s)
    finally:
        RENDER_TOTALS.add(decode_s=decode_s[0], device_s=timer.seconds())


def create_avpvs_wo_buffer(pvs: Pvs, avpvs_src_fps: bool = False,
                           force_60_fps: bool = False, device=None,
                           fanout=None) -> Optional[Job]:
    """The decode+rescale(+concat+audio) stage producing the pre-stalling
    AVPVS (or the final one when the HRC has no buffering), on `device`
    (`None` means `cuda:0`). `fanout` (models/fused.FusedFanout) rides
    the same decode to render the stalling pass and every CPVS context in
    the same job (PC_FUSE_P04)."""
    out_path = _wo_buffer_out_path(pvs)
    w, h = avpvs_dimensions(pvs)
    pix_fmt = pvs.get_pix_fmt_for_avpvs()

    def run() -> str:
        SiTiAccumulator.discard(out_path)  # never leave a stale sidecar
        feat = SiTiAccumulator()
        try:
            _render_wo_buffer(pvs, out_path, w, h, pix_fmt, avpvs_src_fps, force_60_fps,
                              feat, device, fanout)
            feat.write(out_path)
        except BaseException:
            if fanout is not None:
                fanout.abort()
            raise
        if fanout is not None:
            # flush and commit the fan-out's artifacts (stalled AVPVS, CPVS
            # contexts, preview) under each member job's plan hash
            fanout.close()
            RENDER_TOTALS.add(writeback_s=fanout.writeback_s())
        return out_path

    return Job(
        label=f"avpvs {pvs.pvs_id}",
        output_path=out_path,
        fn=run,
        logfile_path=pvs.get_logfile_path(),
        plan=_wo_buffer_plan(pvs, w, h, pix_fmt, avpvs_src_fps, force_60_fps, device),
        sidecar_suffixes=(".siti.csv",),
        provenance=_wo_buffer_provenance(pvs, w, h, pix_fmt),
    )


#: Versioned record of the bufferer-kinematics ASSUMPTIONS baked into
#: every spinner-stalled AVPVS. The upstream bufferer's source is not
#: available, so these are pinned, not cited (ops/overlay.py header). If
#: calibration ever lands different constants, BUMP THE VERSION.
SPINNER_KINEMATICS = {
    "version": 1,
    "status": "ASSUMED",
    "rps": 1.0,  # mirrors ops/overlay.plan_stalling's spinner_rps default
    "direction": "clockwise",
    "phase": "continuous-across-events",
    "basis": "bufferer source unreachable offline; "
             "calibrate with tools/bufferer_calibrate",
}


def load_spinner(path: str) -> np.ndarray:
    """Load a spinner image as [H, W, 4] RGBA uint8."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def insert_stall_silence(audio: np.ndarray, srate: int, events) -> np.ndarray:
    """Insert stall-length silence at the wallclock event positions —
    the audio half of the bufferer pass."""
    pieces = []
    cursor = 0
    for t, d in sorted((float(e[0]), float(e[1])) for e in events):
        cut = int(round(t * srate))
        pieces.append(audio[cursor:cut])
        pieces.append(np.zeros((int(round(d * srate)), audio.shape[1]), np.int16))
        cursor = cut
    pieces.append(audio[cursor:])
    return np.concatenate([p for p in pieces if len(p)])


def make_stall_compositor(pix_fmt: str, spinner, skipping: bool,
                          n_rotations: int, device=None, mesh=None):
    """`fn(gathered_planes, stall, black, phase) -> quantized planes` —
    the per-chunk stall composite shared by the staged loop
    (`pump_stalled`) and the fused fan-out (models/fused), on `device`
    (`None` means `cuda:0`). `spinner` is an image path or an [H, W, 4]
    RGBA uint8 array (ignored when skipping); its rotation bank is built
    on the host and kept on the device. Inputs are the gathered Y, U, V
    planes of one output chunk (container dtype, [T, H, W], tensors on
    the device or numpy) and its per-frame plan slices; the planes are
    composited one at a time in f32 and quantized to the container depth.

    With a `mesh` of several slots (parallel/mesh.py; the reference shards
    over every visible device) each chunk is padded to a multiple of the
    slot count by repeating its last frame, composited frame-parallel by
    ops/overlay.make_sharded_stall_renderer and trimmed: the result is the
    single-device route's, and lands on the mesh's first device."""
    device = mesh.device if mesh is not None else resolve_device(device)
    ten_bit = "10" in pix_fmt
    depth_scale = 4.0 if ten_bit else 1.0
    sub_h, sub_w = fr.chroma_subsampling(pix_fmt)
    banks = (None, None, None, None, None)
    if not skipping and spinner is not None:
        rgba = load_spinner(spinner) if isinstance(spinner, str) else np.asarray(spinner)
        bank_yuv, bank_a = ov.prepare_spinner(rgba, n_rotations)
        # spinner bank is on the 8-bit scale; lift for 10-bit AVPVS
        sp_y = bank_yuv[:, 0] * depth_scale
        # chroma bank on the AVPVS chroma grid (420: half both dims,
        # 422: half width only)
        sp_u = bank_yuv[:, 1][:, ::sub_h, ::sub_w] * depth_scale
        sp_v = bank_yuv[:, 2][:, ::sub_h, ::sub_w] * depth_scale
        if (sub_h, sub_w) == (2, 2):
            sa_c = ov.downsample_alpha(bank_a)
        else:
            sa_c = bank_a[:, ::sub_h, ::sub_w]
        banks = tuple(torch.from_numpy(np.ascontiguousarray(b)).to(device)
                      for b in (sp_y, bank_a, sp_u, sp_v, sa_c))
    sp_y, sa, sp_u, sp_v, sa_c = banks
    black_values = (16.0 * depth_scale, 128.0 * depth_scale, 128.0 * depth_scale)
    chroma = (sub_h, sub_w)
    per_plane = (  # (bank, alpha, black value, grid scale)
        (sp_y, sa, black_values[0], (1, 1)),
        (sp_u, sa_c, black_values[1], chroma),
        (sp_v, sa_c, black_values[2], chroma),
    )

    sharded = None
    if mesh is not None and len(mesh.devices) > 1:
        sharded = ov.make_sharded_stall_renderer(mesh, banks, black_values, ten_bit, chroma)
        grain = len(mesh.devices)

    def composite_sharded(gathered, stall, black, phase):
        n = gathered[0].shape[0]
        pad = -n % grain

        def padded(a):
            a = ov.to_device(a, device)
            return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]) if pad else a

        outs = sharded(*(padded(g) for g in gathered),
                       *(padded(np.asarray(m)) for m in (stall, black, phase)))
        return [o[:n] for o in outs]

    def composite(gathered, stall, black, phase):
        if sharded is not None:
            return composite_sharded(gathered, stall, black, phase)
        masks = [ov.to_device(m, device) for m in (stall, black, phase)]
        out = []
        for g, (sp, alpha, bv, gs) in zip(gathered, per_plane):
            f = ov.to_device(g, device).to(torch.float32)
            r = ov.render_core(f, *masks, sp, alpha, bv, chroma, gs)
            # a plane's f32 copies go before the next plane is lifted: a
            # 64-frame 2160p luma plane is 2.1 GB in f32
            del f
            out.append(fr.quantize_device([r], ten_bit)[0])
            del r
        return out

    return composite


def pump_stalled(frames, plan: ov.StallPlan, composite, writer,
                 chunk: int = CHUNK) -> None:
    """The staged stalling loop (the body of the reference's
    `apply_stalling.run`): stream the output timeline — the plan's source
    indices are monotonic nondecreasing (play/freeze/repeat), so one pass
    over `frames` (objects with `.planes`) feeds the gather in
    `chunk`-frame batches on a prefetch thread — composite each batch
    and hand it to `writer.put`."""
    chunks = pfe.stream_monotonic_gather(
        frames, lambda k: int(plan.src_idx[k]), plan.n_out, chunk
    )
    with pfe.Prefetcher(chunks, depth=2) as pre:
        for chunk_no, gathered in enumerate(pre):
            start = chunk_no * chunk
            sel_len = gathered[0].shape[0]
            writer.put(composite(
                gathered,
                plan.stall_mask[start: start + sel_len],
                plan.black_mask[start: start + sel_len],
                plan.phase[start: start + sel_len],
            ))


def apply_stalling(pvs: Pvs, spinner_path: Optional[str] = None, n_rotations: int = 64,
                   device=None) -> Optional[Job]:
    """The bufferer pass (reference p03:216-260): re-render the wo_buffer
    AVPVS with stall insertions (spinner over black frames) or
    frame-freeze skipping, composited on `device` (`None` means
    `cuda:0`).

    A freeze HRC's buffer events are bare durations; the plan and the
    provenance record them as the (media time, duration) pairs
    ops/overlay.plan_stalling lays them out to. The JAX package's
    `apply_stalling` raises on them building its plan (:1302)."""
    if not pvs.has_buffering():
        return None
    in_path = pvs.get_avpvs_wo_buffer_file_path()
    out_path = pvs.get_avpvs_file_path()
    skipping = pvs.has_framefreeze()
    events = pvs.get_buff_events_media_time()
    pairs = [[t, d] for t, d in ov.buff_event_pairs(events)]

    def run() -> str:
        with VideoReader(in_path) as probe_reader:
            rate = probe_reader.fps
            pix_fmt = probe_reader.pix_fmt
            w, hgt = probe_reader.width, probe_reader.height
        # frame count without a decode pass: container metadata, else a
        # packet scan (FFV1 is intra-only: one packet per frame)
        vstreams = [s for s in medialib.probe(in_path)["streams"]
                    if s["codec_type"] == "video"]
        n = int(vstreams[0].get("nb_frames") or 0) if vstreams else 0
        if n <= 0:
            n = len(medialib.scan_packets(in_path, "video")["size"])
        plan = ov.plan_stalling(n, rate, events, skipping=skipping, black_frame=True,
                                n_rotations=n_rotations)
        composite = make_stall_compositor(pix_fmt, spinner_path, skipping, n_rotations,
                                          device=device)
        # audio: decode, insert stall silence at wallclock positions
        audio = None
        srate = 48000
        try:
            # the wo_buffer AVPVS is stereo by construction; channels=2
            # pins the writer contract against a surprise layout
            audio, srate = _decode_stereo(in_path)
        except medialib.MediaError:
            audio = None
        if audio is not None and audio.size and not skipping:
            audio = insert_stall_silence(audio, srate, events)
        decode_s, timer = [0.0], DeviceTimer(device)
        with VideoReader(in_path) as reader, pfe.AsyncWriter(_ffv1_writer(
            out_path, w, hgt, pix_fmt, rate,
            with_audio=audio is not None and audio.size > 0, sample_rate=srate,
        )) as writer:
            if audio is not None and audio.size:
                writer.write_audio(audio)
            pump_stalled(_timed(_frames_as_tensors(reader), decode_s), plan,
                         timer.wrap(composite), writer, chunk_frames(device))
        RENDER_TOTALS.add(decode_s=decode_s[0], device_s=timer.seconds(),
                    writeback_s=writer.busy_s, frames=plan.n_out)
        return out_path

    lf = pvs.get_logfile_path()
    prov = {
        "pvs": pvs.pvs_id,
        "mode": "skipping" if skipping else "spinner-stall",
        # a stall's pairs as the domain gives them, so the provenance log
        # reads as the JAX package's does
        "events": pairs if skipping else events,
    }
    if not skipping:
        prov["spinner_kinematics"] = dict(SPINNER_KINEMATICS, n_rotations=n_rotations)
    # plan: the wo_buffer render is THE input (its digest covers every
    # upstream knob transitively), plus the stall schedule and spinner
    plan = {
        "op": "avpvs_stalling",
        "input": store_keys.file_ref(in_path),
        "events": pairs,
        "mode": "skipping" if skipping else "spinner-stall",
        "spinner": (store_keys.file_ref(spinner_path)
                    if not skipping and spinner_path else None),
        "kinematics": (dict(SPINNER_KINEMATICS, n_rotations=n_rotations)
                       if not skipping else None),
        # requested, not effective: the input's pix_fmt is unknown until
        # run time, so a 10-bit ffv1 fallback over-invalidates on codec
        # flips rather than under-invalidating
        "codec": avpvs_codec(),
        "ffv1_slices": ffv1_effective_slices(),
    }
    return Job(
        label=f"stalling {pvs.pvs_id}",
        output_path=out_path,
        fn=run,
        plan=plan,
        # own provenance file: the wo_buffer render already owns
        # logs/<pvs>.log and a shared path would overwrite it
        logfile_path=(lf[:-4] if lf.endswith(".log") else lf) + "_stalling.log",
        provenance=prov,
    )
