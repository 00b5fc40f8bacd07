"""High-level video decode/encode on top of the port's media boundary
(copy of processing_chain_tpu/io/video.py: `Frame`,
`iter_stacked_frame_chunks`, `VideoReader`, `VideoWriter`).

Frames cross this boundary as numpy planar YUV, the host-side staging
format for the device copy: the ops layer stacks them into [T, H, W]
tensors per plane. The JAX reader's media-fault hooks and deadline guard
(io/faults, ROADMAP item 11) are not carried: every crossing here is a
direct call. The port's buffer pool has no per-frame switch, so
`iter_chunks` and `read_all` always decode chunk-wise.
"""

from __future__ import annotations

import ctypes as ct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import telemetry as tm
from ..utils import lockdebug
from . import bufpool, medialib
from .medialib import MediaError, MPVideoDesc

_IO_BATCH = tm.counter(
    "chain_io_batch_calls_total",
    "chunk-granular native I/O crossings (one GIL release per chunk)",
    ("op",),
)
_IO_BATCH_DECODE = _IO_BATCH.labels(op="decode")
_IO_BATCH_ENCODE = _IO_BATCH.labels(op="encode")
_DECODER_OPENS = tm.counter(
    "chain_io_decoder_opens_total",
    "VideoReader decoder opens — each is one full decode pass over a "
    "container, so the fused chain's 'one decode per SRC' claim "
    "(PC_FUSE_P04, models/fused) is a measurable invariant, not a "
    "code-review assertion",
)
#: the same opens counted whether telemetry is on or off (the p03 stage's
#: summary line reports its own from `decoder_opens()`)
_OPENS_LOCK = lockdebug.make_lock("decoder_opens")
_opens = 0


def decoder_opens() -> int:
    """VideoReader decoder opens in this process so far."""
    with _OPENS_LOCK:
        return _opens


@dataclass
class Frame:
    """One decoded frame: PLANAR planes in native bit depth (uint8 or
    uint16), each [h, w] samples of one component. Packed container
    formats (PACKED_FORMATS) are deinterleaved by VideoReader before a
    Frame is built, so `.y` is always pure luma."""

    planes: tuple[np.ndarray, ...]
    pts: float
    pix_fmt: str

    @property
    def y(self) -> np.ndarray:
        return self.planes[0]

    @property
    def u(self) -> Optional[np.ndarray]:
        return self.planes[1] if len(self.planes) > 1 else None

    @property
    def v(self) -> Optional[np.ndarray]:
        return self.planes[2] if len(self.planes) > 2 else None


def iter_stacked_frame_chunks(frames, chunk: int) -> Iterator[list[np.ndarray]]:
    """Per-frame chunker: accumulate Frames and np.stack each plane into
    [T, H, W] blocks of up to `chunk` (engine.prefetch's generic-iterable
    path, and the per-frame baseline the batched decode is tested
    against)."""
    buf: list = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == chunk:
            yield [np.stack([f.planes[p] for f in buf]) for p in range(len(buf[0].planes))]
            buf = []
    if buf:
        yield [np.stack([f.planes[p] for f in buf]) for p in range(len(buf[0].planes))]


#: single-plane interleaved formats the chain can encounter (the PC CPVS
#: default is uyvy422) mapped to their (y, u, v) byte offsets within each
#: 4-byte macropixel; VideoReader deinterleaves these on read.
PACKED_FORMATS = {
    "uyvy422": (1, 0, 2),   # U Y V Y
    "yuyv422": (0, 1, 3),   # Y U Y V
    "yvyu422": (0, 3, 1),   # Y V Y U
}


class VideoReader:
    """Sequential decoder with [start, start+duration) trim — the native
    replacement for the reference's `ffmpeg -ss X -t D -i …` decode commands
    (lib/ffmpeg.py:877, :948, :1037)."""

    def __init__(self, path: str, start: float = 0.0, duration: float = 0.0,
                 threads: int = 0) -> None:
        """threads: decoder thread_count (0 = auto = one per core)."""
        self.path = path
        self._start = float(start)
        self._window = float(duration)
        #: stream frame cursor — every decode error names the frame it
        #: died at, not just the file
        self._frames_out = 0
        self._h = None
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        self._h = lib.mp_decoder_open_t(path.encode(), start, duration, threads, err, 512)
        if not self._h:
            raise MediaError(f"open {path}: {err.value.decode()}")
        desc = MPVideoDesc()
        if lib.mp_decoder_desc(self._h, ct.byref(desc)) < 0:
            self._fail_open(f"{path}: could not probe decoder geometry")
        self.width = desc.width
        self.height = desc.height
        #: the container/decoder pixel format as probed (e.g. uyvy422)
        self.container_pix_fmt = desc.pix_fmt.decode()
        # packed formats deinterleave at this boundary: every consumer
        # downstream holds a planar contract
        self._packed_offsets = PACKED_FORMATS.get(self.container_pix_fmt)
        if self._packed_offsets is not None and self.width % 2:
            self._fail_open(f"{path}: odd-width packed {self.container_pix_fmt} is "
                            "unsupported (chain invariant: even dims)")
        self.pix_fmt = "yuv422p" if self._packed_offsets is not None else self.container_pix_fmt
        self.fps = desc.fps_num / max(1, desc.fps_den)
        self.fps_fraction = (desc.fps_num, desc.fps_den)
        self.duration = desc.duration
        # raw (native) plane geometry used for the decode buffers; plane_w
        # is SAMPLES per row (2x pixel width for packed 422 rows)
        self._raw_plane_shapes = [(desc.plane_h[p], desc.plane_w[p]) for p in range(desc.planes)]
        if self._packed_offsets is not None:
            self.n_planes = 3
            self.plane_shapes = [(self.height, self.width), (self.height, self.width // 2),
                                 (self.height, self.width // 2)]
        elif desc.planes >= 3 or self.container_pix_fmt.startswith("gray"):
            self.n_planes = desc.planes
            self.plane_shapes = list(self._raw_plane_shapes)
        else:
            # 1-2 plane multi-component layouts (nv12, rgb24 packed, ...)
            # would silently violate the planar Frame contract downstream
            self._fail_open(f"{path}: unsupported non-planar pixel format "
                            f"{self.container_pix_fmt!r} (planar YUV/gray or packed "
                            f"422 expected)")
        self.dtype = np.uint16 if desc.bytes_per_sample == 2 else np.uint8
        if self._packed_offsets is not None and self.dtype != np.uint8:
            self._fail_open(f"{path}: packed format {self.container_pix_fmt!r} with "
                            f"{desc.bytes_per_sample} bytes/sample unsupported (packed "
                            f"deinterleave is 8-bit only)")
        global _opens
        with _OPENS_LOCK:
            _opens += 1
        if tm.enabled():
            _DECODER_OPENS.inc()

    def _fail_open(self, msg: str) -> None:
        medialib.ensure_loaded().mp_decoder_close(self._h)
        self._h = None
        raise MediaError(msg)

    def _deinterleave(self, raw: np.ndarray) -> tuple[np.ndarray, ...]:
        """Packed 422 row bytes [h, 2w] → planar (y, u, v) copies."""
        y_off, u_off, v_off = self._packed_offsets
        return (np.ascontiguousarray(raw[..., y_off::2]),
                np.ascontiguousarray(raw[..., u_off::4]),
                np.ascontiguousarray(raw[..., v_off::4]))

    def _deinterleave_chunk(self, raw: np.ndarray, out: list) -> None:
        """Chunk-wise packed-422 deinterleave into pre-allocated blocks."""
        y_off, u_off, v_off = self._packed_offsets
        np.copyto(out[0], raw[..., y_off::2])
        np.copyto(out[1], raw[..., u_off::4])
        np.copyto(out[2], raw[..., v_off::4])

    def _decode_batch_into(self, blocks: list, max_frames: int):
        """ONE native crossing: decode up to `max_frames` frames into the
        caller's raw-geometry plane blocks ([N, h, w] C-contiguous, one
        per decoder plane). Returns (n_decoded, pts[n_decoded])."""
        if not self._h:
            raise MediaError(f"{self.path}: reader is closed")
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        u8p = ct.POINTER(ct.c_uint8)
        for b, shape in zip(blocks, self._raw_plane_shapes):
            assert b.flags["C_CONTIGUOUS"] and b.dtype == self.dtype
            assert b.shape[0] >= max_frames and b.shape[1:] == shape
        pts = np.zeros(max_frames, np.float64)
        ptrs = [b.ctypes.data_as(u8p) for b in blocks]
        ptrs += [None] * (4 - len(ptrs))
        n = lib.mp_decoder_next_batch(self._h, ptrs[0], ptrs[1], ptrs[2], ptrs[3], max_frames,
                                      pts.ctypes.data_as(ct.POINTER(ct.c_double)), err, 512)
        if n < 0:
            # forensics: source path + stream frame index + the native text
            raise MediaError(f"decode {self.path} @frame {self._frames_out}: "
                             f"{err.value.decode()[:500]}")
        self._frames_out += int(n)
        if tm.enabled():
            _IO_BATCH_DECODE.inc()
        return int(n), pts[: int(n)]

    def iter_chunks(self, chunk: int = 64,
                    pool: Optional[bufpool.BufferPool] = None) -> Iterator[list]:
        """Stream the window as per-plane planar [T, H, W] stacks of up to
        `chunk` frames, decoded chunk-at-a-time through ONE native call
        each, into blocks from `pool`. Ownership of full blocks passes to
        the consumer (release via `pool.release(*chunk)` when the frames
        have been consumed); the tail chunk yields trimmed views, which
        release ignores."""
        pool = pool or bufpool.DEFAULT_POOL
        packed = self._packed_offsets is not None
        while True:
            raw_blocks = [pool.acquire((chunk,) + shape, self.dtype)
                          for shape in self._raw_plane_shapes]
            try:
                n, _pts = self._decode_batch_into(raw_blocks, chunk)
            except BaseException:
                # a mid-stream decode failure must not strand pooled blocks
                pool.release(*raw_blocks)
                raise
            if n == 0:
                pool.release(*raw_blocks)
                return
            if packed:
                planar = [pool.acquire((n,) + shape, self.dtype) for shape in self.plane_shapes]
                self._deinterleave_chunk(raw_blocks[0][:n], planar)
                pool.release(*raw_blocks)
                yield planar
            else:
                yield raw_blocks if n == chunk else [b[:n] for b in raw_blocks]
            if n < chunk:
                return

    def __iter__(self) -> Iterator[Frame]:
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        u8p = ct.POINTER(ct.c_uint8)
        while True:
            if not self._h:
                raise MediaError(f"{self.path}: reader is closed")
            planes = tuple(np.zeros(shape, self.dtype) for shape in self._raw_plane_shapes)
            ptrs = [p.ctypes.data_as(u8p) for p in planes] + [None] * (4 - len(planes))
            pts = ct.c_double()
            ret = lib.mp_decoder_next(self._h, ptrs[0], ptrs[1], ptrs[2], ptrs[3],
                                      ct.byref(pts), err, 512)
            if ret == 0:
                return
            if ret < 0:
                raise MediaError(f"decode {self.path} @frame {self._frames_out}: "
                                 f"{err.value.decode()[:500]}")
            self._frames_out += 1
            if self._packed_offsets is not None:
                planes = self._deinterleave(planes[0])
            yield Frame(planes=planes, pts=pts.value, pix_fmt=self.pix_fmt)

    def _estimated_frames(self) -> int:
        """Best-effort frame count of the decode window (sizes read_all's
        output stacks; wrong estimates only cost a rare grow-copy)."""
        if self.fps <= 0:
            return 0
        window = self._window
        if window <= 0:
            window = max(0.0, self.duration - self._start)
        return int(round(window * self.fps)) if window > 0 else 0

    def read_all(self) -> tuple[list[np.ndarray], list[float]]:
        """Decode every frame in the window; returns (per-plane stacked
        [T, H, W] arrays, pts list), decoding chunk-wise straight into
        pre-sized output stacks."""
        est = self._estimated_frames()
        # never trust container metadata with the whole allocation: cap
        # the pre-size and let the grow path extend long reads
        cap = min(est + 2, 1024) if est > 0 else 64
        step = 64
        packed = self._packed_offsets is not None
        out = [np.empty((cap,) + shape, self.dtype) for shape in self.plane_shapes]
        scratch = ([np.empty((step,) + self._raw_plane_shapes[0], self.dtype)]
                   if packed else None)
        total = 0
        pts_parts: list[np.ndarray] = []
        while True:
            if total == cap:  # estimate fell short: grow by half
                cap += max(step, cap // 2)
                out = [np.concatenate([o, np.empty((cap - total,) + o.shape[1:], self.dtype)])
                       for o in out]
            take = min(step, cap - total)
            if packed:
                n, pts = self._decode_batch_into(scratch, take)
                if n:
                    self._deinterleave_chunk(scratch[0][:n], [o[total: total + n] for o in out])
            else:
                n, pts = self._decode_batch_into([o[total: total + take] for o in out], take)
            if n == 0:
                break
            pts_parts.append(pts)
            total += n
            if n < take:
                break
        if total == 0:
            return [], []
        return [o[:total] for o in out], list(np.concatenate(pts_parts))

    def close(self) -> None:
        if self._h:
            medialib.ensure_loaded().mp_decoder_close(self._h)
            self._h = None

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class VideoWriter:
    """Encoder + muxer. Codec/rate-control knobs mirror the reference's
    encoder command builders (lib/ffmpeg.py:61-318): bitrate, gop/bframes,
    and an ffmpeg-style `opts` string ("level=3:slicecrc=1", private
    options included) applied to the codec context. `pass_num` 1 or 2
    runs a two-pass encode with its statistics at `stats_path`: x264
    keeps them through its own "stats" option, libx265 through
    x265-params, the others (libvpx, libaom) through the codec context's
    stats_out/stats_in, which is refused by name where the round trip at
    load did not prove them."""

    def __init__(
        self,
        path: str,
        codec: str,
        width: int,
        height: int,
        pix_fmt: str = "yuv420p",
        fps: tuple[int, int] = (24, 1),
        bitrate_kbps: float = 0,
        minrate_kbps: float = 0,
        maxrate_kbps: float = 0,
        bufsize_kbps: float = 0,
        gop: int = -1,
        bframes: int = -1,
        threads: int = -1,
        opts: str = "",
        pass_num: int = 0,
        stats_path: str = "",
        audio_codec: str = "",
        sample_rate: int = 48000,
        channels: int = 2,
        audio_bitrate_kbps: float = 0,
    ) -> None:
        self.path = path
        self._frames_in = 0
        self._closed = False
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        self._h = lib.mp_encoder_open(
            path.encode(), codec.encode(), width, height, pix_fmt.encode(),
            fps[0], fps[1], int(bitrate_kbps * 1000), int(minrate_kbps * 1000),
            int(maxrate_kbps * 1000), int(bufsize_kbps * 1000), gop, bframes,
            threads, opts.encode(), pass_num, stats_path.encode(),
            audio_codec.encode(), sample_rate, channels,
            int(audio_bitrate_kbps * 1000), err, 512,
        )
        if not self._h:
            raise MediaError(f"encoder open {path} ({codec}): {err.value.decode()}")

    def write(self, *planes: np.ndarray) -> None:
        if not self._h:
            raise MediaError(f"{self.path}: writer is closed")
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        u8p = ct.POINTER(ct.c_uint8)
        arrs = [np.ascontiguousarray(p) for p in planes if p is not None]
        ptrs = [a.ctypes.data_as(u8p) for a in arrs] + [None] * (4 - len(arrs))
        if lib.mp_encoder_write_video(self._h, ptrs[0], ptrs[1], ptrs[2], ptrs[3], err, 512) < 0:
            raise MediaError(f"encode {self.path} @frame {self._frames_in}: "
                             f"{err.value.decode()[:500]}")
        self._frames_in += 1

    def write_batch(self, *planes: np.ndarray) -> None:
        """Encode a [T, h, w] stack per plane in ONE native crossing (in fp
        mode the whole chunk streams through the worker pool without
        Python in the loop). Byte-identical to T calls of `write`."""
        if not self._h:
            raise MediaError(f"{self.path}: writer is closed")
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        u8p = ct.POINTER(ct.c_uint8)
        arrs = [np.ascontiguousarray(p) for p in planes if p is not None]
        if not arrs:
            return
        t = int(arrs[0].shape[0])
        if any(int(a.shape[0]) != t for a in arrs):
            raise MediaError(f"{self.path}: write_batch plane stacks disagree on frame "
                             f"count: {[a.shape[0] for a in arrs]}")
        if t == 0:
            return
        ptrs = [a.ctypes.data_as(u8p) for a in arrs] + [None] * (4 - len(arrs))
        if lib.mp_encoder_write_video_batch(self._h, ptrs[0], ptrs[1], ptrs[2], ptrs[3], t,
                                            err, 512) < 0:
            raise MediaError(f"encode {self.path} @frame {self._frames_in}: "
                             f"{err.value.decode()[:500]}")
        self._frames_in += t
        if tm.enabled():
            _IO_BATCH_ENCODE.inc()

    def write_audio(self, samples: np.ndarray) -> None:
        """samples: int16 [n, channels] interleaved."""
        if not self._h:
            raise MediaError(f"{self.path}: writer is closed")
        lib = medialib.ensure_loaded()
        err = ct.create_string_buffer(512)
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        if lib.mp_encoder_write_audio(self._h, samples.ctypes.data_as(ct.POINTER(ct.c_int16)),
                                      samples.shape[0], err, 512) < 0:
            raise MediaError(f"audio encode {self.path}: {err.value.decode()}")

    def close(self) -> None:
        if self._h and not self._closed:
            self._closed = True
            err = ct.create_string_buffer(512)
            h, self._h = self._h, None
            # the close flushes delayed frames and finalizes the container
            if medialib.ensure_loaded().mp_encoder_close(h, err, 512) < 0:
                raise MediaError(f"close {self.path} after {self._frames_in} "
                                 f"frames: {err.value.decode()[:500]}")

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
