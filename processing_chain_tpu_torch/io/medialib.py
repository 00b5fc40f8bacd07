"""ctypes bindings for the port's media boundary (csrc/media.cpp): the
counterpart of processing_chain_tpu/io/medialib.py for the subset the p03
file path calls (probe, packet scans, audio decode; the decoder and encoder
entry points are reached through io/video.py).

`csrc/media.cpp` includes no libav header. At first use this module

  1. builds it with the host C++ compiler into
     `build/processing_chain_tpu_torch/media-<hash>.so` (the hash covers
     the source and the flags, so an edited source is rebuilt);
  2. locates one libav: the loader's own `libavcodec` (`find_library` and
     the loader paths) first, then the `*.libs` folders that wheels bundle
     under site-packages, whose libraries find each other only once the
     folder is loaded with RTLD_GLOBAL. `PC_LIBAV_DIRS` (directories,
     `os.pathsep`-separated) replaces that search;
  3. binds the library to that copy (`mp_bind`: every entry point resolved
     with dlsym, the struct layout table chosen by the major versions) and
     proves the table with `mp_check`'s round trips.

The first copy found is the one used: a copy whose binding or check fails
raises `MediaError` naming the field, and no other copy is tried. No libav
at all raises `MediaError` naming what was searched.
"""

from __future__ import annotations

import ctypes as ct
import ctypes.util
import glob
import hashlib
import os
import shutil
import site
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

from .. import telemetry as tm
from ..utils import lockdebug

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "media.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "processing_chain_tpu_torch")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-fvisibility=hidden",
             "-Wall", "-pthread")
#: the libraries bound, in load order: each later one needs the earlier
_LIBS = ("avutil", "swresample", "avcodec", "avformat")

_lock = lockdebug.make_lock("medialib")
_lib: Optional[ct.CDLL] = None  # guarded-by: _lock
_binding: dict = {}  # guarded-by: _lock

#: every bitstream walk over a written file that is not a decoder open
_SCAN_PASSES = tm.counter(
    "chain_io_scan_passes_total",
    "bitstream demux/parse passes over a file "
    "(op=packets|packets_all|annexb|ivf|priors)",
    ("op",),
)


class MPStreamInfo(ct.Structure):
    _fields_ = [
        ("stream_index", ct.c_int32),
        ("codec_type", ct.c_int32),
        ("codec_name", ct.c_char * 32),
        ("width", ct.c_int32),
        ("height", ct.c_int32),
        ("coded_width", ct.c_int32),
        ("coded_height", ct.c_int32),
        ("pix_fmt", ct.c_char * 32),
        ("fps_num", ct.c_int32),
        ("fps_den", ct.c_int32),
        ("avg_fps_num", ct.c_int32),
        ("avg_fps_den", ct.c_int32),
        ("tb_num", ct.c_int32),
        ("tb_den", ct.c_int32),
        ("duration", ct.c_double),
        ("nb_frames", ct.c_int64),
        ("bit_rate", ct.c_int64),
        ("sample_rate", ct.c_int32),
        ("channels", ct.c_int32),
        ("sample_fmt", ct.c_char * 32),
        ("profile", ct.c_char * 64),
    ]


class MPFormatInfo(ct.Structure):
    _fields_ = [
        ("format_name", ct.c_char * 64),
        ("duration", ct.c_double),
        ("bit_rate", ct.c_int64),
        ("file_size", ct.c_int64),
        ("nb_streams", ct.c_int32),
    ]


class MPVideoDesc(ct.Structure):
    _fields_ = [
        ("width", ct.c_int32),
        ("height", ct.c_int32),
        ("pix_fmt", ct.c_char * 32),
        ("fps_num", ct.c_int32),
        ("fps_den", ct.c_int32),
        ("duration", ct.c_double),
        ("planes", ct.c_int32),
        ("plane_w", ct.c_int32 * 4),
        ("plane_h", ct.c_int32 * 4),
        ("bytes_per_sample", ct.c_int32),
    ]


class MediaError(RuntimeError):
    """A native media-boundary failure. `kind` is the serve failure
    taxonomy's surface (docs/SERVE.md "Failure taxonomy"): raisers that
    KNOW the failure class tag it "transient" (full disk, wedged host),
    "permanent" (bad parameters) or "poison" (hostile input bytes — the
    SRC itself is the problem; serve quarantines its content digest
    fleet-wide). None = no claim; serve/scheduler.classify_failure
    falls back to exception-type heuristics."""

    def __init__(self, *args, kind: Optional[str] = None) -> None:
        super().__init__(*args)
        self.kind = kind


# --- build ------------------------------------------------------------------

def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"media-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/media.cpp unless an up-to-date library exists."""
    path = library_path()
    if os.path.isfile(path):
        return path
    # chainlint: disable=plan-purity (where the compiler lives: the library is keyed by its source and flags, and computes no artifact byte)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise MediaError("no C++ compiler (set CXX or put g++ on PATH) to build "
                         f"{SOURCE}", kind="permanent")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    # chainlint: disable=subprocess-hygiene (one compiler run whose whole output is read; a refusal raises MediaError with it)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-ldl"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise MediaError(f"building {SOURCE} failed:\n{proc.stderr[-2000:]}",
                         kind="permanent")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


# --- locating libav ---------------------------------------------------------

def _soname_paths(folder: str) -> Optional[list[str]]:
    """The four libraries in `folder` (hashed wheel sonames included), or
    None when one is missing."""
    out = []
    for name in _LIBS:
        hits = sorted(glob.glob(os.path.join(folder, f"lib{name}*.so*")))
        if not hits:
            return None
        out.append(hits[0])
    return out


def _load(paths: list[str], folder: str) -> None:
    """Load the four libraries globally. Where one does not load alone
    (a wheel's bundled copies find each other through the importing
    module's RPATH, not their own), load the rest of its folder first."""
    try:
        for p in paths:
            ct.CDLL(p, mode=ct.RTLD_GLOBAL)
    except OSError:
        _load_folder(folder)


def _load_folder(folder: str) -> None:
    """Load every library of a wheel's folder globally, retrying until no
    more load."""
    pending = sorted(glob.glob(os.path.join(folder, "*.so*")))
    while pending:
        failed = []
        for p in pending:
            try:
                ct.CDLL(p, mode=ct.RTLD_GLOBAL)
            except OSError:
                failed.append(p)
        if len(failed) == len(pending):
            return
        pending = failed


def _loader_copy() -> Optional[list[str]]:
    """The loader's own libraries, by soname, when find_library sees all
    four and they load."""
    names = [ctypes.util.find_library(n) for n in _LIBS]
    if not all(names):
        return None
    try:
        for n in names:
            ct.CDLL(n, mode=ct.RTLD_GLOBAL)
    except OSError:
        return None
    return names


def _wheel_folders() -> list[str]:
    roots = []
    try:
        roots = [*site.getsitepackages(), site.getusersitepackages()]
    except AttributeError:  # a virtualenv's site module may lack them
        pass
    roots += [p for p in sys.path if p.endswith("site-packages")]
    folders = set()
    for r in roots:
        for pat in ("*.libs/libavcodec*.so*", "*/.libs/libavcodec*.so*"):
            folders.update(os.path.dirname(p) for p in glob.glob(os.path.join(r, pat)))
    return sorted(folders)


def locate() -> tuple[list[str], str]:
    """(library paths to bind, where they were found). Raises MediaError
    naming every place searched when no copy is found."""
    # plan-exempt: (where libav is bound from; the copy is held by the layout check)
    pinned = os.environ.get("PC_LIBAV_DIRS")
    searched = []
    if pinned is not None:
        for folder in [d for d in pinned.split(os.pathsep) if d]:
            searched.append(folder)
            paths = _soname_paths(folder)
            if paths:
                _load(paths, folder)
                return paths, f"PC_LIBAV_DIRS folder {folder}"
        raise MediaError(
            f"no libav (libavutil, libswresample, libavcodec, libavformat) in "
            f"PC_LIBAV_DIRS={pinned!r}", kind="permanent")
    names = _loader_copy()
    searched.append("the loader's paths (find_library)")
    if names:
        return names, "the loader's paths"
    for folder in _wheel_folders():
        searched.append(folder)
        paths = _soname_paths(folder)
        if paths:
            _load(paths, folder)
            return paths, f"wheel folder {folder}"
    raise MediaError(f"no libav found; searched {searched}", kind="permanent")


def _mapped_path(name: str) -> str:
    """The file a loaded library came from (/proc/self/maps), else `name`."""
    base = os.path.basename(name).split(".so")[0]
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                p = line.split()[-1]
                if os.path.basename(p).startswith(base) and ".so" in p:
                    return p
    except OSError:
        pass
    return name


def ensure_loaded() -> ct.CDLL:
    """The bound, checked boundary (built, located and checked on the
    first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ct.CDLL(build())
        paths, found = locate()
        err = ct.create_string_buffer(512)
        arr = (ct.c_char_p * len(paths))(*[p.encode() for p in paths])
        lib.mp_bind.restype = ct.c_int
        lib.mp_bind.argtypes = [ct.POINTER(ct.c_char_p), ct.c_int, ct.c_char_p, ct.c_int]
        if lib.mp_bind(arr, len(paths), err, 512) < 0:
            raise MediaError(f"binding libav from {found}: {err.value.decode()}",
                             kind="permanent")
        if lib.mp_stream_info_size() != ct.sizeof(MPStreamInfo):
            raise MediaError("media library ABI mismatch (MPStreamInfo size)")
        _declare(lib)
        report = ct.create_string_buffer(8192)
        with tempfile.TemporaryDirectory(prefix="pc_media_check_") as scratch:
            passed = lib.mp_check(scratch.encode(), report, 8192, err, 512)
        if passed < 0:
            raise MediaError(
                f"libav from {found} ({lib.mp_version().decode()}) failed the struct "
                f"layout check: {err.value.decode()}", kind="permanent")
        twopass = dict(v.split("=", 1) for v in lib.mp_twopass_report().decode().split())
        _binding.update(
            found=found,
            libs=[_mapped_path(p) for p in paths],
            versions=lib.mp_version().decode(),
            checks=report.value.decode().split(),
            twopass=twopass,
        )
        _lib = lib
    for name, verdict in twopass.items():
        if verdict != "ok":
            from ..utils.log import get_logger

            get_logger().info("media: two-pass round trip of %s at load: %s%s", name, verdict,
                              " (skipped)" if verdict == "absent" else
                              "; its two-pass is refused")
    return lib


def _declare(lib: ct.CDLL) -> None:
    u8p = ct.POINTER(ct.c_uint8)
    i16p = ct.POINTER(ct.c_int16)
    i64p = ct.POINTER(ct.c_int64)
    f64p = ct.POINTER(ct.c_double)
    i8p = ct.POINTER(ct.c_int8)
    lp = ct.POINTER(ct.c_long)
    sigs = {
        "mp_check": (ct.c_int, [ct.c_char_p, ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int]),
        "mp_layout": (ct.c_int, [ct.c_char_p]),
        "mp_has_codec": (ct.c_int, [ct.c_char_p, ct.c_int]),
        "mp_version": (ct.c_char_p, []),
        "mp_probe": (ct.c_int, [ct.c_char_p, ct.POINTER(MPFormatInfo), ct.POINTER(MPStreamInfo),
                                ct.c_int, ct.c_int, ct.c_char_p, ct.c_int]),
        "mp_scan_packets": (ct.c_long, [ct.c_char_p, ct.c_int, i64p, f64p, f64p, f64p, i8p,
                                        ct.c_long, ct.c_char_p, ct.c_int]),
        "mp_scan_packets_all": (ct.c_int, [ct.c_char_p, i64p, f64p, f64p, f64p, i8p, ct.c_long,
                                           lp, i64p, f64p, f64p, f64p, i8p, ct.c_long, lp,
                                           ct.c_char_p, ct.c_int]),
        "mp_decoder_open_t": (ct.c_void_p, [ct.c_char_p, ct.c_double, ct.c_double, ct.c_int,
                                            ct.c_char_p, ct.c_int]),
        "mp_decoder_desc": (ct.c_int, [ct.c_void_p, ct.POINTER(MPVideoDesc)]),
        "mp_decoder_next": (ct.c_int, [ct.c_void_p, u8p, u8p, u8p, u8p, f64p, ct.c_char_p,
                                       ct.c_int]),
        "mp_decoder_next_batch": (ct.c_long, [ct.c_void_p, u8p, u8p, u8p, u8p, ct.c_long, f64p,
                                              ct.c_char_p, ct.c_int]),
        "mp_decoder_close": (None, [ct.c_void_p]),
        "mp_decode_audio_s16_ch": (ct.c_long, [ct.c_char_p, ct.c_double, ct.c_double, ct.c_int,
                                               i16p, ct.c_long, ct.POINTER(ct.c_int32),
                                               ct.POINTER(ct.c_int32), ct.c_char_p, ct.c_int]),
        "mp_encoder_open": (ct.c_void_p, [
            ct.c_char_p, ct.c_char_p, ct.c_int, ct.c_int, ct.c_char_p, ct.c_int, ct.c_int,
            ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
            ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_char_p, ct.c_int, ct.c_int, ct.c_int64,
            ct.c_char_p, ct.c_int]),
        "mp_encoder_write_video": (ct.c_int, [ct.c_void_p, u8p, u8p, u8p, u8p, ct.c_char_p,
                                              ct.c_int]),
        "mp_encoder_write_video_batch": (ct.c_long, [ct.c_void_p, u8p, u8p, u8p, u8p,
                                                     ct.c_long, ct.c_char_p, ct.c_int]),
        "mp_encoder_write_audio": (ct.c_int, [ct.c_void_p, i16p, ct.c_long, ct.c_char_p,
                                              ct.c_int]),
        "mp_encoder_close": (ct.c_int, [ct.c_void_p, ct.c_char_p, ct.c_int]),
        "mp_twopass_report": (ct.c_char_p, []),
        "mp_has_bsf": (ct.c_int, [ct.c_char_p]),
        "mp_extract_annexb": (ct.c_int, [ct.c_char_p, ct.c_char_p, ct.c_char_p, ct.c_char_p,
                                         ct.c_int]),
        "mp_extract_ivf": (ct.c_int, [ct.c_char_p, ct.c_char_p, ct.c_char_p, ct.c_int]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _err_buf() -> ct.Array:
    return ct.create_string_buffer(512)


def version() -> str:
    """The bound libav: versions, the libraries' paths and where they
    were found."""
    ensure_loaded()
    with _lock:
        return (f"{_binding['versions']} from {_binding['found']}: "
                f"{', '.join(_binding['libs'])}")


def binding() -> dict:
    """{found, libs, versions, checks}: where the bound libav came from
    and the layout entries its check passed (`Field@offset`)."""
    ensure_loaded()
    with _lock:
        return dict(_binding)


def layout_offset(name: str) -> int:
    """The bound table's offset for `name` ("AVFrame.pts"), -1 when unused."""
    return ensure_loaded().mp_layout(name.encode())


def twopass() -> dict:
    """{encoder: verdict} of the two-pass round trips at load (libvpx-vp9
    and libaom-av1, the encoders that exchange statistics through
    AVCodecContext.stats_out/stats_in): "ok", "absent" (not bound, the
    round trip skipped), or what failed. A failed encoder's two-pass is
    refused by name."""
    ensure_loaded()
    with _lock:
        return dict(_binding["twopass"])


def bitstream_filters(names) -> dict:
    """{name: whether the bound libav has that bitstream filter}."""
    lib = ensure_loaded()
    return {n: lib.mp_has_bsf(n.encode()) == 1 for n in names}


def extract_annexb(path: str, bsf_name: str, out_path: str) -> None:
    """The video stream through the bitstream filter `bsf_name`
    (h264_mp4toannexb / hevc_mp4toannexb), written raw to `out_path`. A
    libav without that filter raises naming it."""
    lib = ensure_loaded()
    _SCAN_PASSES.labels(op="annexb").inc()
    err = _err_buf()
    if lib.mp_extract_annexb(path.encode(), bsf_name.encode(), out_path.encode(), err, 512) < 0:
        raise MediaError(f"extract_annexb({path}): {err.value.decode()}")


def extract_ivf(path: str, out_path: str) -> None:
    """The video stream's packets as an IVF file at `out_path`."""
    lib = ensure_loaded()
    _SCAN_PASSES.labels(op="ivf").inc()
    err = _err_buf()
    if lib.mp_extract_ivf(path.encode(), out_path.encode(), err, 512) < 0:
        raise MediaError(f"extract_ivf({path}): {err.value.decode()}")


def codecs(names, encoder: bool = False) -> dict:
    """{name: whether the bound libav has a decoder (or, with `encoder`,
    an encoder) of that name}."""
    lib = ensure_loaded()
    return {n: lib.mp_has_codec(n.encode(), int(encoder)) == 1 for n in names}


def probe(path: str, coded_dims: bool = False) -> dict:
    """Container + stream info (the ffprobe -show_streams/-show_format
    replacement). `coded_dims=True` additionally resolves the first video
    stream's decoder coded_width/coded_height (a first-frame decode);
    otherwise coded dims mirror the display dims."""
    lib = ensure_loaded()
    fmt = MPFormatInfo()
    cap = 64
    want = 1 if coded_dims else 0
    streams = (MPStreamInfo * cap)()
    err = _err_buf()
    n = lib.mp_probe(path.encode(), ct.byref(fmt), streams, cap, want, err, 512)
    if n < 0:
        raise MediaError(f"probe({path}): {err.value.decode()}")
    if fmt.nb_streams > cap:
        cap = int(fmt.nb_streams)
        streams = (MPStreamInfo * cap)()
        n = lib.mp_probe(path.encode(), ct.byref(fmt), streams, cap, want, err, 512)
        if n < 0:
            raise MediaError(f"probe({path}): {err.value.decode()}")
    out_streams = []
    for i in range(n):
        s = streams[i]
        d = {
            "index": s.stream_index,
            "codec_type": "video" if s.codec_type == 0 else "audio",
            "codec_name": s.codec_name.decode(),
            "duration": s.duration,
            "nb_frames": s.nb_frames,
            "bit_rate": s.bit_rate,
            "time_base": (s.tb_num, s.tb_den),
            "profile": s.profile.decode(),
        }
        if s.codec_type == 0:
            d.update(
                width=s.width,
                height=s.height,
                coded_width=s.coded_width,
                coded_height=s.coded_height,
                pix_fmt=s.pix_fmt.decode(),
                r_frame_rate=f"{s.fps_num}/{s.fps_den}",
                avg_frame_rate=f"{s.avg_fps_num}/{s.avg_fps_den}",
            )
        else:
            d.update(
                sample_rate=s.sample_rate,
                channels=s.channels,
                sample_fmt=s.sample_fmt.decode(),
            )
        out_streams.append(d)
    return {
        "format": {
            "format_name": fmt.format_name.decode(),
            "duration": fmt.duration,
            "bit_rate": fmt.bit_rate,
            "size": fmt.file_size,
            "nb_streams": fmt.nb_streams,
        },
        "streams": out_streams,
    }


_PACKET_FIELDS = (
    ("size", np.int64),
    ("pts_time", np.float64),
    ("dts_time", np.float64),
    ("duration_time", np.float64),
    ("key", np.int8),
)


def _packet_ptrs(arrs: dict) -> list:
    return [
        arrs["size"].ctypes.data_as(ct.POINTER(ct.c_int64)),
        arrs["pts_time"].ctypes.data_as(ct.POINTER(ct.c_double)),
        arrs["dts_time"].ctypes.data_as(ct.POINTER(ct.c_double)),
        arrs["duration_time"].ctypes.data_as(ct.POINTER(ct.c_double)),
        arrs["key"].ctypes.data_as(ct.POINTER(ct.c_int8)),
    ]


def scan_packets(path: str, codec_type: str = "video") -> dict:
    """Per-packet size/pts/dts/duration/keyflag arrays (the ffprobe
    -show_packets replacement)."""
    lib = ensure_loaded()
    _SCAN_PASSES.labels(op="packets").inc()
    ctype = 0 if codec_type == "video" else 1
    cap = 1 << 16
    while True:
        arrs = {k: np.zeros(cap, dt) for k, dt in _PACKET_FIELDS}
        err = _err_buf()
        n = lib.mp_scan_packets(path.encode(), ctype, *_packet_ptrs(arrs), cap, err, 512)
        if n < 0:
            raise MediaError(f"scan_packets({path}): {err.value.decode()}")
        if n <= cap:
            return {k: a[:n].copy() for k, a in arrs.items()}
        cap = int(n) + 1024


def scan_packets_all(path: str) -> dict:
    """Both streams' packet arrays from ONE demux pass: {"video": <same
    dict shape as scan_packets>, "audio": <same, or None when the
    container has no audio stream>} (io/sharedscan's native leg)."""
    lib = ensure_loaded()
    _SCAN_PASSES.labels(op="packets_all").inc()
    v_cap = a_cap = 1 << 16
    while True:
        v = {k: np.zeros(v_cap, dt) for k, dt in _PACKET_FIELDS}
        a = {k: np.zeros(a_cap, dt) for k, dt in _PACKET_FIELDS}
        nv = ct.c_long(0)
        na = ct.c_long(0)
        err = _err_buf()
        ret = lib.mp_scan_packets_all(
            path.encode(), *_packet_ptrs(v), v_cap, ct.byref(nv),
            *_packet_ptrs(a), a_cap, ct.byref(na), err, 512,
        )
        if ret < 0:
            raise MediaError(f"scan_packets_all({path}): {err.value.decode()}")
        if nv.value <= v_cap and na.value <= a_cap:
            return {
                "video": {k: arr[: nv.value].copy() for k, arr in v.items()},
                "audio": None if na.value < 0 else {
                    k: arr[: na.value].copy() for k, arr in a.items()
                },
            }
        v_cap = max(v_cap, int(nv.value) + 1024)
        a_cap = max(a_cap, int(na.value) + 1024)


def decode_audio_s16(path: str, start: float = 0.0, duration: float = 0.0,
                     channels: int = 0):
    """Decode the best audio stream to (samples[n, channels] int16,
    sample_rate). channels > 0 remixes to that count inside libswresample
    with the ffmpeg CLI's `-ac N` default matrix; 0 keeps the file's
    native layout."""
    lib = ensure_loaded()
    err = _err_buf()
    rate = ct.c_int32()
    chans = ct.c_int32()
    n = lib.mp_decode_audio_s16_ch(
        path.encode(), start, duration, channels, None, 0, ct.byref(rate),
        ct.byref(chans), err, 512,
    )
    if n < 0:
        raise MediaError(f"decode_audio({path}): {err.value.decode()}")
    buf = np.zeros((int(n), max(1, chans.value)), np.int16)
    n2 = lib.mp_decode_audio_s16_ch(
        path.encode(), start, duration, channels,
        buf.ctypes.data_as(ct.POINTER(ct.c_int16)), n,
        ct.byref(rate), ct.byref(chans), err, 512,
    )
    if n2 < 0:
        raise MediaError(f"decode_audio({path}): {err.value.decode()}")
    return buf[: int(n2)], rate.value
