"""Exact per-frame byte sizes straight from the bitstream (a copy of
processing_chain_tpu/io/framesizes.py over the port's media boundary).

Parity target: reference lib/get_framesize.py — an Annex-B NAL start-code
state machine for H.264 (:144-201) / H.265 (:204-263), an IVF container walk
for VP9 (:87-141), and ffprobe pkt_size fallback for AV1 (:266-274). The
reference reads the file one byte at a time in Python (its only Python-side
hot loop); here the scan is vectorized numpy over the whole buffer.

Size semantics match the reference exactly: a "frame" is a slice/VCL NAL;
its size runs from the byte after its start code's 0x01 to the 0x01 of the
next start code, minus 3 (or 5 when two extra zero bytes precede the next
start code); trailing frame sizes get the reference's end-of-file adjustments
(+3 for H.264, +0 for H.265).
"""

from __future__ import annotations

import os
import struct
import tempfile

import numpy as np

from .. import telemetry as tm
from ..utils import lockdebug
from . import medialib, sharedscan


def _start_code_positions(data: np.ndarray) -> np.ndarray:
    """Positions of the 0x01 byte of every 00 00 01 start-code trio."""
    if data.size < 3:
        return np.empty(0, np.int64)
    hits = (data[2:] == 1) & (data[1:-1] == 0) & (data[:-2] == 0)
    return np.nonzero(hits)[0] + 2


def _annexb_frame_sizes(
    data: np.ndarray, is_slice_nal
) -> tuple[list[int], np.ndarray, np.ndarray]:
    """Shared Annex-B scan: is_slice_nal(hdr_bytes) -> bool mask.
    Returns (sizes for all but the last slice NAL, start-code positions,
    slice mask) — empty when the stream has no start codes."""
    pos = _start_code_positions(data)
    if pos.size == 0:
        return [], pos, np.empty(0, bool)
    hdr_idx = pos + 1
    valid = hdr_idx < data.size
    pos = pos[valid]
    hdr = data[hdr_idx[valid]]
    slice_mask = is_slice_nal(hdr)
    sizes: list[int] = []
    nxt = np.roll(pos, -1)
    # prefix adjustment for the *next* start code (reference :163-169):
    # -5 when two extra zero bytes precede it, else -3
    for k in range(pos.size - 1):
        if not slice_mask[k]:
            continue
        end = nxt[k]
        extra = 5 if (end >= 4 and data[end - 3] == 0 and data[end - 4] == 0) else 3
        sizes.append(int(end - pos[k] - extra))
    return sizes, pos, slice_mask


def get_framesize_h264(filename: str, force: bool = False) -> list[int]:
    """H.264 slice sizes from the Annex-B stream (reference :144-201)."""
    data = _extract(filename, "h264", force)
    def is_slice(hdr):
        return np.isin(hdr & 0x1F, (1, 5)) & ((hdr & 0x10) == 0)
    sizes, pos, slice_mask = _annexb_frame_sizes(data, is_slice)
    if slice_mask.size and slice_mask[-1]:
        # reference end-of-file rule (:193-196): remaining bytes + 3
        sizes.append(int(data.size - 1 - pos[-1] + 3))
    return sizes


def get_framesize_h265(filename: str, force: bool = False) -> list[int]:
    """H.265 VCL NAL sizes (reference :204-263): NAL types 0-9 and 16-21."""
    data = _extract(filename, "h265", force)
    def is_slice(hdr):
        t = (hdr.astype(np.int64) >> 1) & 0x3F
        return (t <= 9) | ((t >= 16) & (t <= 21))
    sizes, pos, slice_mask = _annexb_frame_sizes(data, is_slice)
    if slice_mask.size and slice_mask[-1]:
        # reference end-of-file rule (:254-257): remaining bytes, no +3
        sizes.append(int(data.size - 1 - pos[-1]))
    return sizes


def get_framesize_vp9(filename: str, force: bool = False) -> list[int]:
    """VP9 frame sizes from the IVF frame headers (reference :87-141).

    The reference reads only 3 of the 4 size bytes (frames < 16 MiB); we
    read the full little-endian uint32."""
    with tempfile.TemporaryDirectory() as tmp:
        ivf = os.path.join(tmp, os.path.basename(filename) + "_tmp.ivf")
        medialib.extract_ivf(filename, ivf)
        raw = open(ivf, "rb").read()
    sizes = []
    off = 32  # IVF file header
    n = len(raw)
    while off + 12 <= n:
        (size,) = struct.unpack_from("<I", raw, off)
        sizes.append(int(size))
        off += 12 + size
    return sizes


def ffprobe_av1_frame_info(filename: str, timeout: float = 300.0) -> dict:
    """ffprobe fallback for AV1 frame metadata, routed through the
    chain's one subprocess door (`utils.runner.shell` — list argv,
    bounded wall time, ChainError on failure; the subprocess-hygiene
    rule). ONE `-show_frames` pass yields `{"size": [...],
    "pict_type": [...]}` so priors consumers get AV1 frame types without
    a second probe. Raises ChainError when ffprobe fails, and
    FileNotFoundError (from subprocess, as in the JAX package) when no
    ffprobe is on the PATH."""
    from ..utils.runner import shell

    proc = shell(
        [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_frames", "-show_entries", "frame=pkt_size,pict_type",
            "-of", "csv=p=0", filename,
        ],
        timeout=timeout,
    )
    sizes: list[int] = []
    picts: list[str] = []
    for line in proc.stdout.splitlines():
        if not line.strip():
            continue
        size, pict = None, "?"
        for tok in line.strip().split(","):
            tok = tok.strip()
            if tok.isdigit():
                size = int(tok)
            elif tok:
                pict = tok
        # one csv line == one frame: a frame whose pkt_size prints as
        # N/A must still occupy its slot (size 0), or every consumer
        # indexing frames by position desyncs past it
        if size is not None or pict != "?":
            sizes.append(size if size is not None else 0)
            picts.append(pict if pict != "N/A" else "?")
    return {"size": sizes, "pict_type": picts}


def get_framesize_av1(filename: str, force: bool = False) -> list[int]:
    """AV1: packet sizes from the native demuxer (reference :266-274 falls
    back to ffprobe pkt_size — kept here as the degrade path when the
    native boundary cannot load, via `ffprobe_av1_frame_info`). Served
    from the shared post-encode scan (io/sharedscan.py) so a p01-primed
    file costs no extra demux pass. `force` is unused (the demuxer scan
    is always exact); the default matches the three sibling parsers so a
    keyword caller sees uniform behavior."""
    try:
        return [int(s) for s in sharedscan.video(filename)["size"]]
    except medialib.MediaError:
        return ffprobe_av1_frame_info(filename)["size"]


#: bounded result memo with the DigestCache stat-signature trust model
#: (store/keys.py): repeat get_framesizes calls on an unchanged file —
#: p02 rebuilds, priors difficulty, serve cost features — stop re-reading
#: and re-parsing the whole bitstream. `force=True` bypasses AND refreshes.
_CACHE_MAX = 256
_cache_lock = lockdebug.make_lock("framesizes_cache")
_cache: dict[str, list] = {}  # guarded-by: _cache_lock (insertion = LRU)

_CACHE_HITS = tm.counter(
    "chain_io_framesizes_cache_hits_total",
    "get_framesizes served from the stat-keyed memo — a full bitstream "
    "re-parse a consumer did NOT pay",
)


def get_framesizes(filename: str, codec: str, force: bool = False) -> list[int]:
    try:
        st = os.stat(filename)
        key = f"{os.path.abspath(filename)}|{st.st_size}|{st.st_mtime_ns}|{codec}"
    except OSError:
        key = None  # let the parser raise its own error
    if key is not None and not force:
        with _cache_lock:
            hit = _cache.get(key)
            if hit is not None:
                _cache.pop(key)
                _cache[key] = hit
        if hit is not None:
            _CACHE_HITS.inc()
            return list(hit)
    if codec == "h264":
        sizes = get_framesize_h264(filename, force)
    elif codec in ("h265", "hevc"):
        sizes = get_framesize_h265(filename, force)
    elif codec == "vp9":
        sizes = get_framesize_vp9(filename, force)
    elif codec == "av1":
        sizes = get_framesize_av1(filename, force)
    else:
        raise ValueError(f"no exact frame-size parser for codec {codec!r}")
    if key is not None:
        with _cache_lock:
            _cache[key] = sizes
            while len(_cache) > _CACHE_MAX:
                _cache.pop(next(iter(_cache)))
    return list(sizes)


def merge_superframes(vfi, sizes_col="size", dts_col="dts"):
    """Merge VP9 superframe packets whose DTS differ by < 1.1 ms: the later
    packet's size is added to the earlier and the row dropped (reference
    delete_packets, get_framesize.py:27-51). Operates on a pandas DataFrame,
    returns a new one with reindexed `index` per segment."""
    df = vfi.reset_index(drop=True)
    dts = df[dts_col].to_numpy(dtype=np.float64)
    close = np.abs(np.diff(dts)) < 0.0011
    drop = np.zeros(len(df), dtype=bool)
    sizes = df[sizes_col].to_numpy().copy()
    target = np.arange(len(df))
    for i in np.nonzero(close)[0]:
        # row i+1 merges into the most recent kept row
        t = target[i]
        sizes[t] += sizes[i + 1]
        drop[i + 1] = True
        target[i + 1] = t
    df = df.assign(**{sizes_col: sizes})[~drop].reset_index(drop=True)
    if "segment" in df.columns:
        df["index"] = df.groupby("segment").cumcount()
    return df


def _extract(filename: str, codec: str, force: bool) -> np.ndarray:
    """Remux to Annex-B into a temp file and load as a numpy byte array
    (reference convert_file, :54-77)."""
    bsf = "h264_mp4toannexb" if codec == "h264" else "hevc_mp4toannexb"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, os.path.basename(filename) + f"_tmp.{codec}")
        medialib.extract_annexb(filename, bsf, out)
        return np.fromfile(out, dtype=np.uint8)
