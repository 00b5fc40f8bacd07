"""One shared post-encode packet scan per written file (copy of
processing_chain_tpu/io/sharedscan.py).

p02 metadata (frame sizes/types via `io.probe`), priors extraction
bookkeeping, and the serve-plane complexity features all need the same
per-packet facts — size, pts/dts, duration, keyflag — about segments p01
just wrote. Before this module each consumer paid its own demux walk
(`medialib.scan_packets` twice per segment for video+audio, again for
bitrates, again in `tools.complexity`). Here every consumer shares ONE
`medialib.scan_packets_all` pass per (path, size, mtime_ns) signature:
p01's encode tail primes the cache the moment a segment lands
(models/segments.py, PC_SCAN_PRIME) and p02/priors/serve read it back
without touching the bitstream.

The stat-signature trust model is the same as store.keys.DigestCache
(make/ninja-style: a rewrite preserving size and mtime_ns is
indistinguishable by design). The cache is bounded and process-local —
it is a decode-once accelerator, not a store; cold reads simply scan.

Byte-determinism: consumers receive exactly the arrays
`medialib.scan_packets` would have produced (one demux visits the same
packets in the same order), so p02 outputs and priors sidecars hash
identically with or without a warm cache — PC_PLAN_DEBUG holds.
"""

from __future__ import annotations

import os

from .. import telemetry as tm
from ..utils import lockdebug
from . import medialib

#: one entry per written segment in flight; a full database pass over
#: far more segments degrades to LRU misses, never unbounded memory
_MAX_ENTRIES = 256

_lock = lockdebug.make_lock("sharedscan")
_cache: dict[str, dict] = {}  # guarded-by: _lock (insertion order = LRU)

_HITS = tm.counter(
    "chain_io_sharedscan_hits_total",
    "shared packet-scan cache hits — a demux pass a consumer did NOT pay",
)
_MISSES = tm.counter(
    "chain_io_sharedscan_misses_total",
    "shared packet-scan cache misses — one scan_packets_all pass each",
)


def _stat_key(path: str, st: os.stat_result) -> str:
    return f"{path}|{st.st_size}|{st.st_mtime_ns}"


def get_scan(path: str) -> dict:
    """The file's full packet map from one demux pass: ``{"video":
    {size, pts_time, dts_time, duration_time, key}, "audio": <same or
    None>}``. Served from the stat-keyed cache when the file is
    unchanged since the last scan; raises MediaError like scan_packets
    when the file has no video stream."""
    path = os.path.abspath(path)
    try:
        key = _stat_key(path, os.stat(path))
    except OSError:
        # unstattable path: let the native open raise its MediaError —
        # consumers see exactly the error scan_packets would have given
        _MISSES.inc()
        return medialib.scan_packets_all(path)
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.pop(key)
            _cache[key] = hit  # refresh LRU position
    if hit is not None:
        _HITS.inc()
        return hit
    _MISSES.inc()
    scan = medialib.scan_packets_all(path)  # outside the lock: demux is slow
    with _lock:
        _cache[key] = scan
        while len(_cache) > _MAX_ENTRIES:
            _cache.pop(next(iter(_cache)))
    return scan


def prime(path: str) -> None:
    """Scan `path` into the cache now (p01's encode tail calls this right
    after a segment lands, while the file is still in page cache)."""
    get_scan(path)


def video(path: str) -> dict:
    """The video stream's packet arrays (scan_packets parity)."""
    return get_scan(path)["video"]


def audio(path: str) -> dict:
    """The audio stream's packet arrays; raises MediaError when the
    container has no audio stream (scan_packets parity)."""
    out = get_scan(path)["audio"]
    if out is None:
        raise medialib.MediaError(f"scan_packets({path}): no such stream")
    return out


def invalidate(path: str) -> None:
    """Drop every cached entry for `path` (any stat signature)."""
    path = os.path.abspath(path)
    prefix = f"{path}|"
    with _lock:
        for key in [k for k in _cache if k.startswith(prefix)]:
            _cache.pop(key)


def clear() -> None:
    """Drop the whole cache (tests)."""
    with _lock:
        _cache.clear()
