"""Frame-rate conversion as gather index plans (copy of
processing_chain_tpu/ops/fps.py, held array-equal to it by
tests/test_torch_fps.py).

Parity targets: the reference's fps spec grammar (lib/ffmpeg.py:321-396 —
number, fraction, "original", "auto", "50/60", "24/25/30") and its
hand-built `select=` drop tables for each supported ratio
(lib/ffmpeg.py:806-832). Where the reference emits an ffmpeg select
expression evaluated per frame, we emit the equivalent index array once on
host. The port selects on the host, before the host-to-device copy, as the
JAX package's p01 does; `stream_select` takes chunks of numpy arrays or
tensors alike.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..config.domain import ConfigError

#: the reference's select tables, keyed by int(100 * dst/src) — each entry is
#: the set of source-frame phases kept per cycle (cycle_len, kept_phases)
#: (lib/ffmpeg.py:806-832). E.g. 60→24 keeps frames 0 and 3 of every 5.
_SELECT_TABLES: dict[float, tuple[int, tuple[int, ...]]] = {
    50.0: (2, (0,)),                    # mod(n+1,2): keeps even n
    40.0: (5, (0, 3)),                  # 60->24
    33.0: (3, (0,)),                    # 60->20, 24->8
    25.0: (4, (0,)),                    # 60->15, 24->6
    80.0: (5, (0, 1, 2, 3)),            # 30->24: mod(n+1,5) keeps n%5 != 4
    30.0: (10, (0, 3, 7)),              # 50->15
    60.0: (5, (0, 2, 3)),               # 25->15
    62.5: (8, (0, 2, 3, 5, 6)),         # 24->15
}


def resolve_fps_spec(fps_spec, src_fps: float) -> Optional[float]:
    """The reference's fps grammar (lib/ffmpeg.py:321-396). Returns the
    target fps, or None for keep-as-is."""
    if fps_spec in ("original", "auto"):
        return None
    if fps_spec == "24/25/30":
        if src_fps in (24, 25, 30):
            return None
        if src_fps == 50:
            return 25.0
        if src_fps in (60, 120):
            return 30.0
        raise ConfigError(f"unsupported SRC frame rate {src_fps} for 24/25/30")
    if fps_spec == "50/60":
        if src_fps in (50, 60):
            return None
        if src_fps < 50:
            raise ConfigError(f"fps requested as 50/60 but SRC has only {src_fps}")
        if src_fps == 120:
            return 60.0
        raise ConfigError(f"unsupported SRC frame rate {src_fps} for 50/60")
    if "/" in str(fps_spec):
        return src_fps * float(Fraction(str(fps_spec)))
    # the reference coerces with int() (lib/ffmpeg.py:388), silently
    # flooring a numeric 29.97 to 29 — a do-not-copy bug; non-integer
    # specs keep their value here (integer specs behave identically)
    return float(fps_spec)


def select_table(src_fps: float, dst_fps: float) -> tuple[int, tuple[int, ...]]:
    """(cycle_len, kept_phases) of the reference's drop table for
    src_fps → dst_fps; raises ConfigError for unsupported ratios exactly
    like the reference (lib/ffmpeg.py:827-829)."""
    perc = 100.0 * dst_fps / src_fps
    key = perc if perc in _SELECT_TABLES else float(int(perc))
    if key not in _SELECT_TABLES:
        raise ConfigError(
            f"Frame rate conversion from {src_fps} to {dst_fps} is not supported"
        )
    return _SELECT_TABLES[key]


def select_indices(n_frames: int, src_fps: float, dst_fps: float) -> np.ndarray:
    """Indices of source frames to keep for src_fps → dst_fps, using the
    reference's drop tables."""
    if dst_fps == src_fps:
        return np.arange(n_frames)
    cycle, phases = select_table(src_fps, dst_fps)
    n = np.arange(n_frames)
    mask = np.isin(n % cycle, phases)
    return n[mask]


def stream_select(chunks, src_fps: float, dst_fps: float):
    """Streaming select_indices: the drop mask is periodic in the SOURCE
    frame index, so it applies chunk-by-chunk with a running offset —
    O(chunk) memory for arbitrarily long windows. Chunks are per-plane
    [T, H, W] stacks; emitted chunks shrink to the kept frames (empty ones
    are dropped)."""
    if dst_fps == src_fps:
        yield from chunks
        return
    cycle, phases = select_table(src_fps, dst_fps)
    off = 0
    for chunk in chunks:
        n = chunk[0].shape[0]
        mask = np.isin((np.arange(n) + off) % cycle, phases)
        off += n
        if mask.any():
            yield [_take(p, mask) for p in chunk]


def _take(plane, mask: np.ndarray):
    """plane[mask] along the frame axis, for a numpy array or a tensor."""
    if isinstance(plane, np.ndarray):
        return plane[mask]
    return plane[torch.from_numpy(mask).to(plane.device)]


def fps_resample_indices(n_frames: int, src_fps: float, dst_fps: float) -> np.ndarray:
    """General ffmpeg `fps=` filter semantics (used where the reference
    applies a bare fps filter, e.g. AVPVS -z/-f60 paths): output frame k at
    time k/dst_fps duplicates/drops to the last source frame with
    pts <= k/dst_fps (+ half-tick rounding)."""
    duration = n_frames / src_fps
    n_out = int(round(duration * dst_fps))
    t_out = np.arange(n_out) / dst_fps
    idx = np.floor(t_out * src_fps + 0.5).astype(np.int64)
    return np.clip(idx, 0, n_frames - 1)
