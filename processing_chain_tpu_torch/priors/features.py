"""Device-side MV-informed temporal features (the SI/TI siblings).

Where ops/siti.py measures structure from decoded *pixels*, this module
measures it from the coding metadata the encoder already paid to
compute: per-frame MV magnitude statistics (mean / p95), the divergence
of the block motion field (expansion/contraction — zooms and dolly
moves that pure magnitude misses), and the intra-coded block fraction
(how much of each inter frame the encoder gave up predicting — a strong
occlusion/scene-change cue). ANVIL (arXiv:2603.26835) and FAST
(arXiv:1603.08968) both build on exactly these compressed-domain cues.

Port of processing_chain_tpu/priors/features.py: `mv_magnitudes` and
`field_divergence` are torch functions on the given device; the ragged
per-frame reductions (`frame_mv_stats`, `intra_fraction`) and `mv_field`
stay host-side numpy, as in the reference (every clip has a
different total MV count, and the O(m) reductions cost less on the host
than a launch per frame would). The functions read any object with the
`PriorsData` fields they use (n_frames, n_mvs, mv_offsets, mv_rows,
mv_for, pict_type, has_mvs, height, width); the extraction and the
sidecar store wait for the port's io layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

#: MV row field indices (io/medialib.MV_FIELDS layout)
SRC_X, SRC_Y, DST_X, DST_Y, MV_W, MV_H, MV_SOURCE = range(7)

#: pict_type values (priors/model.py)
_PICT_I = 1


def mv_magnitudes(mv_rows, device=None) -> torch.Tensor:
    """Per-row displacement magnitude |dst - src| of [m, 7] MV rows (numpy
    or a tensor), f32 on `device`."""
    rows = torch.as_tensor(mv_rows).to(resolve_device(device), torch.float32)
    dx = rows[:, DST_X] - rows[:, SRC_X]
    dy = rows[:, DST_Y] - rows[:, SRC_Y]
    return torch.sqrt(dx * dx + dy * dy)


def _segment_ids(mv_offsets: np.ndarray) -> np.ndarray:
    """Frame id per MV row from the ragged offsets table."""
    counts = np.diff(mv_offsets)
    return np.repeat(np.arange(len(counts)), counts)


def frame_mv_stats(data) -> dict[str, np.ndarray]:
    """Per-frame MV summary for a PriorsData: {"mean_mag", "p95_mag",
    "mv_count"} float32/int arrays of length n_frames (0 magnitude for
    frames without MVs — I frames, and codecs that export none).
    Host-side numpy on purpose: the ragged total-MV shape differs per
    clip, and a jit'd reduction would recompile per clip (see module
    docstring)."""
    n = data.n_frames
    if n == 0 or data.n_mvs == 0:
        zero = np.zeros(n, np.float32)
        return {"mean_mag": zero, "p95_mag": zero.copy(),
                "mv_count": np.zeros(n, np.int64)}
    seg = _segment_ids(data.mv_offsets)
    rows = data.mv_rows.astype(np.float32)
    mags = np.hypot(rows[:, DST_X] - rows[:, SRC_X],
                    rows[:, DST_Y] - rows[:, SRC_Y])
    counts = np.diff(data.mv_offsets)
    sums = np.bincount(seg, weights=mags, minlength=n)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    # p95 is inherently order-statistic: compute per frame on the ragged
    # spans host-side (bounded by MV count, not pixels — cheap)
    p95 = np.zeros(n, np.float32)
    for i in np.nonzero(counts)[0]:
        p95[i] = np.percentile(mags[data.mv_offsets[i]:data.mv_offsets[i + 1]],
                               95.0)
    return {"mean_mag": mean.astype(np.float32), "p95_mag": p95,
            "mv_count": counts.astype(np.int64)}


def mv_field(data, i: int, block: int = 16) -> np.ndarray:
    """Dense block motion field of frame `i`: [gh, gw, 2] float32 of
    (dx, dy) per `block`-pixel cell (cells without an MV stay 0)."""
    gh = max(1, (data.height + block - 1) // block)
    gw = max(1, (data.width + block - 1) // block)
    field = np.zeros((gh, gw, 2), np.float32)
    rows = data.mv_for(i)
    if rows.shape[0] == 0:
        return field
    cx = np.clip(rows[:, DST_X] // block, 0, gw - 1)
    cy = np.clip(rows[:, DST_Y] // block, 0, gh - 1)
    field[cy, cx, 0] = rows[:, DST_X] - rows[:, SRC_X]
    field[cy, cx, 1] = rows[:, DST_Y] - rows[:, SRC_Y]
    return field


def field_divergence(field, device=None) -> torch.Tensor:
    """Mean |divergence| of a [gh, gw, 2] motion field (numpy or a tensor)
    via central differences, on `device` — near 0 for pans (uniform
    motion), large for zooms."""
    field = torch.as_tensor(field).to(resolve_device(device), torch.float32)
    vx, vy = field[..., 0], field[..., 1]
    dvx = (torch.roll(vx, -1, dims=1) - torch.roll(vx, 1, dims=1)) * 0.5
    dvy = (torch.roll(vy, -1, dims=0) - torch.roll(vy, 1, dims=0)) * 0.5
    return torch.mean(torch.abs(dvx + dvy))


def frame_divergence(data, block: int = 16, device=None) -> np.ndarray:
    """Per-frame mean |divergence| of the block motion field, each field
    built on the host and reduced on `device`."""
    device = resolve_device(device)
    out = np.zeros(data.n_frames, np.float32)
    for i in range(data.n_frames):
        if data.mv_offsets[i + 1] > data.mv_offsets[i]:
            out[i] = float(field_divergence(mv_field(data, i, block), device))
    return out


def intra_fraction(data) -> np.ndarray:
    """Per-frame fraction of frame area NOT covered by inter-predicted
    (MV-carrying) blocks: 1.0 for I frames by definition; for P/B frames
    a high value means the encoder fell back to intra coding — occlusion,
    scene change, or motion too complex to predict."""
    n = data.n_frames
    out = np.ones(n, np.float32)
    area = float(max(1, data.width * data.height))
    for i in range(n):
        if data.pict_type[i] == _PICT_I:
            continue
        rows = data.mv_for(i)
        if rows.shape[0] == 0:
            # no MV export for this codec/frame: no coverage claim — keep
            # 1.0 only for genuine I frames, report NaN-free neutral 0
            out[i] = 0.0 if not data.has_mvs() else 1.0
            continue
        # bi-predicted blocks export one MV row PER DIRECTION (source
        # -1/+1) over the same pixels — dedup by block anchor so a B
        # frame's covered area isn't double-counted
        uniq = np.unique(rows[:, [DST_X, DST_Y, MV_W, MV_H]], axis=0)
        covered = float((uniq[:, 2].astype(np.int64)
                         * uniq[:, 3].astype(np.int64)).sum())
        out[i] = float(np.clip(1.0 - covered / area, 0.0, 1.0))
    return out


def temporal_features(data, device=None) -> dict[str, np.ndarray]:
    """The consumer-facing bundle: per-frame arrays
    mean_mag / p95_mag / mv_count / divergence / intra_fraction (the
    divergence reduced on `device`)."""
    device = resolve_device(device)
    stats = frame_mv_stats(data)
    stats["divergence"] = frame_divergence(data, device=device)
    stats["intra_fraction"] = intra_fraction(data)
    return stats
