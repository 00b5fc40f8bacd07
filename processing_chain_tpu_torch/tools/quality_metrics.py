"""The device half of the full-reference quality tool: per-frame PSNR
(Y, U, V), SSIM, MS-SSIM, VIF, SI and TI of an AVPVS against its SRC
(port of processing_chain_tpu/tools/quality_metrics.py:56-160 and of the
loop body of `compute_pvs_metrics`, :334-404).

Both clips come in as decoded chunks: `_paired_chunks` puts the SRC frames
on the AVPVS timeline (`_src_index_map`), `score_chunks` scores each pair
on the device and returns the table, and `write_metrics_csv` writes it as
the reference's `<pvs_id>.metrics.csv`. 10-bit planes are normalized to
the 8-bit scale before comparison; the SRC is resized onto the AVPVS grid
in f32 (bicubic, the `banded` matrix products on the card). SI and TI run
on the AVPVS luma at its container depth through the SI/TI kernels, and
the results are scaled onto the 8-bit scale: they are standard deviations
of linear functions of the luma, so this equals the reference's SI/TI of
the scaled f32 luma. `compute_pvs_metrics` itself (the `Pvs`, the video
readers, the probe) waits for the port's io layer.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..engine import prefetch as pf
from ..ops import metrics as metrics_ops
from ..ops import overlay as ov
from ..ops import resize as resize_ops
from ..ops import siti as siti_ops
from ..utils.device import resolve_device
from ..utils.fsio import atomic_write

CHUNK = 32


def metric_columns(msssim: bool = False, vif: bool = False) -> list[str]:
    """The table's metric columns in the reference's declarative order
    (msssim_y always before vif_y, both between ssim_y and si)."""
    return (
        ["psnr_y", "psnr_u", "psnr_v", "ssim_y"]
        + (["msssim_y"] if msssim else [])
        + (["vif_y"] if vif else [])
        + ["si", "ti"]
    )


def _metric_frames(ry, dy, ru, du, rv, dv, with_ssim: bool = True) -> dict:
    """Per-frame PSNR(Y/U/V) + SSIM(Y) of one chunk of f32 planes on one
    device (the reference's single-device route); values stay on the
    planes' device."""
    out = {
        "psnr_y": metrics_ops.psnr_frames(ry, dy),
        "psnr_u": metrics_ops.psnr_frames(ru, du),
        "psnr_v": metrics_ops.psnr_frames(rv, dv),
    }
    if with_ssim:
        out["ssim_y"] = metrics_ops.ssim_frames(ry, dy)
    return out


def _src_index_map(
    rate: float,
    src_fps: float,
    events: Optional[list] = None,
    n_avpvs: int = 0,
    has_freeze: bool = False,
) -> Callable[[int], int]:
    """out_index(k): SRC frame index aligned to AVPVS output frame k.

    Without stall events (or with a frame-freeze HRC, whose AVPVS keeps the
    original length) the AVPVS timeline is the SRC timeline. With stall
    `events` ([[media_time_s, duration_s], ...]) the renderer inserted
    round(d * rate) frames per event, so the played media time of output k
    comes from the same StallPlan the renderer used, built over the
    n_avpvs − inserted played frames of the rendered AVPVS: during a stall
    the SRC holds the last played frame."""
    if not events or has_freeze:
        return lambda k: int(np.floor(k / rate * src_fps + 0.5))
    n_stall = sum(int(round(float(e[1]) * rate)) for e in events)
    plan = ov.plan_stalling(max(n_avpvs - n_stall, 1), rate, events)
    src_idx = plan.src_idx  # played-frame index per output frame

    def out_index(k: int) -> int:
        j = src_idx[min(k, len(src_idx) - 1)]
        return int(np.floor(j / rate * src_fps + 0.5))

    return out_index


def _paired_chunks(
    deg_chunks: Iterable,
    ref_frames: Iterable,
    out_index: Callable[[int], int],
    chunk: int = CHUNK,
) -> Iterator[tuple[list, list]]:
    """Yield ((deg_y, deg_u, deg_v), (ref_y, ref_u, ref_v)) chunk pairs on
    the AVPVS timeline: the SRC frame for output k is out_index(k)
    (monotonic, so both clips stream once). `ref_frames` yields objects
    whose `.planes` are tensors (`engine.prefetch.iter_chunk_frames`);
    the pairs stop where either side ends."""
    # the output count is unknown up front (it follows the AVPVS stream):
    # gather the SRC lazily and stop when the AVPVS side ends
    ref_it = pf.stream_monotonic_gather(ref_frames, out_index, 10**9, chunk)
    for deg_chunk in deg_chunks:
        ref_chunk = next(ref_it, None)
        if ref_chunk is None:
            break
        n = min(deg_chunk[0].shape[0], ref_chunk[0].shape[0])
        yield [p[:n] for p in deg_chunk], [p[:n] for p in ref_chunk]


def _on_device(plane, device) -> torch.Tensor:
    if not isinstance(plane, torch.Tensor):
        plane = torch.from_numpy(np.ascontiguousarray(plane))
    return plane.to(device)


def _host(parts: list) -> np.ndarray:
    if not parts:
        return np.empty(0)
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).cpu().numpy()
    return np.concatenate(parts)


def score_chunks(
    pairs: Iterable,
    msssim: bool = False,
    vif: bool = False,
    sidecar=None,
    device=None,
    resize_method: str = "auto",
) -> dict[str, np.ndarray]:
    """Score (deg_chunk, ref_chunk) pairs of [T, H, W] Y, U, V planes at
    their container depths (u8, or u16 holding 10-bit samples; numpy or
    tensors) on `device`; returns the table {"frame", *metric_columns}.

    `sidecar` (a mapping with per-frame "si" and "ti" at the AVPVS's
    container depth, as the p03 pass writes them) is reused for the SI and
    TI columns instead of computing them; the caller checks that it covers
    the AVPVS. `resize_method` is `ops.resize.resize_plane`'s method for the
    SRC's resize onto the AVPVS grid."""
    device = resolve_device(device)
    cols = metric_columns(msssim, vif)
    rows = {k: [] for k in cols}
    prev_last = None  # last deg luma of the previous chunk (TI continuity)
    deg_scale = 1.0
    for deg_chunk, ref_chunk in pairs:
        deg = [_on_device(p, device) for p in deg_chunk]
        ref = [_on_device(p, device) for p in ref_chunk]
        # 10-bit planes hold 0..1023: bring both clips onto the 8-bit scale
        # so the peak=255 PSNR and the SSIM constants hold for every depth
        deg_scale = 0.25 if deg[0].dtype == torch.uint16 else 1.0
        ref_scale = 0.25 if ref[0].dtype == torch.uint16 else 1.0
        dy, du, dv = (p.to(torch.float32) * deg_scale for p in deg)
        ry, ru, rv = (
            resize_ops.resize_plane(r.to(torch.float32) * ref_scale, d.shape[-2],
                                    d.shape[-1], "bicubic", method=resize_method)
            for r, d in zip(ref, (dy, du, dv))
        )
        chunk_metrics = _metric_frames(ry, dy, ru, du, rv, dv, with_ssim=not msssim)
        if msssim:
            # the combined pass also yields plain SSIM from its scale-1
            # filtering, so the full-resolution planes are filtered once
            ms, s1 = metrics_ops.msssim_ssim_frames(ry, dy)
            chunk_metrics["msssim_y"] = ms
            chunk_metrics.setdefault("ssim_y", s1)
        if vif:
            chunk_metrics["vif_y"] = metrics_ops.vif_frames(ry, dy)
        for k, vals in chunk_metrics.items():
            rows[k].append(vals)
        if sidecar is None:
            rows["si"].append(siti_ops.si_frames(deg[0]) * deg_scale)
            ti, prev_last = siti_ops.ti_frames_continued(deg[0], prev_last)
            rows["ti"].append(ti * deg_scale)
        del deg, ref, dy, du, dv, ry, ru, rv

    if sidecar is not None:
        n_paired = sum(len(r) for r in rows["psnr_y"])
        rows["si"] = [np.asarray(sidecar["si"])[:n_paired] * deg_scale]
        rows["ti"] = [np.asarray(sidecar["ti"])[:n_paired] * deg_scale]

    table = {k: _host(v) for k, v in rows.items()}
    return {"frame": np.arange(len(table["psnr_y"])), **table}


def _csv_cells(values: np.ndarray) -> list[str]:
    """One column as pandas' `to_csv(float_format="%.5f")` prints it:
    integers as they are, floats at 5 decimals, NaN as an empty cell."""
    if np.issubdtype(values.dtype, np.integer):
        return [str(int(v)) for v in values]
    return ["" if np.isnan(v) else "%.5f" % v for v in values.astype(np.float64)]


def metrics_csv_text(table: dict) -> str:
    """The table as the text of the reference's
    `pd.DataFrame(table).to_csv(index=False, float_format="%.5f")`."""
    names = list(table)
    columns = [_csv_cells(np.asarray(table[k])) for k in names]
    lines = [",".join(names)] + [",".join(cells) for cells in zip(*columns)]
    return "\n".join(lines) + "\n"


def write_metrics_csv(path: str, table: dict) -> str:
    """Write the table to `path` (temp then rename) and return the path."""
    text = metrics_csv_text(table)

    def write(tmp: str) -> None:
        with open(tmp, "w", newline="") as f:
            f.write(text)

    atomic_write(path, write)
    return path
