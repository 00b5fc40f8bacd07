"""The device half of the SRC corpus analysis: the SI/TI summary of a SRC
(port of the body of `src_siti_summary`,
processing_chain_tpu/tools/src_analysis.py:86-122).

The decoded SRC comes in as chunks; its luma goes to the device and
through the same SI and TI kernels as the p03 sidecars, at container
depth. Values are reported on the 8-bit scale whatever the depth: SI and
TI are standard deviations of linear functions of the luma, so scaling
the results of 10-bit luma by 0.25 equals scaling the planes first. The
md5 sidecars and `analyse_src` (the probe, the `.yaml` sidecar) wait for
the port's io layer.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..ops import siti as siti_ops
from ..parallel.pipeline import iter_device_ahead
from ..utils.device import resolve_device


def src_siti_frames(chunks: Iterable, device=None) -> tuple[np.ndarray, np.ndarray]:
    """(SI[n], TI[n]) of a decoded SRC on the 8-bit scale, f32 on the host:
    `chunks` yields lists of [T, H, W] planes (Y first; numpy or CPU
    tensors, u8 or u16). Only the luma is copied to `device`; TI carries
    across chunks and TI[0] = 0."""
    device = resolve_device(device)
    si_parts, ti_parts = [], []
    prev = None
    depth_scale = 1.0
    for _, (y,) in iter_device_ahead(([planes[0]] for planes in chunks), device):
        depth_scale = 0.25 if y.dtype == torch.uint16 else 1.0
        si_parts.append(siti_ops.si_frames(y))
        ti, prev = siti_ops.ti_frames_continued(y, prev)
        ti_parts.append(ti)
    si = torch.cat(si_parts).cpu().numpy() * np.float32(depth_scale)
    ti = torch.cat(ti_parts).cpu().numpy() * np.float32(depth_scale)
    return si, ti


def summarize_siti(si: np.ndarray, ti: np.ndarray) -> dict:
    """Mean, max and 95th percentile of per-frame SI and TI, rounded to 4
    places (the reference's summary record)."""
    return {
        "si_mean": round(float(si.mean()), 4),
        "si_max": round(float(si.max()), 4),
        "si_p95": round(float(np.percentile(si, 95)), 4),
        "ti_mean": round(float(ti.mean()), 4),
        "ti_max": round(float(ti.max()), 4),
        "ti_p95": round(float(np.percentile(ti, 95)), 4),
    }


def src_siti_summary(chunks: Iterable, device=None) -> dict:
    """Device-computed SI/TI summary of a decoded SRC (mean/max/p95 over
    frames, 8-bit scale); O(chunk) device memory for any SRC length."""
    return summarize_siti(*src_siti_frames(chunks, device))
