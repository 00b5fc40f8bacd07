"""AVPVS model — the p03 pixel-domain render core (port of the device
seam of processing_chain_tpu/models/avpvs.py: CHUNK/chunk_frames :47-78,
the SI/TI sidecar :370-432 and `_pump_ready` :504-534).

Per chunk of decoded frames: host→device copy (double-buffered,
parallel/pipeline.iter_device_ahead) → bicubic resize of Y, U and V to the
AVPVS canvas (models/frames.scale_yuv_frames) → round and saturate to the
container depth (quantize_device) → per-frame SI and TI of the quantized
luma, TI carried across chunk edges (SiTiAccumulator) → hand-off to the
writer, which owns the device→host fetch. Decode, the FFV1 writer, the
stalling pass and the p03 stage around this seam are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..ops import siti as siti_ops
from ..parallel.pipeline import iter_device_ahead
from ..utils import fsio
from ..utils.device import resolve_device
from . import frames as fr

CHUNK = 64  # frames per device batch (accelerator default; see chunk_frames)


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
    pinned = _env_int("PC_CHUNK_FRAMES")
    if pinned is not None:
        return max(1, pinned)
    return CHUNK if resolve_device(device).type == "cuda" else 16


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

    def write(self, avpvs_path: str) -> Optional[str]:
        if not self.si:
            return None
        path = siti_sidecar_path(avpvs_path)
        si = np.concatenate([s.cpu().numpy() for s in self.si])
        ti = np.concatenate([t.cpu().numpy() for t in self.ti])

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
               pix_fmt: str, device=None) -> None:
    """Host chunks (lists of [T, H, W] Y, U, V planes) → device resize to
    the h×w canvas (+ SI/TI features) → `writer.put(planes, recycle=chunk)`
    with `planes` the quantized device tensors; the writer owns their
    device→host fetch. Copies are double-buffered (iter_device_ahead):
    chunk k+1's copy is issued while chunk k's compute is queued."""
    device = resolve_device(device)
    sub = fr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt
    for chunk, dev in iter_device_ahead(ready, device):
        scaled = fr.scale_yuv_frames(dev, h, w, "bicubic", sub)
        quant = fr.quantize_device(scaled, ten_bit)
        feat.update(quant[0])
        writer.put(quant, recycle=chunk)
