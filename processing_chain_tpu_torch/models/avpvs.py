"""AVPVS model — the p03 pixel-domain render core (port of the device
seam of processing_chain_tpu/models/avpvs.py: CHUNK/chunk_frames :47-78,
the SI/TI sidecar :370-432, `_pump_ready` :504-534, and the stalling
pass: SPINNER_KINEMATICS, `load_spinner`, `insert_stall_silence`,
`make_stall_compositor` :1069-1202 and the body of `apply_stalling.run`
:1254-1281).

Per chunk of decoded frames: host→device copy (double-buffered,
parallel/pipeline.iter_device_ahead) → bicubic resize of Y, U and V to the
AVPVS canvas (models/frames.scale_yuv_frames) → round and saturate to the
container depth (quantize_device) → per-frame SI and TI of the quantized
luma, TI carried across chunk edges (SiTiAccumulator) → hand-off to the
writer, which owns the device→host fetch. The stalling pass composites
a spinner (or freezes frames) over the quantized frames on the device
(`make_stall_compositor`, `pump_stalled`). Decode, the FFV1 writer,
`apply_stalling`'s job and probe, and the p03 stage around this seam are
not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..engine import prefetch as pfe
from ..ops import overlay as ov
from ..ops import siti as siti_ops
from ..parallel.pipeline import iter_device_ahead
from ..utils import fsio
from ..utils.device import resolve_device
from . import frames as fr

CHUNK = 64  # frames per device batch (accelerator default; see chunk_frames)

DEFAULT_SPINNER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "spinner-128-white.png",
)


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


def _host(x) -> np.ndarray:
    """A feature array on the host: tensors are fetched, numpy passes."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
        si = np.concatenate([_host(s) for s in self.si])
        ti = np.concatenate([_host(t) for t in self.ti])

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
