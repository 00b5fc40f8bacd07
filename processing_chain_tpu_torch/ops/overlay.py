"""Stalling / freeze rendering (port of processing_chain_tpu/ops/overlay.py:
`StallPlan` :58-75, `plan_stalling` :78-156, `prepare_spinner` :159-193,
`_blend_plane` :201-212, `_clip_crop_origin` :215-235, `render_core`
:238-305, `render_stalled_plane` :308-331, `make_sharded_stall_renderer`
:334-375, `downsample_alpha` :378-381, `estimate_spinner_rps` :389-426).

A host-side timeline plan (numpy, copied unchanged) plus a device-side
gather and alpha blend in plain torch ops on the frames' own device:

  * stall mode: at each buffer event [media_t, dur], insert round(dur*fps)
    frames showing a black frame (--black-frame) or the last played frame,
    composited with a rotating spinner; output length grows.
  * skipping mode (frame freeze): the frame at the event start repeats for
    the event duration while content underneath is skipped; output length
    is unchanged and no spinner is drawn.

The spinner kinematics (1 rev/s clockwise, phase continuous across
events) are the reference package's assumptions, not measurements of
`bufferer`. The blend is a separate f32 multiply and add per term, as the
reference's single-device (eager) route computes it, on every route of
the port: the mesh-sharded renderer too (where the reference's jitted
sharded route fuses it into an FMA). `estimate_spinner_rps` (numpy)
reads the rate back from a rendered clip, for tools/bufferer_calibrate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import BlockLayout

# ---------------------------------------------------------------------------
# Host: timeline planning (copied from the reference package)
# ---------------------------------------------------------------------------


@dataclass
class StallPlan:
    """Device-executable stalling timeline.

    src_idx[k]    source frame shown at output frame k (int32)
    stall_mask[k] 1 where frame k is an inserted stall frame
    black_mask[k] 1 where the background is a black frame
    phase[k]      spinner rotation phase index (into the rotation bank)
    """

    src_idx: np.ndarray
    stall_mask: np.ndarray
    black_mask: np.ndarray
    phase: np.ndarray

    @property
    def n_out(self) -> int:
        return len(self.src_idx)


def buff_event_pairs(buff_events) -> list:
    """Buffer events as (media time, duration) float pairs, in their
    order: a pair passes through, and bare durations (the .buff freeze
    format, which carries no positions) freeze back to back from t=0."""
    pairs = []
    t_cursor = 0.0
    for ev in buff_events:
        if isinstance(ev, (list, tuple)):
            pairs.append((float(ev[0]), float(ev[1])))
        else:
            pairs.append((t_cursor, float(ev)))
            t_cursor += float(ev)
    return pairs


def plan_stalling(
    n_frames: int,
    fps: float,
    buff_events: list,
    skipping: bool = False,
    black_frame: bool = True,
    spinner_rps: float = 1.0,
    n_rotations: int = 64,
) -> StallPlan:
    """Expand buffer events into a per-output-frame plan.

    buff_events: [[media_time_s, duration_s], ...] for stalls, or a bare
    list of durations for freezes in skipping mode (the .buff freeze format,
    reference test_config.py:318-322) — bare durations freeze back-to-back
    from t=0 since the freeze format carries no positions.
    """
    if skipping:
        events = buff_event_pairs(buff_events)
        src_idx = np.arange(n_frames, dtype=np.int32)
        stall = np.zeros(n_frames, np.int8)
        for t, d in events:
            start = int(round(t * fps))
            end = min(n_frames, int(round((t + d) * fps)))
            if start >= n_frames:
                continue
            src_idx[start:end] = src_idx[start]
            stall[start:end] = 1
        return StallPlan(
            src_idx=src_idx,
            stall_mask=stall,
            black_mask=np.zeros(n_frames, np.int8),
            phase=np.zeros(n_frames, np.int32),
        )

    events = sorted((float(e[0]), float(e[1])) for e in buff_events)
    src_idx: list[int] = []
    stall: list[int] = []
    black: list[int] = []
    phase: list[int] = []
    spin_count = 0
    next_src = 0
    for t, d in events:
        event_frame = min(n_frames, int(round(t * fps)))
        while next_src < event_frame:
            src_idx.append(next_src)
            stall.append(0)
            black.append(0)
            phase.append(0)
            next_src += 1
        n_stall = int(round(d * fps))
        for _ in range(n_stall):
            # background: black frame or the last played frame
            src_idx.append(max(0, next_src - 1))
            stall.append(1)
            black.append(1 if black_frame else 0)
            phase.append(
                int(spin_count * spinner_rps * n_rotations / fps) % n_rotations
            )
            spin_count += 1
    while next_src < n_frames:
        src_idx.append(next_src)
        stall.append(0)
        black.append(0)
        phase.append(0)
        next_src += 1
    return StallPlan(
        src_idx=np.asarray(src_idx, np.int32),
        stall_mask=np.asarray(stall, np.int8),
        black_mask=np.asarray(black, np.int8),
        phase=np.asarray(phase, np.int32),
    )


def prepare_spinner(
    spinner_rgba: np.ndarray, n_rotations: int = 64
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute the rotation bank for a spinner image.

    spinner_rgba: [H, W, 4] uint8 (e.g. the reference's
    util/spinner-128-white.png). Returns (yuv [R, 3, H, W] float32 in 0-255,
    alpha [R, H, W] float32 in 0-1), rotated counterclockwise per phase.
    """
    import scipy.ndimage as ndi

    # even dimensions are an invariant downstream: the chroma bank is the
    # ::2 decimation of this bank, and render_core's chroma-grid crop
    # alignment (crop_align) relies on bank dims dividing evenly — trim a
    # stray odd row/column from user-supplied PNGs here, at the single
    # bank entry point
    h, w = spinner_rgba.shape[:2]
    spinner_rgba = spinner_rgba[: h - (h % 2), : w - (w % 2)]

    r, g, b = (spinner_rgba[..., c].astype(np.float32) for c in range(3))
    a = spinner_rgba[..., 3].astype(np.float32) / 255.0
    # BT.601 limited-range YUV (matches ffmpeg overlay of RGBA onto yuv420p)
    y = 0.257 * r + 0.504 * g + 0.098 * b + 16.0
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
    yuvs, alphas = [], []
    for k in range(n_rotations):
        angle = -360.0 * k / n_rotations  # clockwise spin
        rot = lambda img, cval: ndi.rotate(  # noqa: E731 - verbatim copy
            img, angle, reshape=False, order=1, mode="constant", cval=cval
        )
        ak = np.clip(rot(a, 0.0), 0.0, 1.0)
        yuvs.append(np.stack([rot(y, 16.0), rot(u, 128.0), rot(v, 128.0)]))
        alphas.append(ak)
    return np.stack(yuvs), np.stack(alphas)


def downsample_alpha(alpha: np.ndarray) -> np.ndarray:
    """[R, H, W] alpha → chroma-grid alpha [R, H/2, W/2] (2x2 mean)."""
    return alpha.reshape(alpha.shape[0], alpha.shape[1] // 2, 2,
                         alpha.shape[2] // 2, 2).mean(axis=(2, 4))


def _clip_crop_origin(
    frame_dim: int, spinner_dim: int, align: int, grid_scale: int = 1
) -> int:
    """Crop origin for a spinner larger than the frame, matching ffmpeg's
    overlay clipping exactly. ffmpeg computes the placement coordinate on
    the LUMA grid — (luma_frame - luma_spinner)/2 truncated toward zero (C
    integer division), then masked toward -inf on the chroma grid
    (normalize_xy: x &= ~((1<<hsub)-1)) — and shifts it down by hsub/vsub
    for chroma planes; the crop keeps the pixels at -placement. Callers on
    a subsampled plane pass grid_scale=sub so the SAME luma coordinate is
    reconstructed and divided back (exact: the mask makes it a multiple of
    sub), keeping chroma locked to luma. E.g. luma frame 90, spinner 128,
    align 2: trunc(-19) & ~1 = -20 -> crop origin 20 (not 18, which a
    positive floor-to-grid would give); the 420 chroma plane (45 under 64,
    grid_scale 2) lands on 10 == 20/2."""
    if spinner_dim <= frame_dim:  # fits on this axis: nothing to crop
        return 0
    lf, ls = frame_dim * grid_scale, spinner_dim * grid_scale
    place = -((ls - lf) // 2)  # trunc toward 0: place <= 0
    place &= ~(align - 1)  # Python & on negatives == two's-complement mask
    return -place // grid_scale


# ---------------------------------------------------------------------------
# Device: gather + composite
# ---------------------------------------------------------------------------


def _blend_plane(bg: torch.Tensor, fg: torch.Tensor, alpha: torch.Tensor,
                 y0: int, x0: int) -> None:
    """Alpha-composite fg [T, h, w] (with alpha [T, h, w]) onto bg
    [T, H, W] at (y0, x0), in place. The region must lie inside bg (the
    reference's dynamic_slice would clamp an out-of-range origin)."""
    h, w = fg.shape[-2], fg.shape[-1]
    if not (0 <= y0 and y0 + h <= bg.shape[-2] and 0 <= x0 and x0 + w <= bg.shape[-1]):
        raise ValueError(
            f"_blend_plane: a {h}x{w} overlay at ({y0}, {x0}) leaves the "
            f"{bg.shape[-2]}x{bg.shape[-1]} frame"
        )
    region = bg[..., y0:y0 + h, x0:x0 + w]
    # one rounding per multiply and per add, in this order (no fused
    # multiply-add, no lerp): the reference's eager f32 arithmetic
    bg[..., y0:y0 + h, x0:x0 + w] = region * (1.0 - alpha) + fg * alpha


def to_device(x, device) -> torch.Tensor:
    """A tensor or numpy array as a tensor on `device`. A numpy array goes
    to a CUDA device through pinned memory, so the copy is queued on the
    stream instead of waiting for the work already queued there."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def render_core(
    frames: torch.Tensor,
    stall: torch.Tensor,
    black: torch.Tensor,
    phase: torch.Tensor,
    spinner,
    spinner_alpha,
    black_value: float,
    crop_align: tuple[int, int] = (1, 1),
    grid_scale: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Composite of pre-gathered f32 frames [T, H, W] with per-frame
    stall/black masks [T] and spinner phase indices [T], on the frames'
    device. `spinner` / `spinner_alpha` are [R, h, w] banks (tensors or
    numpy arrays) or None.

    crop_align is the ffmpeg normalize_xy mask on the LUMA grid (the
    content's chroma subsampling); grid_scale relates THIS plane's grid to
    the luma grid (1 for luma, sub for chroma planes), so all planes
    derive their crop/placement from the same masked luma coordinate."""
    h, w = frames.shape[-2], frames.shape[-1]
    dev = frames.device
    stall_b = to_device(stall, dev).to(torch.float32)[:, None, None]
    black_b = to_device(black, dev).to(torch.float32)[:, None, None]
    out = frames * (1.0 - black_b) + black_value * black_b
    if spinner is not None:
        # phases are modulo the actual rotation-bank size, so a plan built
        # with a different n_rotations still indexes in range
        phases = to_device(phase, dev).to(torch.int64) % spinner.shape[0]
        align_h, align_w = crop_align
        gs_h, gs_w = grid_scale
        if (h * gs_h) % align_h or (w * gs_w) % align_w:
            # the chroma-lock arithmetic needs the luma dims on the
            # chroma grid; the domain model guarantees even dims
            raise ValueError(
                f"render_core: luma-grid plane {h * gs_h}x{w * gs_w} not "
                f"divisible by crop_align {crop_align}"
            )
        # a spinner larger than the frame is center-cropped to fit — the
        # same pixels ffmpeg's overlay keeps when a centered overlay
        # extends past the main frame (clipping)
        sh, sw = spinner.shape[-2], spinner.shape[-1]
        ch, cw = min(sh, h), min(sw, w)
        if (ch, cw) != (sh, sw):
            cy = _clip_crop_origin(h, sh, align_h, gs_h)
            cx = _clip_crop_origin(w, sw, align_w, gs_w)
            spinner = spinner[..., cy:cy + ch, cx:cx + cw]
            spinner_alpha = spinner_alpha[..., cy:cy + ch, cx:cx + cw]
        sp = torch.index_select(to_device(spinner, dev), 0, phases)
        sa = torch.index_select(to_device(spinner_alpha, dev), 0, phases)
        sa = sa * stall_b  # only composite on stall frames
        # placement offsets come off the same masked luma coordinate as
        # the crop (ffmpeg overlay masks x/y via hsub/vsub then shifts by
        # the plane's subsampling); positive mask == floor-to-grid
        y0 = (((h - ch) * gs_h // 2) & ~(align_h - 1)) // gs_h
        x0 = (((w - cw) * gs_w // 2) & ~(align_w - 1)) // gs_w
        _blend_plane(out, sp, sa, y0, x0)
    return out


def render_stalled_plane(
    frames: torch.Tensor,
    plan: StallPlan,
    spinner=None,
    spinner_alpha=None,
    black_value: float = 16.0,
    crop_align: tuple[int, int] = (1, 1),
    grid_scale: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Apply a StallPlan to one f32 plane tensor [T, H, W] (0-255 scale)
    on its own device.

    spinner: [R, h, w] rotation bank for THIS plane (chroma callers pass the
    subsampled bank), spinner_alpha likewise [R, h, w]. All callers of
    subsampled content pass crop_align=(sub_h, sub_w); chroma callers
    additionally pass grid_scale=(sub_h, sub_w) (see render_core).
    Returns [T_out, H, W]."""
    idx = to_device(np.asarray(plan.src_idx, np.int64), frames.device)
    gathered = torch.index_select(frames, 0, idx)
    return render_core(
        gathered, plan.stall_mask, plan.black_mask, plan.phase,
        spinner, spinner_alpha, black_value, crop_align, grid_scale,
    )


def make_sharded_stall_renderer(mesh, banks: tuple, black_values: tuple, ten_bit: bool,
                                chroma_sub: tuple[int, int] = (1, 1)):
    """The stall composite sharded frame-parallel over every slot of `mesh`
    (parallel/mesh.py): `step(y, u, v, stall, black, phase)` → the three
    planes quantized to container depth, joined on the mesh's first
    device. The blend is frame-local: the frames (whose count must be a
    multiple of the mesh's local slot count; callers pad by repeating the
    last frame) are dealt to the slots in row-major order, and each device
    composites its slots' frames as one batch, a plane at a time in f32.
    `banks` = (sp_y, sa_y, sp_u, sp_v, sa_c) or Nones (skipping mode): U
    and V carry distinct banks; `black_values` are per-plane background
    levels. Rounding is the single-device route's: separate f32 multiplies
    and an add, then floor(x + 0.5) and a clip."""
    hi, dt = (1023.0, torch.uint16) if ten_bit else (255.0, torch.uint8)
    p0, p1, _, _ = mesh.local_box()
    n_rows = p1 - p0
    n_slots = len(mesh.devices)
    dev_banks = {d: tuple(None if b is None else to_device(b, d) for b in banks)
                 for d in dict.fromkeys(mesh.devices)}
    planes_of = (  # (bank index, alpha index, grid scale) per plane
        (0, 1, (1, 1)), (2, 4, chroma_sub), (3, 4, chroma_sub))

    def step(y, u, v, stall, black, phase):
        t = y.shape[0]
        if t % n_slots:
            raise ValueError(
                f"sharded stall renderer: {t} frames do not split over {n_slots} slots; "
                "pad them by repeating the last frame")
        lay = BlockLayout(mesh, n_rows, t // n_rows)
        masks = [lay.split((m if isinstance(m, torch.Tensor)
                            else torch.from_numpy(np.ascontiguousarray(m))).reshape(n_rows, -1))
                 for m in (stall, black, phase)]
        outs = []
        for plane, bv, (ib, ia, gs) in zip((y, u, v), black_values, planes_of):
            size = tuple(plane.shape[1:])
            parts = lay.split(plane.reshape((n_rows, -1) + size))
            res = {}
            for dev, part in parts.items():
                f = part.reshape((-1,) + size).to(torch.float32)
                r = render_core(f, *(m[dev].reshape(-1) for m in masks),
                                dev_banks[dev][ib], dev_banks[dev][ia], bv, chroma_sub, gs)
                # a plane's f32 copies go before the next plane is lifted
                del f
                q = torch.clamp(torch.floor(r + 0.5), 0, hi).to(torch.int32).to(dt)
                del r
                res[dev] = q.reshape(tuple(part.shape))
            outs.append(lay.join(res).reshape((t,) + size))
        return tuple(outs)

    return step


# ---------------------------------------------------------------------------
# Calibration: recover spinner kinematics from a rendered clip
# ---------------------------------------------------------------------------


def estimate_spinner_rps(
    frames: np.ndarray, fps: float
) -> tuple[float, float]:
    """Estimate the spinner's angular rate from stall-zone luma frames.

    frames: [T, H, W] luma of consecutive stall frames, cropped roughly to
    the spinner region (dark background). Method: the luminance-weighted
    centroid of a rotationally-asymmetric spinner (the reference spinner's
    gradient tail) traces a circle; the unwrapped centroid angle against
    frame index gives rad/frame, hence revolutions/second.

    Returns (rps, residual): rps > 0 means clockwise on screen (image y
    points down); residual is the RMS of the linear-fit error in radians —
    large residual means the clip wasn't a steadily rotating spinner.
    """
    t = frames.shape[0]
    if t < 3:
        raise ValueError("need at least 3 stall frames to estimate a rate")
    h, w = frames.shape[1:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    angles = np.empty(t)
    for k, f in enumerate(np.asarray(frames, np.float64)):
        wgt = np.clip(f - f.min(), 0, None)
        s = wgt.sum()
        if s <= 0:
            raise ValueError(f"stall frame {k} is uniform; cannot locate spinner")
        angles[k] = np.arctan2(
            (wgt * yy).sum() / s - cy, (wgt * xx).sum() / s - cx
        )
    ang = np.unwrap(angles)
    n = np.arange(t)
    slope, intercept = np.polyfit(n, ang, 1)
    resid = float(np.sqrt(np.mean((ang - (slope * n + intercept)) ** 2)))
    return float(slope * fps / (2.0 * np.pi)), resid
