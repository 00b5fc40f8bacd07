"""Calibrate the stalling renderer against a real `bufferer` output.

The reference chain shells out to the pip package `bufferer` for its
stalling pass (reference p03_generateAvPvs.py:242-243). Our device-side
re-implementation (ops/overlay.py) pins the parts of bufferer's behavior
that its CLI contract does not fix — spinner angular rate, rotation
direction, phase continuity across events — as documented assumptions.
This tool measures those quantities from an actual bufferer-produced clip,
so any environment that CAN run bufferer (this build environment cannot:
no network, package absent) can verify or replace the pinned constants:

    bufferer -i in.avi -o ref.avi -b "[[2.0,1.5]]" --force-framerate \
        --black-frame -v ffv1 -a pcm_s16le -x yuv420p -s spinner.png
    python -m processing_chain_tpu_torch.tools.bufferer_calibrate \
        ref.avi --events "[[2.0,1.5]]" --input-frames N_IN

Reports, per stall event and overall:
  * inserted frame count vs the planner's round(duration*fps);
  * whether stall backgrounds are black (--black-frame semantics);
  * estimated spinner revolutions/second + direction + fit residual
    (ops/overlay.estimate_spinner_rps);
  * whether rotation phase is continuous across events (compares the
    per-event fit intercepts under one global rate).

The port's copy of processing_chain_tpu/tools/bufferer_calibrate.py (numpy
over the port's io/video.VideoReader).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from ..io.video import VideoReader
from ..ops import overlay as ov


def _stall_spans(events: list, fps: float, n_in: int) -> list[tuple[int, int]]:
    """Output-frame [start, end) of each stall, per the planner's math."""
    plan = ov.plan_stalling(n_in, fps, events, skipping=False)
    spans = []
    k = 0
    while k < plan.n_out:
        if plan.stall_mask[k]:
            j = k
            while j < plan.n_out and plan.stall_mask[j]:
                j += 1
            spans.append((k, j))
            k = j
        else:
            k += 1
    return spans


def estimate_spinner_kinematics(
    frames: np.ndarray, fps: float
) -> tuple[float, float, float]:
    """(rps, phase0_rad, residual): like ops/overlay.estimate_spinner_rps
    but also recovering the spinner's angular PHASE at the clip's first
    frame — the quantity needed to verify phase continuity across stall
    events (the third ASSUMED kinematic constant). Same
    luminance-centroid method; phase0 is the linear fit's intercept,
    wrapped to (-pi, pi]. (The fit lines are duplicated from the ops/
    estimator, as in the JAX package's copy.)"""
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
    phase0 = float((intercept + np.pi) % (2.0 * np.pi) - np.pi)
    return float(slope * fps / (2.0 * np.pi)), phase0, resid


def _wrapped_diff(a: float, b: float) -> float:
    """|a - b| on the circle, in radians."""
    d = (a - b + np.pi) % (2.0 * np.pi) - np.pi
    return abs(float(d))


def calibrate(
    rendered_path: str,
    events: list,
    n_input_frames: int,
    crop: Optional[int] = None,
) -> dict:
    with VideoReader(rendered_path) as r:
        fps = r.fps
        planes, _ = r.read_all()
    luma = planes[0]  # always planar: the reader deinterleaves packed clips
    n_out = luma.shape[0]
    expected_inserted = sum(int(round(float(d) * fps)) for _, d in events)
    report: dict = {
        "fps": fps,
        "n_output_frames": n_out,
        "n_input_frames": n_input_frames,
        "inserted_frames": n_out - n_input_frames,
        "expected_inserted": expected_inserted,
        "insertion_matches_plan": (n_out - n_input_frames) == expected_inserted,
        "events": [],
    }
    spans = _stall_spans(events, fps, n_input_frames)
    h, w = luma.shape[1:]
    if crop is None:
        crop = min(h, w) // 2
    y0, x0 = (h - crop) // 2, (w - crop) // 2
    rates = []
    fits = []  # (span, rps, phase0) per measurable event
    for (a, b), (t, d) in zip(spans, sorted(map(tuple, events))):
        seg = luma[a:b, y0: y0 + crop, x0: x0 + crop]
        # background blackness: corners of the full frame, away from the
        # spinner (BT.601 limited-range black = 16)
        corners = luma[a:b, : h // 8, : w // 8]
        ev: dict = {
            "media_time": float(t),
            "duration": float(d),
            "frames": int(b - a),
            "background_black": bool(np.median(corners) <= 20),
        }
        if b - a >= 3:
            rps, phase0, resid = estimate_spinner_kinematics(seg, fps)
            ev["spinner_rps"] = round(rps, 4)
            ev["phase0_rad"] = round(phase0, 4)
            ev["fit_residual_rad"] = round(resid, 4)
            rates.append(rps)
            fits.append(((a, b), rps, phase0))
        report["events"].append(ev)
    if len(fits) >= 2:
        # phase continuity (third ASSUMED constant): under our model the
        # spinner advances only DURING stall frames, so event k+1's first
        # frame continues one step past event k's last. Compare measured
        # phase0 of each later event against the previous fit extrapolated
        # by its stall-frame count, on the circle.
        omega = 2.0 * np.pi * float(np.mean(rates)) / fps  # rad/frame
        ok = True
        deltas = []
        for ((a1, b1), _r1, p1), ((_a2, _b2), _r2, p2) in zip(fits, fits[1:]):
            expected = p1 + omega * (b1 - a1)
            deltas.append(round(_wrapped_diff(p2, expected), 4))
            ok = ok and deltas[-1] < 0.35  # ~1/18 rev tolerance
        report["phase_continuity_deltas_rad"] = deltas
        report["phase_continuous_across_events"] = bool(ok)
    if rates:
        report["spinner_rps_mean"] = round(float(np.mean(rates)), 4)
        report["spinner_direction"] = (
            "clockwise" if np.mean(rates) > 0 else "counterclockwise"
        )
        report["rate_consistent_across_events"] = bool(
            np.max(np.abs(np.asarray(rates) - np.mean(rates))) < 0.1
        )
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure bufferer's spinner/stall behavior from a "
        "rendered clip; prints a JSON report."
    )
    ap.add_argument("rendered", help="bufferer output clip (e.g. ref.avi)")
    ap.add_argument(
        "--events", required=True,
        help='stall events as JSON, e.g. "[[2.0, 1.5]]"',
    )
    ap.add_argument(
        "--input-frames", type=int, required=True,
        help="frame count of the clip BEFORE stalling insertion",
    )
    ap.add_argument(
        "--crop", type=int, default=None,
        help="center-crop size for the spinner region (default: half frame)",
    )
    args = ap.parse_args(argv)
    report = calibrate(
        args.rendered, json.loads(args.events), args.input_frames, args.crop
    )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
