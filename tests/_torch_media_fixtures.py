"""The port's committed media fixtures: how they are made and what they
hold.

`processing_chain_tpu_torch/assets/media/` carries three small encoded
clips (H.264 with AAC audio in MP4, HEVC in Matroska, VP9 in WebM; 320x180,
24 frames at 24 fps) and `fixtures.json`, the per-plane md5 of every
decoded frame and the probe fields that the JAX package's `VideoReader`
and `medialib.probe` record for them. Both packages' readers are held to
that record (tests/test_torch_media.py here, `chip_smoke.py` phase 18 on
the card), and `record()` re-derives it, so the JSON cannot drift from the
clips.

Regenerate with the JAX package (needs libx264, libx265 and libvpx):

    JAX_PLATFORMS=cpu python -m tests._torch_media_fixtures
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "processing_chain_tpu_torch", "assets", "media",
)
RECORD = os.path.join(ASSETS, "fixtures.json")
W, H, N, FPS = 320, 180, 24, 24
#: file -> (encoder, options, audio codec)
CLIPS = {
    "h264_aac.mp4": ("libx264", "preset=ultrafast:crf=30", "aac"),
    "hevc.mkv": ("libx265", "preset=ultrafast:crf=32:x265-params=log-level=error", ""),
    "vp9.webm": ("libvpx-vp9", "crf=40:b=0:deadline=realtime:cpu-used=8", ""),
}


def frames(seed: int = 15):
    """N seeded 4:2:0 frames: a moving gradient with a drifting disc, so the
    clips compress to a few KB and every frame differs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    phase = rng.uniform(0, 2 * np.pi, 3)
    out = []
    for t in range(N):
        cx, cy = 60 + 8 * t, 90 + 30 * np.sin(t / 4 + phase[0])
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < 30 ** 2
        y = (40 + 0.4 * xx + 0.3 * yy + 20 * np.sin(xx / 17 + t / 3 + phase[1]) + 90 * disc)
        u = 128 + 30 * np.cos(xx[::2, ::2] / 23 + t / 5 + phase[2])
        v = 128 - 25 * np.sin(yy[::2, ::2] / 19 + t / 6)
        out.append(tuple(np.clip(np.round(p), 0, 255).astype(np.uint8) for p in (y, u, v)))
    return out


def write(folder: str = ASSETS) -> None:
    from processing_chain_tpu.io.video import VideoWriter

    os.makedirs(folder, exist_ok=True)
    planes = frames()
    t = np.arange(int(48000 * N / FPS)) / 48000
    tone = (np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)], 1)
            * 8000).astype(np.int16)
    for name, (codec, opts, acodec) in CLIPS.items():
        audio = dict(audio_codec=acodec, sample_rate=48000, channels=2,
                     audio_bitrate_kbps=32) if acodec else {}
        with VideoWriter(os.path.join(folder, name), codec, W, H, "yuv420p", (FPS, 1),
                         threads=1, opts=opts, gop=12, **audio) as wr:
            if acodec:
                wr.write_audio(tone)
            for p in planes:
                wr.write(*p)


def record(folder: str = ASSETS) -> dict:
    """{file: {probe fields, per-frame per-plane md5}} as the JAX package
    reads the clips in `folder`."""
    from processing_chain_tpu.io import medialib
    from processing_chain_tpu.io.video import VideoReader

    out = {}
    for name in sorted(CLIPS):
        path = os.path.join(folder, name)
        info = medialib.probe(path)
        v = next(s for s in info["streams"] if s["codec_type"] == "video")
        with VideoReader(path) as r:
            stacks, pts = r.read_all()
        out[name] = {
            "width": v["width"], "height": v["height"], "pix_fmt": v["pix_fmt"],
            "r_frame_rate": v["r_frame_rate"], "frames": len(pts),
            "duration": round(float(v["duration"]), 6),
            "audio": any(s["codec_type"] == "audio" for s in info["streams"]),
            # every stream field as this libav probes it (FFmpeg 5.1 here);
            # another libav may differ in these, so they are printed, not held
            "probe": json.loads(json.dumps(info["streams"])),
            "md5": [[hashlib.md5(np.ascontiguousarray(p[k]).tobytes()).hexdigest()
                     for p in stacks] for k in range(len(pts))],
        }
    return out


if __name__ == "__main__":
    write()
    with open(RECORD, "w") as f:
        json.dump(record(), f, indent=1, sort_keys=True)
        f.write("\n")
    for name in sorted(CLIPS):
        print(name, os.path.getsize(os.path.join(ASSETS, name)), "bytes")
