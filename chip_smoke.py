#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (processing_chain_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):
  1. device: CUDA must be present; prints the card's name and power limit
  2. build: compiles csrc/*.cu with nvcc (one process per source, all at
     once) and prints each kernel's registers, shared memory and spills
  3. kernel vs plain torch version at the main path's shapes
  4. main path: a seeded synthetic 600-frame 1920x1080 yuv420p clip through
     models.avpvs.pump_ready onto a 3840x2160 canvas in 64-frame chunks,
     then a 128-frame yuv420p10le clip; launch counts, sidecar rows and the
     first chunk against the plain path are checked; frames/s end to end
  5. timing of each kernel at the main path's shapes beside its bound, its
     plain version and, where one exists, a PyTorch library call
The last two lines of standard output are one JSON object with every
kernel's numbers and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from processing_chain_tpu_torch.models import avpvs
from processing_chain_tpu_torch.models import frames as fr
from processing_chain_tpu_torch.ops import _build
from processing_chain_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SRC_H, SRC_W, DST_H, DST_W = 1080, 1920, 2160, 3840
CLIP_FRAMES, CLIP_FRAMES_10BIT = 600, 128  # a 10 s 60 fps short test; 2 chunks

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor)
# operations/s; int32 add and multiply-add run at half the fp32 rate
# (64 vs 128 per SM per clock on compute capability 9.0).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT32_OPS_S = FP32_OPS_S / 2
SI_OPS_PER_PX = 14  # separable Sobel 8, m² 3, sqrt 1, two sums 2
TI_OPS_PER_PX = 4   # difference, square, two sums

KERNELS = {
    "resize_frames_fused": ("csrc/resize.cu", "pallas_kernels.py:135"),
    "si_frames_fused": ("csrc/siti.cu", "pallas_kernels.py:293"),
    "ti_frames_fused": ("csrc/siti.cu", "pallas_kernels.py:443"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def plane_shapes(t: int):
    return [(t, SRC_H, SRC_W), (t, SRC_H // 2, SRC_W // 2), (t, SRC_H // 2, SRC_W // 2)]


def random_frames(gen, shape, hi: int, dtype, device) -> torch.Tensor:
    x = torch.randint(0, hi + 1, shape, generator=gen, device=device, dtype=torch.int32)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain at the main path's shapes
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {name: 0.0 for name in KERNELS}
    for kernel in ("bicubic", "lanczos"):
        for (t, h, w), (dh, dw) in zip(plane_shapes(8)[:2], [(DST_H, DST_W), (DST_H // 2, DST_W // 2)]):
            x = random_frames(gen, (t, h, w), 255, torch.uint8, dev)
            a = ck.resize_frames_fused(x, dh, dw, kernel)
            b = ck.resize_frames_plain(x, dh, dw, kernel)
            e = max_abs(a, b)
            log(f"resize u8 {kernel} {h}x{w}->{dh}x{dw} x{t}: max|kernel-plain| = {e}")
            require(torch.equal(a, b), f"resize u8 {kernel} {h}x{w}: kernel != plain")
            err["resize_frames_fused"] = max(err["resize_frames_fused"], e)
    for (t, h, w), (dh, dw) in zip(plane_shapes(8)[:2], [(DST_H, DST_W), (DST_H // 2, DST_W // 2)]):
        x = random_frames(gen, (t, h, w), 1023, torch.uint16, dev)
        d = (ck.resize_frames_fused(x, dh, dw, "bicubic").to(torch.int32)
             - ck.resize_frames_plain(x, dh, dw, "bicubic").to(torch.int32)).abs()
        e, share = int(d.max()), float((d != 0).to(torch.float64).mean())
        log(f"resize u16 bicubic {h}x{w}->{dh}x{dw} x{t}: max diff {e}, "
            f"differing share {share}")
        require(e <= 1, f"resize u16 {h}x{w}: max diff {e} > 1")
        err["resize_frames_fused"] = max(err["resize_frames_fused"], float(e))
    for dtype, hi, atol in ((torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)):
        y = random_frames(gen, (16, DST_H, DST_W), hi, dtype, dev)
        prev = random_frames(gen, (DST_H, DST_W), hi, dtype, dev)
        cases = [
            ("si_frames_fused", ck.si_frames_fused(y), ck.si_frames_plain(y)),
            ("ti_frames_fused", ck.ti_frames_fused(y), ck.ti_frames_plain(y)),
            ("ti_frames_fused", ck.ti_frames_fused(y, prev), ck.ti_frames_plain(y, prev)),
        ]
        for name, a, b in cases:
            e = max_abs(a, b)
            log(f"{name} {str(dtype)[6:]} [16,{DST_H},{DST_W}]: max|kernel-plain| = {e}")
            require(torch.allclose(a, b, rtol=1e-4, atol=atol),
                    f"{name} {dtype}: kernel vs plain off by {e}")
            err[name] = max(err[name], e)
        del y, prev
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def synthetic_clip(frames: int, chunk: int, ten_bit: bool, seed: int) -> list:
    """Host chunks of a moving gradient plus noise (yuv420p planes): every
    frame shifts the gradient by 4 columns and takes one of 8 noise
    fields, so SI and TI are non-trivial."""
    rng = np.random.default_rng(seed)
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    out = []
    planes = []
    for _, h, w in plane_shapes(1):
        xx = np.arange(w + 4 * frames)[None, :]
        yy = np.arange(h)[:, None]
        grad = ((xx * 3 + yy * 2) % (hi - 40)).astype(dtype)
        noise = rng.integers(0, 41, (8, h, w)).astype(dtype)
        planes.append((grad, noise))
    for lo in range(0, frames, chunk):
        n = min(chunk, frames - lo)
        chunk_planes = []
        for (grad, noise), (_, h, w) in zip(planes, plane_shapes(1)):
            arr = np.empty((n, h, w), dtype)
            for k in range(n):
                s = 4 * (lo + k)
                np.add(grad[:, s:s + w], noise[(lo + k) % 8], out=arr[k])
            chunk_planes.append(arr)
        out.append(chunk_planes)
    return out


def fold_checksum(checksum: int, host_planes) -> int:
    """Running checksum: each plane's bytes summed as uint64 words (mod
    2**64), folded into the running value."""
    for h in host_planes:
        raw = h.numpy().reshape(-1).view(np.uint8)
        words = raw[: raw.size // 8 * 8].view(np.uint64)
        s = int(words.sum(dtype=np.uint64)) + int(raw[words.size * 8:].sum())
        checksum = (checksum * 1000003 + s) % (1 << 64)
    return checksum


def host_breakdown(dev, host_planes, quant_planes) -> dict:
    """Per-chunk cost of each host-side step of the render, measured one
    at a time on chunk 0: numpy -> pinned staging copy, host->device copy,
    device->host copy of the quantized planes, the sink's checksum."""
    pinned_in = [torch.empty(p.shape, dtype=torch.from_numpy(p).dtype, pin_memory=True)
                 for p in host_planes]
    pinned_out = [torch.empty(q.shape, dtype=q.dtype, pin_memory=True) for q in quant_planes]
    dev_in = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in pinned_in]

    def wall_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def stage():
        for dst, src in zip(pinned_in, host_planes):
            dst.copy_(torch.from_numpy(src))

    def h2d():
        for dst, src in zip(dev_in, pinned_in):
            dst.copy_(src, non_blocking=True)

    def d2h():
        for dst, src in zip(pinned_out, quant_planes):
            dst.copy_(src, non_blocking=True)

    in_bytes = sum(p.nbytes for p in host_planes)
    out_bytes = sum(q.numel() * q.element_size() for q in quant_planes)
    out = {
        "stage_ms": wall_ms(stage),
        "h2d_ms": time_ms(h2d, reps=3),
        "d2h_ms": time_ms(d2h, reps=3),
        "checksum_ms": wall_ms(lambda: fold_checksum(0, pinned_out)),
        "h2d_bytes": in_bytes, "d2h_bytes": out_bytes,
    }
    out["h2d_gb_s"] = in_bytes / out["h2d_ms"] / 1e6
    out["d2h_gb_s"] = out_bytes / out["d2h_ms"] / 1e6
    return out


class HostSink:
    """The writer end of the main path: fetches every quantized chunk to
    pinned host memory on its own stream, on a thread of its own, and folds
    it into a running checksum. The first chunk's host copy is kept."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.queue = queue.Queue(maxsize=2)
        self.checksum = 0
        self.frames = 0
        self.first = None
        self.error = None
        self.fetch_s = 0.0     # wall time of the device->host copies
        self.checksum_s = 0.0  # wall time of the host checksum
        self._bufs = {}
        self._thread = threading.Thread(target=self._run, name="host-sink")
        self._thread.start()

    def put(self, planes, recycle=None) -> None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream())
        self.queue.put((planes, done))

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            if self.error is not None:
                continue
            try:
                self._fetch(*item)
            except BaseException as exc:  # reported by close()
                self.error = exc

    def _fetch(self, planes, done) -> None:
        host = []
        done.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(done)
            for k, p in enumerate(planes):
                key = (k, tuple(p.shape), p.dtype)
                buf = self._bufs.get(key)
                if buf is None:
                    buf = self._bufs[key] = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                buf.copy_(p, non_blocking=True)
                host.append(buf)
        self.stream.synchronize()
        t1 = time.perf_counter()
        self.checksum = fold_checksum(self.checksum, host)
        self.fetch_s += t1 - t0
        self.checksum_s += time.perf_counter() - t1
        self.frames += planes[0].shape[0]
        if self.first is None:
            self.first = [h.clone() for h in host]

    def close(self) -> None:
        self.queue.put(None)
        self._thread.join()
        if self.error is not None:
            raise self.error


def run_main_path(dev, frames: int, pix_fmt: str, workdir: str) -> dict:
    ten_bit = "10" in pix_fmt
    chunk = avpvs.CHUNK
    chunks = synthetic_clip(frames, chunk, ten_bit, SEED + frames)
    n_chunks = len(chunks)
    out_path = os.path.join(workdir, f"smoke_{pix_fmt}.avi")
    avpvs.SiTiAccumulator.discard(out_path)
    feat = avpvs.SiTiAccumulator()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ck.reset_launches()
    t0 = time.perf_counter()
    sink = HostSink(dev)
    try:
        avpvs.pump_ready(iter(chunks), sink, feat, DST_H, DST_W, pix_fmt, device=dev)
    finally:
        sink.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    log(f"main path {pix_fmt}: {frames} frames in {n_chunks} chunks, "
        f"{seconds:.3f} s, launches {launches}")
    require(sink.frames == frames, f"sink saw {sink.frames} frames, not {frames}")
    want = {"resize_frames_fused": 3 * n_chunks, "si_frames_fused": n_chunks,
            "ti_frames_fused": n_chunks}
    require(launches == want, f"launches {launches} != {want}")

    path = feat.write(out_path)
    with open(path) as f:
        rows = f.read().splitlines()
    require(rows[0] == "frame,si,ti" and len(rows) == frames + 1,
            f"sidecar has {len(rows) - 1} rows, not {frames}")
    si = torch.cat(feat.si).cpu()
    ti = torch.cat(feat.ti).cpu()
    require(bool(torch.isfinite(si).all() and torch.isfinite(ti).all()), "non-finite SI/TI")
    require(float(ti[0]) == 0.0 and bool((ti[1:] > 0).all()) and bool((si > 0).all()),
            "SI/TI of the moving noisy gradient must be positive (TI[0] = 0)")

    # the first chunk again, through the plain versions on the card
    first_dev = [torch.from_numpy(p).to(dev) for p in chunks[0]]
    sub = fr.chroma_subsampling(pix_fmt)
    dims = [(DST_H, DST_W), (DST_H // sub[0], DST_W // sub[1]), (DST_H // sub[0], DST_W // sub[1])]
    plain = [ck.resize_frames_plain(p, h, w, "bicubic") for p, (h, w) in zip(first_dev, dims)]
    plane_err = max(max_abs(a, b.cpu()) for a, b in zip(sink.first, plain))
    if ten_bit:
        require(plane_err <= 1, f"10-bit first chunk: max diff {plane_err} > 1")
    else:
        require(all(torch.equal(a, b.cpu()) for a, b in zip(sink.first, plain)),
                "u8 first chunk differs from the plain path")
    atol = 1e-2 if ten_bit else 1e-3
    n0 = chunks[0][0].shape[0]
    si_err = max_abs(si[:n0], ck.si_frames_plain(plain[0]).cpu())
    ti_err = max_abs(ti[:n0], ck.ti_frames_plain(plain[0]).cpu())
    require(si_err <= atol and ti_err <= atol, f"first chunk SI/TI off by {si_err}, {ti_err}")

    # device time of one chunk's render (resize x3, quantize, SI, TI),
    # the chunk already resident
    def render_chunk():
        scaled = fr.scale_yuv_frames(first_dev, DST_H, DST_W, "bicubic", sub)
        quant = fr.quantize_device(scaled, ten_bit)
        avpvs.SiTiAccumulator().update(quant[0])

    device_ms = time_ms(render_chunk, reps=5)
    scaled = fr.scale_yuv_frames(first_dev, DST_H, DST_W, "bicubic", sub)
    breakdown = host_breakdown(dev, chunks[0], fr.quantize_device(scaled, ten_bit))
    del scaled
    result = {
        "pix_fmt": pix_fmt, "frames": frames, "chunks": n_chunks,
        "seconds": seconds, "frames_per_s": frames / seconds,
        "device_ms_per_chunk": device_ms,
        "device_ms_per_frame": device_ms / n0,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "first_chunk_max_err": plane_err,
        "first_chunk_si_err": si_err, "first_chunk_ti_err": ti_err,
        "checksum": f"{sink.checksum:016x}",
        "sink_fetch_s": sink.fetch_s, "sink_checksum_s": sink.checksum_s,
        "device_busy_share": device_ms * n_chunks / 1e3 / seconds,
        "per_chunk_host": breakdown,
    }
    log(f"main path {pix_fmt}: {result['frames_per_s']:.2f} frames/s end to end, "
        f"device {device_ms:.3f} ms per {n0}-frame chunk; sink fetch "
        f"{sink.fetch_s:.3f} s + checksum {sink.checksum_s:.3f} s; one chunk's "
        f"host steps {json.dumps(breakdown)}")
    del first_dev, plain
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 5: timing beside the bounds
# ---------------------------------------------------------------------------


def bound(bytes_moved: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(dev) -> dict:
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t = avpvs.CHUNK
    out = {}

    # resize: the three plane calls of one 64-frame chunk
    planes = [random_frames(gen, s, 255, torch.uint8, dev) for s in plane_shapes(t)]
    dims = [(DST_H, DST_W), (DST_H // 2, DST_W // 2), (DST_H // 2, DST_W // 2)]
    bytes_moved = ops = 0
    for p, (dh, dw) in zip(planes, dims):
        _, h, w = p.shape
        plan = ck._device_resize_plan(h, w, dh, dw, "bicubic", True, str(dev))
        bytes_moved += t * (h * w + dh * dw)
        ops += 2 * t * (h * dw * plan["kh"] + dh * dw * plan["kv"])
    floats = [p.to(torch.float32)[:, None] for p in planes]
    out["resize_frames_fused"] = dict(
        zip(("bound_ms", "bound_by"), bound(bytes_moved, ops, INT32_OPS_S)),
        ms=time_ms(lambda: [ck.resize_frames_fused(p, h, w, "bicubic")
                            for p, (h, w) in zip(planes, dims)], reps=10),
        plain_ms=time_ms(lambda: [ck.resize_frames_plain(p, h, w, "bicubic")
                                  for p, (h, w) in zip(planes, dims)], reps=2),
        library_ms=time_ms(lambda: [F.interpolate(f, size=(h, w), mode="bicubic")
                                    for f, (h, w) in zip(floats, dims)], reps=3),
        library_call="torch.nn.functional.interpolate(bicubic, f32) per plane",
        per="one 64-frame yuv420p chunk: Y 1080x1920->2160x3840, U and V "
            "540x960->1080x1920, u8 bicubic",
    )
    del planes, floats
    torch.cuda.empty_cache()

    # SI and TI: one 64-frame 2160x3840 u8 luma chunk, TI with a predecessor
    y = random_frames(gen, (t, DST_H, DST_W), 255, torch.uint8, dev)
    prev = random_frames(gen, (DST_H, DST_W), 255, torch.uint8, dev)
    hw = DST_H * DST_W
    sobel = torch.tensor([[[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                          [[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]]],
                         device=dev)[:, None]
    yf = y.to(torch.float32)[:, None]
    interior = t * (DST_H - 2) * (DST_W - 2)
    out["si_frames_fused"] = dict(
        zip(("bound_ms", "bound_by"), bound(t * hw, SI_OPS_PER_PX * interior, INT32_OPS_S)),
        ms=time_ms(lambda: ck.si_frames_fused(y), reps=10),
        plain_ms=time_ms(lambda: ck.si_frames_plain(y), reps=2),
        library_ms=time_ms(lambda: F.conv2d(yf, sobel), reps=3),
        library_call="torch.nn.functional.conv2d(f32, 2 Sobel filters): gradients only",
        per="one 64-frame 2160x3840 u8 luma chunk",
    )
    del yf
    out["ti_frames_fused"] = dict(
        zip(("bound_ms", "bound_by"), bound((t + 1) * hw, TI_OPS_PER_PX * t * hw, INT32_OPS_S)),
        ms=time_ms(lambda: ck.ti_frames_fused(y, prev), reps=10),
        plain_ms=time_ms(lambda: ck.ti_frames_plain(y, prev), reps=2),
        library_ms=None,
        library_call=None,
        per="one 64-frame 2160x3840 u8 luma chunk with a predecessor frame",
    )
    for name, r in out.items():
        log(f"timing {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']} ms — {r['per']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        log(f"ptxas {name}.cu:\n{_build.ptxas_report(name).rstrip()}")

    err = check_kernels(dev)
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    main8 = run_main_path(dev, CLIP_FRAMES, "yuv420p", workdir)
    main10 = run_main_path(dev, CLIP_FRAMES_10BIT, "yuv420p10le", workdir)
    timing = time_kernels(dev)

    per_chunk = {"resize_frames_fused": 3, "si_frames_fused": 1, "ti_frames_fused": 1}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"processing_chain_tpu_torch/{source}",
            "replaces": f"processing_chain_tpu/ops/{replaces}",
            "launches": main8["launches"][name],
            "launches_per_chunk": per_chunk[name],
            "launches_10bit": main10["launches"][name],
            "max_abs_err": err[name], "matches_plain": True,
            **timing[name],
        })
    log(json.dumps({"main_path": [main8, main10], "card": smi}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
