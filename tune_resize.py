#!/usr/bin/env python3
"""Time variants of csrc/resize.cu's resize_stream on one NVIDIA GPU.

    python3 tune_resize.py [--blocks-per-sm N,N,...] [--out DIR]

Each variant is a text substitution into a copy of
processing_chain_tpu_torch/csrc/resize.cu, compiled with the port's nvcc
flags into build/tune_resize/ (one nvcc per variant, all started together)
and loaded with ctypes in place of the committed build. Every variant that
computes the whole function is first checked equal to the plain torch
version (u8 and 10-bit values in u16, bicubic and lanczos, 2160p luma and
1080p chroma to the mobile CPVS and the 640x360 and 320x180 levels, five
frames). Then one 64-frame 2160p yuv420p u8 chunk is resized, per plane,
to the mobile CPVS (1920x1080), to 640x360 and to 320x180, bicubic, by
every variant, at the plan's shared-memory target and at half of it (the
plan then takes narrower or shorter tiles), in turns (forward, then
backward) so that clock drift falls on all variants alike. The variants
that drop a part of the work (staging only, no vertical pass, no
horizontal pass) say how the time divides. `--blocks-per-sm` also times
the committed build with the persistent grid sized for each of these
blocks per SM (ops/cuda_kernels._RESIZE_BLOCKS_PER_SM), in the same
turns.

Prints the card's name and power limit, each time, and, as its last line,
one JSON object with every time; the same object goes to `--out`
(default chiprun_out/tune_resize.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from processing_chain_tpu_torch.ops import _build
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from tune_siti import log, time_ms, write_text

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build", "tune_resize")
SEED = 20261017
T = 64
CASES = (("cpvs", (1080, 1920)), ("640x360", (360, 640)), ("320x180", (180, 320)))
REPS = 10

_NO_H = ("for (int g0 = 0; g0 < a.kh / 4; g0 += GU) {", "for (int g0 = 0; g0 < 0; g0 += GU) {")
_NO_V = ("while (end == s) {", "while (false && end == s) {")
_CP_ASYNC = [("    if (a.vec) {\n      uint64_t* bar", "    if (false) {\n      uint64_t* bar"),
             ("      if (a.vec)\n        mbar_wait", "      if (false)\n        mbar_wait")]
# name: (substitutions, computes the whole function?)
VARIANTS = {
    "committed": ([], True),
    "cp.async staging": (_CP_ASYNC, True),
    "staging only": ([_NO_H, _NO_V], False),
    "no vertical pass": ([_NO_V], False),
    "no horizontal pass": ([_NO_H], False),
}


def variant_source(subs) -> str:
    with open(os.path.join(_build.CSRC, "resize.cu")) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"tune_resize: {old!r} is not in csrc/resize.cu")
        text = text.replace(old, new)
    return text


def build_all() -> dict:
    """{name: library path}, one nvcc per variant, all at once."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for k, (name, (subs, _)) in enumerate(VARIANTS.items()):
        cu = os.path.join(BUILD, f"v{k}.cu")
        write_text(cu, variant_source(subs))
        so = os.path.join(BUILD, f"v{k}.so")
        # chainlint: disable=subprocess-hygiene (one nvcc per variant, all running at once; each one's output is read to its end and a refusal stops the run)
        procs[name] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"tune_resize: nvcc refused {name}:\n{text}")
        out[name] = so
    return out


def use(so: str) -> None:
    """Make ops/cuda_kernels launch the library at `so`."""
    lib = ctypes.CDLL(so)
    fn = lib.pc_resize_frames
    fn.argtypes = ck._SIGNATURES["resize"]["pc_resize_frames"]
    fn.restype = ctypes.c_int
    _build._LOADED["resize"] = lib


def dims_of(h: int, w: int) -> list:
    return [(h, w), (h // 2, w // 2), (h // 2, w // 2)]


def check(planes) -> bool:
    ok = True
    for _, (h, w) in CASES:
        for p, (dh, dw) in zip(planes[:2], dims_of(h, w)[:2]):
            for x in (p[:5], (p[:5].to(torch.int32) * 4).to(torch.uint16)):
                for kernel in ("bicubic", "lanczos"):
                    got = ck.resize_frames_fused(x, dh, dw, kernel)
                    ok &= torch.equal(got, ck.resize_frames_plain(x, dh, dw, kernel))
    return bool(ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks-per-sm", default="",
                    help="comma-separated grid sizes to time the committed build at")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_resize: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # chainlint: disable=subprocess-hygiene (one read-only nvidia-smi query with a timeout; check=True raises on failure)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    libs = build_all()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    planes = [torch.randint(0, 256, s, generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
              for s in ((T, 2160, 3840), (T, 1080, 1920), (T, 1080, 1920))]
    report = {"card": smi, "chunk": "64-frame 2160p yuv420p u8, bicubic, per plane",
              "equal_to_plain": {}, "ms": {}}
    target = ck._RESIZE_STREAM_SMEM_TARGET
    for name, so in libs.items():
        if VARIANTS[name][1]:
            use(so)
            ck._device_resize_plan.cache_clear()
            report["equal_to_plain"][name] = check(planes)
            log(f"{name}: equal to the plain version: {report['equal_to_plain'][name]}")
            if not report["equal_to_plain"][name]:
                return 1
    grids = [int(n) for n in args.blocks_per_sm.split(",") if n]
    per_sm = ck._RESIZE_BLOCKS_PER_SM
    order = list(libs) + [f"committed | {n} blocks per SM" for n in grids]
    for turn in (order, order[::-1]):
        for name in turn:
            grid = name.split(" | ")
            use(libs[grid[0]])
            ck._RESIZE_BLOCKS_PER_SM = int(grid[1].split()[0]) if len(grid) > 1 else per_sm
            for smem in (target, target // 2):
                ck._RESIZE_STREAM_SMEM_TARGET = smem
                ck._device_resize_plan.cache_clear()
                for case, (h, w) in CASES:
                    ms = time_ms(lambda: [ck.resize_frames_fused(p, dh, dw, "bicubic")
                                          for p, (dh, dw) in zip(planes, dims_of(h, w))], REPS)
                    report["ms"].setdefault(f"{name} | target {smem} | {case}", []).append(ms)
    ck._RESIZE_STREAM_SMEM_TARGET, ck._RESIZE_BLOCKS_PER_SM = target, per_sm
    for key, times in report["ms"].items():
        log(f"{key}: {' / '.join(f'{t:.4f}' for t in times)} ms")
    write_text(os.path.join(args.out, "tune_resize.json"), json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
