#!/usr/bin/env python3
"""Time variants of csrc/siti.cu's strip walk on one NVIDIA GPU.

    python3 tune_siti.py [--previous OLD_SITI_CU] [--out DIR]

Each variant is a text substitution into a copy of
processing_chain_tpu_torch/csrc/siti.cu, compiled with the port's nvcc
flags into build/tune_siti/ (one nvcc per variant, all started together)
and loaded with ctypes. On one 64-frame 2160x3840 chunk of u8 luma and
one of 10-bit values in u16, every variant's SI partials are checked
against the committed source's (Σ(gx²+gy²) equal, Σ|∇| within 1e-12
relative; variants marked timing-only skip this) and the committed SI
against the plain torch version; then the SI pass (u8 and u16) and the
fused SI+TI pass (u8 and u16, with a predecessor frame) of every variant
are timed with CUDA events, the variants in turns (forward, then
backward, three times) so that clock drift falls on all of them alike.
`--previous` adds a siti.cu of the design before the strip walk (SI
entry point without the vec argument, one partial per 32x128 gradient
tile), timed in the same turns.

Prints each variant's ptxas lines and SASS instruction counts, the SM
clock and power that nvidia-smi reads while the committed u8 SI pass
runs back to back, and, as its last line, one JSON object with every time; the same object and
the committed kernel's SASS go to `--out` (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from processing_chain_tpu_torch.ops import _build
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.utils import fsio

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_build.CSRC, "siti.cu")
BUILD = os.path.join(ROOT, "build", "tune_siti")
T, H, W = 64, 2160, 3840
SEED = 20261016
ROUNDS, REPS = 3, 20  # turns over the variants; launches per timing

# name: (substitutions, timing only: numerics changed, not checked)
_ROT = """        for (int r = r0; r < r1; r += 3) {
          strip_step(a, b, c, ahead, cur, pre, r, r1, h, w, cb, lane, vec,
                     col, acc);
          if (r + 1 >= r1) break;
          strip_step(b, c, a, ahead, cur, pre, r + 1, r1, h, w, cb, lane,
                     vec, col, acc);
          if (r + 2 >= r1) break;
          strip_step(c, a, b, ahead, cur, pre, r + 2, r1, h, w, cb, lane,
                     vec, col, acc);
        }"""
_COPIES = """        for (int r = r0; r < r1; ++r) {
          strip_step(a, b, c, ahead, cur, pre, r, r1, h, w, cb, lane, vec,
                     col, acc);
          a = b;
          b = c;
        }"""
_TERM = """      const float xr = fmaf(gx, gx, fmaf(gy, gy, 0x1p-100f));
      const float m2 = xr * col[j];
      acc.mag8.add(m2, xr);"""
VARIANTS = {
    "committed": ((), False),
    # three blocks an SM for the SI pass (85 registers a thread)
    "bounds3": ((("__launch_bounds__(THREADS, 2)\n    siti_partials(",
                  "__launch_bounds__(THREADS, kTI ? 2 : 3)\n    siti_partials("),), False),
    "rows32": ((("constexpr int ST_ROWS = 64;", "constexpr int ST_ROWS = 32;"),), False),
    "rows128": ((("constexpr int ST_ROWS = 64;", "constexpr int ST_ROWS = 128;"),), False),
    # half as many frame groups: each block walks two frames
    "z2": ((("nz < 65535 ? nz : 65535", "(nz + 1) / 2 < 65535 ? (nz + 1) / 2 : 65535"),),
           False),
    # u8: one step a row, the rows copied down after each
    "u8_copies": (((_ROT, _COPIES),), False),
    # u16: three rotating steps a turn, as u8
    "u16_rotate": (((_COPIES, _ROT),), False),
    # the root's argument floored by a max per term instead of inside the fma
    "fmax": (((_TERM, """      const float m2 = fmaf(gx, gx, gy * gy) * col[j];
      acc.mag8.add(m2, fmaxf(m2, 1.0f));"""),), False),
    # the column factor as a select instead of a product
    "select": ((("const float m2 = xr * col[j];",
                 "const float m2 = col[j] != 0.0f ? xr : 0.0f;"),), False),
    # no column mask at all: what masking costs
    "nomask": ((("const float m2 = xr * col[j];", "const float m2 = xr;"),), True),
    # Σ|∇| as a plain f32 sum of x * rsqrt(x): what RowMag's exactness costs
    "mag_plain": ((("    cor = fmaf(r, y, cor);\n", ""),
                   ("    const float hi = (m + 49152.0f) - 49152.0f;  // ulp 2^-8 in [2^15, 2^16)\n"
                    "    row += hi;\n    lo += m - hi;\n", "    row += m;\n")), True),
}


def write_text(path: str, text: str) -> None:
    """Write `path` whole or not at all (temp file, then rename)."""
    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(text)
    fsio.atomic_write(path, write)


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_source(subs) -> str:
    with open(SRC) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"tune_siti: substitution target not in siti.cu: {old!r}")
        text = text.replace(old, new)
    return text


def build_all(sources: dict) -> dict:
    """{name: (library path, ptxas lines)}, one nvcc per source, all at once."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(BUILD, f"{name}.cu")
        write_text(cu, text)
        so = os.path.join(BUILD, f"{name}.so")
        # chainlint: disable=subprocess-hygiene (one nvcc per variant, all running at once; each one's output is read to its end and a refusal stops the run)
        procs[name] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"tune_siti: nvcc refused {name}:\n{text}")
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        out[name] = (so, lines)
    return out


def sass(so: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    # chainlint: disable=subprocess-hygiene (a toolkit binary on a built library, check=True: a failure raises with its output)
    return subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(text: str) -> dict:
    """SASS instructions of each strip-walk instance, by (type, TI)."""
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            k = re.search(r"siti_partialsI([ht])Lb([01])E", name)
            fn = (("u8" if k.group(1) == "h" else "u16") + ("+ti" if k.group(2) == "1" else "")
                  if k else None)
            if fn:
                counts[fn] = 0
            continue
        if fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[fn] += 1
    return counts


def rows_of(text: str) -> int:
    return int(re.search(r"constexpr int ST_ROWS = (\d+);", text).group(1))


class Lib:
    """One built siti.cu: its SI and fused entry points on preallocated
    partial buffers."""

    def __init__(self, so: str, rows: int, old_si: bool):
        self.lib = ctypes.CDLL(so)
        self.rows, self.old_si = rows, old_si
        sig = dict(ck._SIGNATURES["siti"])
        if old_si:
            sig["pc_si_partials"] = [ck._P, ck._I, ck._I, ck._I, ck._I, ck._P, ck._P, ck._P]
        for symbol, argtypes in sig.items():
            fn = getattr(self.lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        self.bufs = {}

    def _nb(self, h, w, size) -> int:
        if self.old_si:
            return -(-(h - 2) // 32) * -(-(w - 2) // 128)
        return -(-h // self.rows) * -(-w * size // 4096)

    def _buf(self, key, shape, dtype, dev):
        b = self.bufs.get(key)
        if b is None or tuple(b.shape) != shape:
            b = self.bufs[key] = torch.empty(shape, dtype=dtype, device=dev)
        return b

    def si(self, y):
        t, h, w = y.shape
        size = y.element_size()
        nb = self._nb(h, w, size)
        p1 = self._buf(("si1", size), (t, nb), torch.float64, y.device)
        p2 = self._buf(("si2", size), (t, nb), torch.int64, y.device)
        stream = torch.cuda.current_stream().cuda_stream
        if self.old_si:
            rc = self.lib.pc_si_partials(y.data_ptr(), t, h, w, size, p1.data_ptr(),
                                         p2.data_ptr(), stream)
        else:
            rc = self.lib.pc_si_partials(y.data_ptr(), t, h, w, size, 1, p1.data_ptr(),
                                         p2.data_ptr(), stream)
        if rc != 0:
            raise SystemExit(f"tune_siti: pc_si_partials returned cudaError {rc}")
        return p1, p2

    def siti(self, y, prev):
        t, h, w = y.shape
        size = y.element_size()
        nb = -(-h // self.rows) * -(-w * size // 4096)
        p1 = self._buf(("f1", size), (t, nb), torch.float64, y.device)
        pint = self._buf(("fi", size), (3, t, nb), torch.int64, y.device)
        rc = self.lib.pc_siti_partials(
            y.data_ptr(), prev.data_ptr(), t, t, h, w, size, 1, p1.data_ptr(),
            pint[0].data_ptr(), pint[1].data_ptr(), pint[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"tune_siti: pc_siti_partials returned cudaError {rc}")
        return p1, pint


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clock_during(fn, seconds: float) -> dict:
    """SM clock and power that nvidia-smi reads (every 100 ms) while `fn`
    runs back to back for about `seconds`: the median of each, and the
    launches made."""
    # chainlint: disable=subprocess-hygiene (a sampler that runs beside the timed kernel until it is terminated below)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ms = time_ms(fn, 5)
        n = max(1, int(seconds * 1e3 / ms))
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
    clocks = sorted(float(c) for c, _ in rows)
    power = sorted(float(p) for _, p in rows)
    med = lambda v: v[len(v) // 2] if v else None  # noqa: E731
    return {"sm_mhz_median": med(clocks), "power_w_median": med(power),
            "samples": len(rows), "launches": n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--previous", help="a siti.cu of the design before the strip walk")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_siti: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # chainlint: disable=subprocess-hygiene (one read-only nvidia-smi query with a timeout; check=True raises on failure)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    sources = {name: variant_source(subs) for name, (subs, _) in VARIANTS.items()}
    if args.previous:
        with open(args.previous) as f:
            sources["previous"] = f.read()
    built = build_all(sources)
    libs = {name: Lib(so, rows_of(sources[name]), name == "previous")
            for name, (so, _) in built.items()}
    report = {"card": smi, "shape": [T, H, W], "variants": {}}
    os.makedirs(args.out, exist_ok=True)
    for name, (so, lines) in built.items():
        text = sass(so)
        counts = sass_counts(text)
        report["variants"][name] = {"ptxas": lines, "sass_instructions": counts}
        log(f"{name}: SASS instructions {counts}\n  " + "\n  ".join(lines))
        if name == "committed":
            write_text(os.path.join(args.out, "tune_siti_committed.sass"), text)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    y8 = torch.randint(0, 256, (T, H, W), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    p8 = torch.randint(0, 256, (H, W), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    y16 = torch.randint(0, 1024, (T, H, W), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint16)
    p16 = torch.randint(0, 1024, (H, W), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint16)
    n = (H - 2) * (W - 2)

    # the committed SI against the plain version, then every variant
    # against the committed partial sums
    ref = {}
    for key, y, atol in (("u8", y8, 1e-3), ("u16", y16, 1e-2)):
        s1, s2 = (p.sum(1) for p in libs["committed"].si(y))
        si = ck._std_from_sums(s1, s2.to(torch.float64), n)
        plain = ck.si_frames_plain(y)
        err = float((si.double() - plain.double()).abs().max())
        log(f"committed SI {key} vs plain: max|diff| {err}")
        if not torch.allclose(si, plain, rtol=1e-4, atol=atol):
            raise SystemExit(f"tune_siti: committed SI {key} off the plain version by {err}")
        ref[key] = (s1, s2)
        report[f"si_{key}_vs_plain"] = err
    for name, lib in libs.items():
        if name == "committed" or (name in VARIANTS and VARIANTS[name][1]):
            continue
        for key, y in (("u8", y8), ("u16", y16)):
            s1, s2 = (p.sum(1) for p in lib.si(y))
            rel = float(((s1 - ref[key][0]).abs() / ref[key][0].abs().clamp(min=1)).max())
            same = bool(torch.equal(s2, ref[key][1]))
            log(f"{name} SI {key}: Σ(gx²+gy²) equal {same}, Σ|∇| max rel diff {rel}")
            if not same or rel > 1e-12:
                raise SystemExit(f"tune_siti: {name} {key} disagrees with the committed kernel")

    cases = {"si_u8": lambda lib: lib.si(y8), "si_u16": lambda lib: lib.si(y16),
             "siti_u8": lambda lib: lib.siti(y8, p8), "siti_u16": lambda lib: lib.siti(y16, p16)}
    times = {name: {c: [] for c in cases} for name in libs}
    order = list(libs)
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            for case, fn in cases.items():
                times[name][case].append(time_ms(lambda: fn(libs[name]), REPS))
    for name in libs:
        row = {c: {"mean_ms": sum(v) / len(v), "min_ms": min(v)} for c, v in times[name].items()}
        report["variants"][name]["times"] = row
        log(f"{name}: " + ", ".join(f"{c} {r['mean_ms']:.4f} ms (min {r['min_ms']:.4f})"
                                    for c, r in row.items()))
    report["clock_si_u8"] = clock_during(lambda: cases["si_u8"](libs["committed"]), 2.0)
    log(f"committed si_u8 run back to back: {report['clock_si_u8']}")
    report["wrapper_si_u8_ms"] = time_ms(lambda: ck.si_frames_fused(y8), REPS)
    log(f"wrapper si_frames_fused u8 (committed build, allocation and reduction included): "
        f"{report['wrapper_si_u8_ms']:.4f} ms")
    write_text(os.path.join(args.out, "tune_siti.json"), json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
