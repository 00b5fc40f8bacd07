"""Build the CUDA sources of csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on its own into a plain C shared
library, `build/processing_chain_tpu_torch/<name>-<hash>.so` beside the
package, where the hash covers the source bytes and the compiler flags, so
an edited source is rebuilt and an unchanged one is reused. `build()`
starts one nvcc per missing library, all at once, and waits for them; the
ptxas report (registers, shared memory, spills per kernel) is kept beside
each library as `<name>-<hash>.log`. Nothing here runs at import time:
hosts without nvcc (the CPU test runs) import the port freely and only a
launch on a CUDA tensor needs the compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(_PKG), "build", "processing_chain_tpu_torch"
)
SOURCES = ("resize", "siti")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if not found:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source(name: str) -> str:
    if name not in SOURCES:
        raise BuildError(f"unknown CUDA source {name!r}")
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict:
    """Compile every missing library among `names`, one nvcc each, all
    started together. Returns {name: library path}."""
    paths = {n: library_path(n) for n in names}
    missing = {n: p for n, p in paths.items() if not os.path.isfile(p)}
    if not missing:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in missing.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, path, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        with open(os.path.splitext(path)[0] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise BuildError("\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of the last
    build of `name`, or "" when it was built before logs were kept."""
    log = os.path.splitext(library_path(name))[0] + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return "".join(
            line for line in f
            if "registers" in line or "spill" in line or "Compiling" in line
        )


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    `argtypes` set from `signatures` ({symbol: [ctypes types]}) and every
    entry point returning a C int (the launch's cudaError_t)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build((name,))[name])
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
