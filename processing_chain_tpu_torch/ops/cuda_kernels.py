"""Hand-written CUDA kernels for the hot pixel ops (port of
processing_chain_tpu/ops/pallas_kernels.py).

Three wrappers, one per TPU kernel on the p03 render path:

  resize_frames_fused  csrc/resize.cu  (pallas_kernels.py:131-215)
  si_frames_fused      csrc/siti.cu    (pallas_kernels.py:293-313)
  ti_frames_fused      csrc/siti.cu    (pallas_kernels.py:443-465)

Each wrapper checks its input and, for a CUDA tensor, launches its kernel
on the tensor's current stream (and adds one to `LAUNCHES[name]` there
and nowhere else) or raises; for a CPU tensor it runs the plain torch
version of the same function beside it (`*_plain`). There is no fallback
from a CUDA tensor to the plain version. The kernels are compiled at
first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, resize

LAUNCHES = {"resize_frames_fused": 0, "si_frames_fused": 0, "ti_frames_fused": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "resize": {
        "pc_resize_frames": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    },
    "siti": {
        "pc_si_partials": [_P, _I, _I, _I, _I, _P, _P, _P],
        "pc_ti_partials": [_P, _P, _I, _L, _I, _I, _I, _P, _P, _P],
    },
}

_INT_TYPES = (torch.uint8, torch.uint16)
_RESIZE_TILE_W = 128    # output columns per block (csrc/resize.cu TILE_W)
_RESIZE_MAX_ROWS = 192  # source rows a block stages: 192*128*4 B = 96 KB
_SI_TILE = (32, 128)    # gradient rows, cols per block (csrc/siti.cu)
_TI_BLOCKS = 64         # blocks per frame pair


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_frames(x, name: str, dtypes) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.ndim != 3:
        raise ValueError(f"{name}: expected [T, H, W], got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _launch(lib_name: str, symbol: str, kernel: str, device, *args) -> None:
    lib = _build.load(lib_name, _SIGNATURES[lib_name])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
    LAUNCHES[kernel] += 1
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def _std_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: int) -> torch.Tensor:
    """σ = sqrt(max(E[x²] − E[x]², 0)) from f64 per-frame sums → f32 [T]."""
    mean = s1 / n
    return torch.sqrt(torch.clamp(s2 / n - mean * mean, min=0.0)).to(torch.float32)


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------


def _exact_route(dtype, src_h, src_w, dst_h, dst_w, kernel: str) -> bool:
    return dtype == torch.uint8 and resize.swscale_exact_applicable(
        src_h, src_w, dst_h, dst_w, kernel
    )


def _axis_plan(src: int, dst: int, kernel: str, exact: bool, one: int):
    """([dst, K] int32 clipped source indices, [dst, K] coefficients):
    swscale integer coefficients at fixed-point `one` for the exact route,
    make_plan's f32 weights otherwise."""
    if exact:
        return resize._swscale_tap_matrix(src, dst, kernel, one)
    return resize.make_plan(src, dst, kernel)


def resize_frames_plain(
    frames: torch.Tensor, dst_h: int, dst_w: int, kernel: str = "lanczos"
) -> torch.Tensor:
    """Plain torch version of `resize_frames_fused` (same function, any
    device): u8 within the swscale envelope → `resize._swscale_exact`;
    otherwise f32 horizontal pass, u8 intermediate clamp to 32767/128,
    f32 vertical pass, floor(x + 0.5), clip to 255 or 1023."""
    src_h, src_w = frames.shape[-2], frames.shape[-1]
    if (src_h, src_w) == (dst_h, dst_w):
        return frames
    if _exact_route(frames.dtype, src_h, src_w, dst_h, dst_w, kernel):
        return resize._swscale_exact(frames, dst_h, dst_w, kernel)
    idx_h, w_h = resize.make_plan(src_w, dst_w, kernel)
    idx_v, w_v = resize.make_plan(src_h, dst_h, kernel)
    dev = frames.device
    mid = resize._apply_axis(
        frames.to(torch.float32), torch.from_numpy(idx_h).to(dev),
        torch.from_numpy(w_h).to(dev), frames.ndim - 1,
    )
    if frames.dtype == torch.uint8:
        mid = torch.clamp(mid, max=32767.0 / 128.0)
    out = resize._apply_axis(
        mid, torch.from_numpy(idx_v).to(dev), torch.from_numpy(w_v).to(dev),
        frames.ndim - 2,
    )
    maxval = 255 if frames.dtype == torch.uint8 else 1023
    out = torch.clamp(torch.floor(out + 0.5), 0, maxval)
    return out.to(torch.int32).to(frames.dtype)


@functools.lru_cache(maxsize=64)
def _device_resize_plan(src_h, src_w, dst_h, dst_w, kernel, exact, device):
    """Tap lists and row tiling of one geometry, as device tensors.

    The tile height is the tallest of 64, 32, ... rows whose source-row
    span (tap windows of all its output rows) fits the kernel's staging
    buffer, so large downscales get shorter tiles."""
    idx_h, co_h = _axis_plan(src_w, dst_w, kernel, exact, 1 << 14)
    idx_v, co_v = _axis_plan(src_h, dst_h, kernel, exact, 1 << 12)
    for tile_h in (64, 32, 16, 8, 4, 2, 1):
        n = -(-dst_h // tile_h)
        r0 = np.array([idx_v[i * tile_h:(i + 1) * tile_h].min() for i in range(n)])
        r1 = np.array([idx_v[i * tile_h:(i + 1) * tile_h].max() for i in range(n)])
        rn = r1 - r0 + 1
        if rn.max() <= _RESIZE_MAX_ROWS:
            break
    else:
        raise ValueError(
            f"resize {src_h}x{src_w}->{dst_h}x{dst_w}: vertical taps span "
            f"{int(rn.max())} rows, more than {_RESIZE_MAX_ROWS}"
        )

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    co_dtype = np.int32 if exact else np.float32
    return {
        "idx_h": dev(idx_h, np.int32), "co_h": dev(co_h, co_dtype),
        "kh": int(idx_h.shape[1]),
        "idx_v": dev(idx_v, np.int32), "co_v": dev(co_v, co_dtype),
        "kv": int(idx_v.shape[1]),
        "tile_h": tile_h, "n_tiles": n,
        "tile_r0": dev(r0, np.int32), "tile_rn": dev(rn, np.int32),
        "smem_bytes": int(rn.max()) * _RESIZE_TILE_W * 4,
    }


def resize_frames_fused(
    frames: torch.Tensor, dst_h: int, dst_w: int, kernel: str = "lanczos"
) -> torch.Tensor:
    """Fused two-pass resize of [T, src_h, src_w] u8/u16 frames to
    [T, dst_h, dst_w] of the same dtype (csrc/resize.cu). The identity
    geometry returns the input and launches nothing. CPU tensors take
    `resize_frames_plain`."""
    _check_frames(frames, "resize_frames_fused", _INT_TYPES)
    t, src_h, src_w = frames.shape
    if (src_h, src_w) == (dst_h, dst_w):
        return frames
    if frames.device.type == "cpu":
        return resize_frames_plain(frames, dst_h, dst_w, kernel)
    exact = _exact_route(frames.dtype, src_h, src_w, dst_h, dst_w, kernel)
    out = torch.empty((t, dst_h, dst_w), dtype=frames.dtype, device=frames.device)
    if t == 0:
        return out
    plan = _device_resize_plan(
        src_h, src_w, dst_h, dst_w, kernel, exact, str(frames.device)
    )
    _launch(
        "resize", "pc_resize_frames", "resize_frames_fused", frames.device,
        frames.data_ptr(), out.data_ptr(), t, frames.element_size(), int(exact),
        src_h, src_w, dst_h, dst_w, plan["tile_h"], plan["n_tiles"],
        plan["idx_h"].data_ptr(), plan["co_h"].data_ptr(), plan["kh"],
        plan["idx_v"].data_ptr(), plan["co_v"].data_ptr(), plan["kv"],
        plan["tile_r0"].data_ptr(), plan["tile_rn"].data_ptr(),
        plan["smem_bytes"], 255 if frames.dtype == torch.uint8 else 1023,
        int(frames.dtype == torch.uint8),
    )
    return out


# ---------------------------------------------------------------------------
# SI / TI
# ---------------------------------------------------------------------------


def sobel_gradients(f: torch.Tensor):
    """(gx, gy) of the 3×3 Sobel over the [H-2, W-2] interior of a float
    [H, W] plane: right minus left column, bottom minus top row, each
    weighted 1, 2, 1."""
    gx = (f[:-2, 2:] + 2 * f[1:-1, 2:] + f[2:, 2:]) - (
        f[:-2, :-2] + 2 * f[1:-1, :-2] + f[2:, :-2])
    gy = (f[2:, :-2] + 2 * f[2:, 1:-1] + f[2:, 2:]) - (
        f[:-2, :-2] + 2 * f[:-2, 1:-1] + f[:-2, 2:])
    return gx, gy


def si_frames_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `si_frames_fused`: per frame, the 3×3 Sobel
    magnitude over the (H-2)(W-2) interior in f64, σ from Σm and Σm²."""
    t, h, w = y.shape
    s1 = torch.zeros(t, dtype=torch.float64, device=y.device)
    s2 = torch.zeros(t, dtype=torch.float64, device=y.device)
    for k in range(t):
        gx, gy = sobel_gradients(y[k].to(torch.float64))
        m2 = gx * gx + gy * gy
        s1[k] = torch.sqrt(m2).sum()
        s2[k] = m2.sum()
    return _std_from_sums(s1, s2, (h - 2) * (w - 2))


def si_frames_fused(y: torch.Tensor) -> torch.Tensor:
    """SI per frame (f32 [T]) of [T, H, W] luma at container depth
    (csrc/siti.cu si_partials, then an f64 reduction of the per-block
    partials). CPU tensors (u8, u16 or f32) take `si_frames_plain`."""
    on_cpu = isinstance(y, torch.Tensor) and y.device.type == "cpu"
    _check_frames(y, "si_frames_fused",
                  _INT_TYPES + ((torch.float32,) if on_cpu else ()))
    t, h, w = y.shape
    if h < 3 or w < 3:
        raise ValueError(f"si_frames_fused: frame {h}x{w} has no Sobel interior")
    if on_cpu:
        return si_frames_plain(y)
    if t == 0:
        return torch.empty((0,), dtype=torch.float32, device=y.device)
    th, tw = _SI_TILE
    nb = -(-(h - 2) // th) * -(-(w - 2) // tw)
    ps1 = torch.empty((t, nb), dtype=torch.float32, device=y.device)
    ps2 = torch.empty((t, nb), dtype=torch.int64, device=y.device)
    _launch(
        "siti", "pc_si_partials", "si_frames_fused", y.device,
        y.data_ptr(), t, h, w, y.element_size(), ps1.data_ptr(), ps2.data_ptr(),
    )
    return _std_from_sums(
        ps1.to(torch.float64).sum(1), ps2.sum(1).to(torch.float64),
        (h - 2) * (w - 2),
    )


def ti_frames_plain(y: torch.Tensor, prev=None) -> torch.Tensor:
    """Plain torch version of `ti_frames_fused`: TI[t] = σ over H×W of
    y[t] − y[t−1] in f64, with y[−1] = prev; TI[0] = 0 without prev."""
    t, h, w = y.shape
    s1 = torch.zeros(t, dtype=torch.float64, device=y.device)
    s2 = torch.zeros(t, dtype=torch.float64, device=y.device)
    for k in range(t):
        p = y[k - 1] if k > 0 else prev
        if p is None:
            continue
        d = y[k].to(torch.float64) - p.to(torch.float64)
        s1[k] = d.sum()
        s2[k] = (d * d).sum()
    return _std_from_sums(s1, s2, h * w)


def ti_frames_fused(y: torch.Tensor, prev=None) -> torch.Tensor:
    """TI per frame (f32 [T]) of [T, H, W] luma at container depth, with an
    optional predecessor frame `prev` [H, W] of the same dtype and device:
    TI[0] diffs against it, else TI[0] = 0 (csrc/siti.cu ti_partials;
    exact int64 sums, f64 σ). CPU tensors take `ti_frames_plain`."""
    on_cpu = isinstance(y, torch.Tensor) and y.device.type == "cpu"
    _check_frames(y, "ti_frames_fused",
                  _INT_TYPES + ((torch.float32,) if on_cpu else ()))
    t, h, w = y.shape
    if prev is not None:
        if not isinstance(prev, torch.Tensor) or prev.shape != (h, w):
            raise ValueError(f"ti_frames_fused: prev must be a [{h}, {w}] tensor")
        if prev.dtype != y.dtype or prev.device != y.device:
            raise ValueError("ti_frames_fused: prev must match y's dtype and device")
        if not prev.is_contiguous():
            raise ValueError("ti_frames_fused: prev must be contiguous")
    if on_cpu:
        return ti_frames_plain(y, prev)
    if t == 0 or (t == 1 and prev is None):
        return torch.zeros((t,), dtype=torch.float32, device=y.device)
    hw = h * w
    size = y.element_size()
    vec = (hw * size) % 16 == 0 and y.data_ptr() % 16 == 0 and (
        prev is None or prev.data_ptr() % 16 == 0)
    n_blk = max(1, min(_TI_BLOCKS, -(-hw * size // (16 * 256))))
    ps1 = torch.empty((t, n_blk), dtype=torch.int64, device=y.device)
    ps2 = torch.empty((t, n_blk), dtype=torch.int64, device=y.device)
    _launch(
        "siti", "pc_ti_partials", "ti_frames_fused", y.device,
        y.data_ptr(), None if prev is None else prev.data_ptr(), t, hw, size,
        int(vec), n_blk, ps1.data_ptr(), ps2.data_ptr(),
    )
    return _std_from_sums(
        ps1.sum(1).to(torch.float64), ps2.sum(1).to(torch.float64), hw
    )
