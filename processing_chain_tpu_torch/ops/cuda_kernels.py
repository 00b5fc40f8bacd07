"""Hand-written CUDA kernels for the hot pixel ops (port of
processing_chain_tpu/ops/pallas_kernels.py).

One wrapper per TPU kernel:

  resize_frames_fused      csrc/resize.cu  (pallas_kernels.py:131-215)
  si_frames_fused          csrc/siti.cu    (pallas_kernels.py:293-313)
  ti_frames_fused          csrc/siti.cu    (pallas_kernels.py:443-465)
  siti_frames_fused        csrc/siti.cu    (pallas_kernels.py:355-383)
  siti_frames_fused_batch  csrc/siti.cu    (pallas_kernels.py:398-428)

The SI kernel and the last two, the fused SI+TI kernel's entry points,
are instances of one strip walk (siti_partials, with and without TI),
each with its own launch count.

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
import re

import numpy as np
import torch

from . import _build, resize

LAUNCHES = {"resize_frames_fused": 0, "si_frames_fused": 0, "ti_frames_fused": 0,
            "siti_frames_fused": 0, "siti_frames_fused_batch": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "resize": {
        "pc_resize_frames": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _I,
                             _P, _I, _I, _P],
    },
    "siti": {
        "pc_si_partials": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
        "pc_ti_partials": [_P, _P, _I, _L, _I, _I, _I, _P, _P, _P],
        "pc_siti_partials": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
}

_INT_TYPES = (torch.uint8, torch.uint16)
# csrc/resize.cu. resize_ring (kh == kv in _RESIZE_RING_TAPS) takes 256-column
# tiles, 32 lanes x 8 columns, and stages its row tile's source rows x the
# column tile's source window twice (double buffer over frames): the
# tallest row tile that fits a block is taken. resize_stream (every other
# plan) takes the widest column tile, then the tallest row tile, whose
# shared memory (the staged source rows, a ring of kv + 1 intermediate
# rows, the tap tables) fits _RESIZE_STREAM_SMEM_TARGET,
# so several one-warp blocks share an SM; failing that, one that fits a
# block at all.
_RESIZE_TILE_W = 256  # resize_ring's output columns per tile (csrc/resize.cu TILE_W)
_RESIZE_STREAM_TILE_WS = (256, 128, 64, 32)
# resize_stream stages source rows in groups of _RESIZE_STREAM_BATCH, a ring
# of _RESIZE_STREAM_NBUF groups, each with an mbarrier (csrc/resize.cu)
_RESIZE_STREAM_BATCH = 4
_RESIZE_STREAM_NBUF = 3
_RESIZE_STREAM_SMEM_TARGET = 32 * 1024
_RESIZE_SMEM_MAX = 227 * 1024
_RESIZE_TILE_HS = (64, 32, 16, 8, 4, 2, 1)
_RESIZE_RING_TAPS = (2, 4, 6)  # kh == kv in these: resize_ring
# grid: a few waves of the card's SMs in one-warp blocks (both kernels)
_RESIZE_BLOCKS_PER_SM = 32
_RESIZE_MIN_FRAMES = 2  # frames each block walks at least (taps loaded once)
_TI_BLOCKS = 64         # blocks per frame pair
_SITI_STRIP_ROWS = 64     # owned source rows per block (csrc/siti.cu ST_ROWS)
_SITI_BLOCK_BYTES = 4096  # owned bytes of each row per block: 256 threads x 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The CUDA symbols of csrc/*.cu as a profiler trace names them, demangled
# ("void (anonymous namespace)::siti_partials<unsigned char, true>(...)")
# or mangled ("_ZN12_GLOBAL__N_113siti_partialsIhLb1EEEv..."), and the
# LAUNCHES names whose wrappers launch each: one launch a wrapper call.
# siti_frames_fused and siti_frames_fused_batch launch one symbol.
_SYMBOL_LAUNCHES = (
    (re.compile(r"resize_(ring|stream)\b|\d+resize_(ring|stream)I"), ("resize_frames_fused",)),
    (re.compile(r"siti_partials<[^>]*,\s*false>|13siti_partialsI[th]Lb0E"), ("si_frames_fused",)),
    (re.compile(r"siti_partials<[^>]*,\s*true>|13siti_partialsI[th]Lb1E"),
     ("siti_frames_fused", "siti_frames_fused_batch")),
    (re.compile(r"(?<![A-Za-z_])ti_partials<|11ti_partialsI"), ("ti_frames_fused",)),
)


def launch_names(symbol: str) -> tuple:
    """The LAUNCHES names whose wrappers launch the kernel a profiler trace
    names `symbol` (empty for a kernel that is not one of csrc/*.cu's)."""
    for pattern, names in _SYMBOL_LAUNCHES:
        if pattern.search(symbol):
            return names
    return ()


def _check_frames(x, name: str, dtypes, layout: str = "[T, H, W]") -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.ndim != layout.count(",") + 1:
        raise ValueError(f"{name}: expected {layout}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _check_predecessor(prev, shape: tuple, y: torch.Tensor, name: str) -> None:
    if not isinstance(prev, torch.Tensor) or tuple(prev.shape) != shape:
        raise ValueError(f"{name}: prev must be a {list(shape)} tensor")
    if prev.dtype != y.dtype or prev.device != y.device:
        raise ValueError(f"{name}: prev must match y's dtype and device")
    if not prev.is_contiguous():
        raise ValueError(f"{name}: prev must be contiguous")


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


def _window_starts(idx: np.ndarray, src: int) -> np.ndarray:
    """Unclipped first source index s[i] of each tap row, such that
    idx[i, k] == clip(s[i] + k, 0, src - 1); raises ValueError for a tap
    matrix whose rows are not such clipped windows."""
    k = idx.shape[1]
    positive = idx > 0
    first = np.argmax(positive, axis=1)
    rows = np.arange(idx.shape[0])
    starts = np.where(positive.any(axis=1), idx[rows, first].astype(np.int64) - first, 1 - k)
    if not np.array_equal(np.clip(starts[:, None] + np.arange(k), 0, src - 1), idx):
        raise ValueError(f"tap matrix over {src} samples is not a clipped window")
    return starts


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _ring_tile_bytes(rn, sw, elem, tile_h, k) -> int:
    """The budget resize_ring's row tiles are sized by (the former two-pass
    kernel's total: the staged rows twice, a [rn, 256] 4-byte intermediate, the
    tap tables), kept so that the ring's plans stay as measured: a taller
    tile would hold more of a block's shared memory and fewer blocks an
    SM."""
    return (2 * rn * sw * elem + rn * _RESIZE_TILE_W * 4 + _round_up(tile_h * k * 4, 16)
            + _round_up(_RESIZE_TILE_W * k * 4, 16) + _round_up(tile_h * 4, 16))


def _ring_smem_bytes(rn, sw, elem, tile_h, k) -> int:
    """resize_ring's dynamic shared memory (csrc/resize.cu launch_ring):
    two source buffers of rn x sw samples, vertical coefficients, vertical
    window ends."""
    return (2 * _round_up(rn * sw * elem, 16) + _round_up(tile_h * k * 4, 16)
            + _round_up(tile_h * 4, 16))


def _stream_smem_bytes(sw, elem, tile_w, tile_h, kv, kp, exact) -> int:
    """resize_stream's dynamic shared memory, region by region as
    csrc/resize.cu `stream_layout` lays it out: the staged source rows
    (groups of _RESIZE_STREAM_BATCH, _RESIZE_STREAM_NBUF groups),
    the ring of kv + 1 intermediate rows (4 bytes a sample; two rows are
    written a step), the horizontal coefficients (kp taps, int16 on the
    exact route, f32 otherwise), the vertical coefficients, the vertical
    window ends, one mbarrier a staging group."""
    stages = _RESIZE_STREAM_BATCH * _RESIZE_STREAM_NBUF
    return (_round_up(stages * sw * elem, 16) + (kv + 1) * tile_w * 4
            + kp * tile_w * (2 if exact else 4)
            + _round_up(tile_h * kv * 4, 16) + _round_up(tile_h * 4, 16)
            + _round_up(_RESIZE_STREAM_NBUF * 8, 16))


def _stream_group_unroll(tile_w: int) -> int:
    """resize_stream's 4-tap groups per step of its tap loop at tile_w
    columns (tile_w / 32 a lane), so that a step holds at least 4
    independent column sums (csrc/resize.cu stream_groups); its taps are
    padded to a multiple of 4 x this."""
    per_lane = tile_w // 32
    return 1 if per_lane >= 4 else 4 // per_lane


def _column_tiles(hs: np.ndarray, dst_w: int, tile_w: int, reach: int, nv: int) -> tuple:
    """(hpos [n_ct * tile_w], xb [n_ct], sw) of output column tiles of
    tile_w: tile c stages the source window [xb[c], xb[c] + sw) (xb a
    multiple of one 16-byte vector of nv samples, samples outside the frame
    replicate its edge), hpos[j] is column j's first tap relative to its
    tile's xb (0 past dst_w), and every column reads at most `reach`
    samples from its first tap."""
    n_ct = -(-dst_w // tile_w)
    hs_pad = np.zeros(n_ct * tile_w, np.int64)
    hs_pad[:dst_w] = hs
    xb = np.array([hs[c * tile_w:(c + 1) * tile_w].min() // nv * nv for c in range(n_ct)])
    hpos = hs_pad - np.repeat(xb, tile_w)
    hpos[dst_w:] = 0
    return hpos, xb, _round_up(int(hpos.max()) + reach, nv)


def _row_tiles(vs: np.ndarray, kv: int, tile_h: int) -> tuple:
    """(rlo [n_rt], rn) of output row tiles of tile_h: tile r stages source
    rows rlo[r] .. rlo[r] + rn - 1 (clipped)."""
    n_rt = -(-len(vs) // tile_h)
    rlo = np.array([vs[r * tile_h:(r + 1) * tile_h].min() for r in range(n_rt)])
    rn = int(max(vs[r * tile_h:(r + 1) * tile_h].max() - rlo[r] for r in range(n_rt))) + kv
    return rlo, rn


def _stream_hco(co_h: np.ndarray, n_ct: int, tile_w: int, kp: int, exact: bool) -> np.ndarray:
    """resize_stream's horizontal coefficients, per column tile: exact,
    [n_ct, kp / 4, tile_w, 2] int32, each word two int16 coefficients
    (taps 4g, 4g + 1, then 4g + 2, 4g + 3; the low half first), as dp2a
    reads them; f32, [n_ct, kp, tile_w]. Taps past kh and columns past
    dst_w weigh 0."""
    dst_w, kh = co_h.shape
    full = np.zeros((n_ct * tile_w, kp), np.int64 if exact else np.float32)
    full[:dst_w, :kh] = co_h
    full = full.reshape(n_ct, tile_w, kp)
    if not exact:
        return np.ascontiguousarray(full.transpose(0, 2, 1))
    if full.min() < -(1 << 15) or full.max() >= 1 << 15:
        raise ValueError("a horizontal coefficient does not fit int16")
    quads = full.reshape(n_ct, tile_w, kp // 4, 4).transpose(0, 2, 1, 3) & 0xFFFF
    words = (quads[..., 0::2] | (quads[..., 1::2] << 16)).astype(np.uint32)
    return np.ascontiguousarray(words.view(np.int32))


def _resize_plan(src_h, src_w, dst_h, dst_w, kernel, exact, elem_bytes) -> dict:
    """Host plan of one geometry for csrc/resize.cu (numpy arrays).

    Columns: output column tiles of tile_w (`_column_tiles`). Rows: tiles
    of tile_h output rows (`_row_tiles`); vpos[i] is row i's first tap
    relative to its tile's rlo, non-decreasing in i. Taps beyond dst_w or
    dst_h are padding with coefficient 0 (column start 0; row start that
    of the last row). `ring`: kh == kv in (2, 4, 6), which resize_ring
    takes, with co_h [n_ct * 256, kh]; resize_stream takes the rest, with
    kh padded to kp taps, a multiple of 4 x gu (`_stream_group_unroll`),
    and co_h laid out by `_stream_hco`."""
    idx_h, co_h = _axis_plan(src_w, dst_w, kernel, exact, 1 << 14)
    idx_v, co_v = _axis_plan(src_h, dst_h, kernel, exact, 1 << 12)
    kh, kv = int(idx_h.shape[1]), int(idx_v.shape[1])
    nv = 16 // elem_bytes
    hs = _window_starts(idx_h, src_w)
    vs = _window_starts(idx_v, src_h)
    ring = kh == kv and kh in _RESIZE_RING_TAPS
    if ring:
        candidates = [(_RESIZE_SMEM_MAX, _RESIZE_TILE_W, th) for th in _RESIZE_TILE_HS]
    else:
        # the widest tile within the target; failing that, the narrowest
        # that fits a block at all
        target = min(_RESIZE_STREAM_SMEM_TARGET, _RESIZE_SMEM_MAX)
        candidates = [(b, tw, th) for b, tws in ((target, _RESIZE_STREAM_TILE_WS),
                                                 (_RESIZE_SMEM_MAX, _RESIZE_STREAM_TILE_WS[::-1]))
                      for tw in tws for th in _RESIZE_TILE_HS]
    cols = functools.lru_cache(maxsize=None)(
        lambda tw, reach: _column_tiles(hs, dst_w, tw, reach, nv))
    smem = None
    for budget, tile_w, tile_h in candidates:
        if ring:
            kp, gu = kh, 0
        else:
            gu = _stream_group_unroll(tile_w)
            kp = _round_up(kh, 4 * gu)
        # resize_stream's dp2a reads whole words: up to 4 samples past the last tap
        hpos, xb, sw = cols(tile_w, kh if ring else kp + 4)
        rlo, rn = _row_tiles(vs, kv, tile_h)
        if ring:
            smem = _ring_smem_bytes(rn, sw, elem_bytes, tile_h, kv)
            fits = _ring_tile_bytes(rn, sw, elem_bytes, tile_h, kv) <= budget
        else:
            smem = _stream_smem_bytes(sw, elem_bytes, tile_w, tile_h, kv, kp, exact)
            fits = smem <= budget
        if fits:
            break
    else:
        raise ValueError(
            f"resize {src_h}x{src_w}->{dst_h}x{dst_w} {kernel}: the smallest tile "
            f"needs {smem} bytes of shared memory, more than {_RESIZE_SMEM_MAX}"
        )
    n_ct, n_rt = len(xb), len(rlo)
    vpos = np.zeros(n_rt * tile_h, np.int64)
    vpos[:dst_h] = vs - np.repeat(rlo, tile_h)[:dst_h]
    vpos[dst_h:] = vpos[dst_h - 1]  # non-decreasing in each tile, as the kernels need
    vco = np.zeros((n_rt * tile_h, kv), co_v.dtype)
    vco[:dst_h] = co_v
    if ring:
        hco = np.zeros((n_ct * tile_w, kh), co_h.dtype)
        hco[:dst_w] = co_h
    else:
        hco = _stream_hco(co_h, n_ct, tile_w, kp, exact)
    return {
        "hpos": hpos, "co_h": hco, "kh": kh, "kp": kp, "gu": gu, "tile_xb": xb,
        "sw": sw, "n_ct": n_ct, "tile_w": tile_w, "vpos": vpos, "co_v": vco, "kv": kv,
        "tile_rlo": rlo, "rn": rn, "tile_h": tile_h, "n_rt": n_rt, "smem_bytes": smem,
        "ring": ring,
    }


def _resize_grid_z(t: int, n_ct: int, n_rt: int, sms: int) -> int:
    """Frame groups of the persistent grid: blocks (column tile, row tile,
    z) walk frames z, z + Z, ...; Z fills a few waves of the card's `sms`
    SMs while every block walks at least _RESIZE_MIN_FRAMES frames where T
    allows."""
    target = sms * _RESIZE_BLOCKS_PER_SM
    by_card = max(1, target // (n_ct * n_rt))
    return max(1, min(-(-t // _RESIZE_MIN_FRAMES), by_card, 65535))


@functools.lru_cache(maxsize=64)
def _device_resize_plan(src_h, src_w, dst_h, dst_w, kernel, exact, elem_bytes, device):
    """`_resize_plan` of one geometry with its arrays as device tensors."""
    plan = _resize_plan(src_h, src_w, dst_h, dst_w, kernel, exact, elem_bytes)
    co_dtype = np.int32 if exact else np.float32
    for key in ("hpos", "tile_xb", "vpos", "tile_rlo", "co_h", "co_v"):
        dtype = co_dtype if key.startswith("co") else np.int32
        plan[key] = torch.from_numpy(np.ascontiguousarray(plan[key], dtype=dtype)).to(device)
    return plan


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
    size = frames.element_size()
    plan = _device_resize_plan(
        src_h, src_w, dst_h, dst_w, kernel, exact, size, str(frames.device)
    )
    vec = (src_w * size) % 16 == 0 and frames.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(frames.device).multi_processor_count
    _launch(
        "resize", "pc_resize_frames", "resize_frames_fused", frames.device,
        frames.data_ptr(), out.data_ptr(), t, size, int(exact),
        src_h, src_w, dst_h, dst_w, plan["tile_w"], plan["tile_h"], plan["n_rt"],
        plan["rn"], plan["sw"],
        _resize_grid_z(t, plan["n_ct"], plan["n_rt"], sms),
        int(plan["ring"]), int(vec),
        plan["hpos"].data_ptr(), plan["co_h"].data_ptr(), plan["kp"],
        plan["tile_xb"].data_ptr(), plan["vpos"].data_ptr(),
        plan["co_v"].data_ptr(), plan["kv"], plan["tile_rlo"].data_ptr(),
        255 if frames.dtype == torch.uint8 else 1023,
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
    (csrc/siti.cu siti_partials without TI, then an f64 reduction of the
    per-block partials). CPU tensors (u8, u16 or f32) take
    `si_frames_plain`."""
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
    size = y.element_size()
    vec = (w * size) % 16 == 0 and y.data_ptr() % 16 == 0
    ps1, pint = _siti_partial_buffers(t, h, w, size, y.device, ti=False)
    _launch(
        "siti", "pc_si_partials", "si_frames_fused", y.device,
        y.data_ptr(), t, h, w, size, int(vec), ps1.data_ptr(), pint[0].data_ptr(),
    )
    return _std_from_sums(ps1.sum(1), pint[0].sum(1).to(torch.float64), (h - 2) * (w - 2))


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
        _check_predecessor(prev, (h, w), y, "ti_frames_fused")
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


# ---------------------------------------------------------------------------
# Fused SI + TI
# ---------------------------------------------------------------------------


def siti_frames_plain(y: torch.Tensor):
    """Plain torch version of `siti_frames_fused`: (SI[T], TI[T]) of
    [T, H, W] luma, TI[0] = 0."""
    return si_frames_plain(y), ti_frames_plain(y)


def siti_frames_batch_plain(y: torch.Tensor, prev_last: torch.Tensor):
    """Plain torch version of `siti_frames_fused_batch`: per lane b,
    (SI[b], TI[b]) of y[b] with TI[b, 0] against prev_last[b]."""
    b, t = y.shape[0], y.shape[1]
    si = torch.zeros((b, t), dtype=torch.float32, device=y.device)
    ti = torch.zeros((b, t), dtype=torch.float32, device=y.device)
    for k in range(b):
        si[k] = si_frames_plain(y[k])
        ti[k] = ti_frames_plain(y[k], prev_last[k])
    return si, ti


def _siti_inputs(y, name: str, layout: str) -> bool:
    """Check y for a fused SI+TI wrapper; True when it lies on the CPU."""
    on_cpu = isinstance(y, torch.Tensor) and y.device.type == "cpu"
    _check_frames(y, name, _INT_TYPES + ((torch.float32,) if on_cpu else ()), layout)
    h, w = y.shape[-2], y.shape[-1]
    if h < 3 or w < 3:
        raise ValueError(f"{name}: frame {h}x{w} has no Sobel interior")
    return on_cpu


def _siti_grid(h: int, w: int, size: int) -> tuple:
    """(row strips, column blocks) of one frame in siti_partials (both
    instances): each block owns up to 64 rows x 4096 bytes of columns and
    writes one partial of each sum."""
    return -(-h // _SITI_STRIP_ROWS), -(-w * size // _SITI_BLOCK_BYTES)


def _siti_partial_buffers(nz: int, h: int, w: int, size: int, device, ti: bool = True):
    """siti_partials' outputs for nz frames, one entry per block: Σ|∇|
    (f64 [nz, blocks]) and Σ(gx²+gy²), then with `ti` Σd and Σd² (int64
    [3, nz, blocks], or [1, nz, blocks] for the SI pass)."""
    nb = int(np.prod(_siti_grid(h, w, size)))
    return (torch.empty((nz, nb), dtype=torch.float64, device=device),
            torch.empty((3 if ti else 1, nz, nb), dtype=torch.int64, device=device))


def _siti_launch(y: torch.Tensor, prev, name: str):
    """One siti_partials launch over y [B, T, H, W] (prev [B, H, W] or
    None), then the f64 reduction of the per-block partials →
    (SI[B, T], TI[B, T])."""
    b, t, h, w = y.shape
    nz = b * t
    if nz == 0:
        empty = torch.zeros((b, t), dtype=torch.float32, device=y.device)
        return empty, empty.clone()
    size = y.element_size()
    vec = (w * size) % 16 == 0 and y.data_ptr() % 16 == 0 and (
        prev is None or prev.data_ptr() % 16 == 0)
    ps1, pint = _siti_partial_buffers(nz, h, w, size, y.device)
    _launch(
        "siti", "pc_siti_partials", name, y.device,
        y.data_ptr(), None if prev is None else prev.data_ptr(), t, nz, h, w,
        size, int(vec), ps1.data_ptr(), pint[0].data_ptr(),
        pint[1].data_ptr(), pint[2].data_ptr(),
    )
    sums = pint.sum(2).to(torch.float64)
    si = _std_from_sums(ps1.sum(1), sums[0], (h - 2) * (w - 2))
    ti = _std_from_sums(sums[1], sums[2], h * w)
    return si.reshape(b, t), ti.reshape(b, t)


def siti_frames_fused(y: torch.Tensor):
    """(SI[T], TI[T]) (f32) of [T, H, W] luma at container depth in one
    pass, TI[0] = 0 (csrc/siti.cu siti_partials with no predecessor for
    frame 0). CPU tensors (u8, u16 or f32) take `siti_frames_plain`."""
    if _siti_inputs(y, "siti_frames_fused", "[T, H, W]"):
        return siti_frames_plain(y)
    si, ti = _siti_launch(y[None], None, "siti_frames_fused")
    return si[0], ti[0]


def siti_frames_fused_batch(y: torch.Tensor, prev_last: torch.Tensor):
    """(SI[B, T], TI[B, T]) (f32) of [B, T, H, W] luma lanes in one pass;
    TI[b, 0] diffs against prev_last[b] ([B, H, W], same dtype and
    device), which the kernel reads in place (csrc/siti.cu siti_partials).
    CPU tensors take `siti_frames_batch_plain`."""
    on_cpu = _siti_inputs(y, "siti_frames_fused_batch", "[B, T, H, W]")
    b, _, h, w = y.shape
    _check_predecessor(prev_last, (b, h, w), y, "siti_frames_fused_batch")
    if on_cpu:
        return siti_frames_batch_plain(y, prev_last)
    return _siti_launch(y, prev_last, "siti_frames_fused_batch")
