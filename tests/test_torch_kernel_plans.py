"""The host plans of the port's CUDA kernels, on the CPU.

csrc/resize.cu runs what ops/cuda_kernels._resize_plan lays out: column
tiles with a staged source window, row tiles with staged source rows,
and window starts relative to them. These tests hold the plan's
invariants, and replay the kernel's
blocking in numpy (staging with clipped edges, the horizontal pass into
the tile's intermediate, the vertical pass from it) against the plain
torch version, so a plan fault shows here before the card runs it."""

import numpy as np
import pytest
import torch

from processing_chain_tpu.ops import resize as jr
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.ops import resize as tr

# the chain's AVPVS upscales onto 3840x2160 (from 1920x1080, 1280x720,
# 960x540 and 640x360) and the chroma 960x540 -> 1920x1080, per axis
CHAIN_AXES = ((1920, 3840), (1080, 2160), (1280, 3840), (720, 2160),
              (960, 3840), (540, 2160), (640, 3840), (360, 2160), (960, 1920),
              (540, 1080))
CARD_GEOMS = ((45, 80, 90, 160), (101, 77, 33, 250), (37, 61, 37, 130),
              (300, 20, 21, 300), (64, 64, 1000, 17))
# small analogs of the chain's downscales, for resize_stream: 2x, 3x with a
# ragged width, 6x, 12x, 16x (the swscale envelope's edge), and 2x rows
# with 12x columns (kh != kv)
DOWNSCALE_GEOMS = ((96, 200, 48, 100), (90, 301, 30, 100), (96, 390, 16, 65),
                   (192, 770, 16, 64), (256, 1024, 16, 64), (100, 970, 50, 81))
# the chain's downscales, per plane (source, output): the mobile CPVS
# (2160p -> 1080p), p01's quality ladder from 1080p and 2160p sources to
# 1280x720, 640x360 and 320x180, and a 2160p -> 1440p context
CHAIN_DOWNSCALES = tuple(
    plane for (sh, sw), (dh, dw) in (
        ((2160, 3840), (1080, 1920)),
        ((1080, 1920), (720, 1280)), ((1080, 1920), (360, 640)), ((1080, 1920), (180, 320)),
        ((2160, 3840), (720, 1280)), ((2160, 3840), (360, 640)), ((2160, 3840), (180, 320)),
        ((2160, 3840), (1440, 2560)))
    for plane in ((sh, sw, dh, dw), (sh // 2, sw // 2, dh // 2, dw // 2)))


def _plan(geom, kernel, dtype):
    sh, sw, dh, dw = geom
    exact = ck._exact_route(dtype, sh, sw, dh, dw, kernel)
    elem = 1 if dtype == torch.uint8 else 2
    return ck._resize_plan(sh, sw, dh, dw, kernel, exact, elem), exact


def _emulate_ring(x: np.ndarray, p: dict, exact: bool, dtype) -> np.ndarray:
    """resize_ring's blocking replayed in numpy: per (row tile, column
    tile), stage clip-indexed source rows and columns, run the horizontal
    pass over the staged window into the intermediate, then the vertical
    pass; f32 arithmetic rounds one product and one sum at a time in tap
    order, as the kernel does."""
    t, sh, sw_src = x.shape
    tw, th = p["tile_w"], p["tile_h"]
    kh, kv, rn, sw = p["kh"], p["kv"], p["rn"], p["sw"]
    out = np.zeros((t, p["n_rt"] * th, p["n_ct"] * tw), np.int64)
    maxval = 255 if dtype == torch.uint8 else 1023
    for rt in range(p["n_rt"]):
        rows = np.clip(p["tile_rlo"][rt] + np.arange(rn), 0, sh - 1)
        i = rt * th + np.arange(th)
        vt = p["vpos"][i][:, None] + np.arange(kv)          # [th, kv]
        assert vt.min() >= 0 and vt.max() < rn
        for ct in range(p["n_ct"]):
            cols = np.clip(p["tile_xb"][ct] + np.arange(sw), 0, sw_src - 1)
            buf = x[:, rows][:, :, cols]                     # [t, rn, sw]
            j = ct * tw + np.arange(tw)
            ht = p["hpos"][j][:, None] + np.arange(kh)       # [tw, kh]
            assert ht.min() >= 0 and ht.max() < sw
            g = buf[:, :, ht]                                # [t, rn, tw, kh]
            if exact:
                mid = (g.astype(np.int64) * p["co_h"][j]).sum(-1) >> 7
                mid = np.minimum(mid, 32767)
                gv = mid[:, vt]                              # [t, th, kv, tw]
                acc = (gv * p["co_v"][i][:, :, None]).sum(2)
                o = np.clip((acc + (64 << 12)) >> 19, 0, 255)
            else:
                g = g.astype(np.float32)
                mid = g[..., 0] * p["co_h"][j][:, 0]
                for k in range(1, kh):
                    mid = mid + g[..., k] * p["co_h"][j][:, k]
                if dtype == torch.uint8:
                    mid = np.minimum(mid, np.float32(32767.0 / 128.0))
                gv = mid[:, vt]
                cv = p["co_v"][i]
                acc = gv[:, :, 0] * cv[:, 0][:, None]
                for k in range(1, kv):
                    acc = acc + gv[:, :, k] * cv[:, k][:, None]
                o = np.clip(np.floor(acc + np.float32(0.5)), 0, maxval).astype(np.int64)
            out[:, rt * th:(rt + 1) * th, ct * tw:(ct + 1) * tw] = o
    return out


def _unpack_stream_hco(p: dict, exact: bool) -> np.ndarray:
    """resize_stream's horizontal coefficients back as [n_ct, tile_w, kp]:
    the exact route's words hold two int16 taps, the low half first."""
    if not exact:
        return p["co_h"].transpose(0, 2, 1)
    words = p["co_h"].view(np.uint32).astype(np.int64)       # [n_ct, kp/4, tw, 2]
    halves = np.stack([words & 0xFFFF, words >> 16], -1)     # [.., 2, 2]
    halves = np.where(halves >= 1 << 15, halves - (1 << 16), halves)
    n_ct, groups, tw = words.shape[:3]
    return halves.reshape(n_ct, groups, tw, 4).transpose(0, 2, 1, 3).reshape(n_ct, tw, 4 * groups)


def _emulate_stream(x: np.ndarray, p: dict, exact: bool, dtype) -> np.ndarray:
    """resize_stream's walk replayed in numpy: per (row tile, column tile),
    staged rows s = 0 .. rn - 1 in order (clip-indexed rows and columns),
    each one horizontal pass into ring slot s % (kv + 1); then every output
    row whose window ends at s, read from slots (s - kv + 1 + k) % (kv + 1)
    (the kernel writes two rows a step, so the ring holds one row more than
    a window). The exact
    route's horizontal pass sums the packed int16 taps against the four
    bytes at off + 4g .. off + 4g + 3 (dp2a), reading whole words inside
    the staged row; f32 arithmetic rounds one product and one sum at a time
    in tap order."""
    t, sh, sw_src = x.shape
    tw, th, kp, kv, rn, sw = p["tile_w"], p["tile_h"], p["kp"], p["kv"], p["rn"], p["sw"]
    assert kp % (4 * p["gu"]) == 0 and kp >= p["kh"]
    hco = _unpack_stream_hco(p, exact)
    out = np.zeros((t, p["n_rt"] * th, p["n_ct"] * tw), np.int64)
    maxval = 255 if dtype == torch.uint8 else 1023
    for rt in range(p["n_rt"]):
        vpos = p["vpos"][rt * th:(rt + 1) * th]
        vend = vpos + kv - 1
        rows = min(th, out.shape[1] - rt * th)
        assert vpos.min() >= 0 and vend[:rows].max() < rn
        for ct in range(p["n_ct"]):
            cols = np.clip(p["tile_xb"][ct] + np.arange(sw), 0, sw_src - 1)
            off = p["hpos"][ct * tw:(ct + 1) * tw]
            # dp2a reads words (off >> 2) .. (off >> 2) + kp / 4 of the row
            assert off.min() >= 0 and ((off >> 2) + kp // 4 + 1).max() * 4 <= sw
            taps = off[:, None] + np.arange(kp)                   # [tw, kp]
            c = hco[ct]                                           # [tw, kp]
            ring = [None] * (kv + 1)
            i = 0
            for s in range(rn):
                r = int(np.clip(p["tile_rlo"][rt] + s, 0, sh - 1))
                g = x[:, r][:, cols][:, taps]                     # [t, tw, kp]
                if exact:
                    m = np.minimum((g.astype(np.int64) * c).sum(-1) >> 7, 32767)
                else:
                    g = g.astype(np.float32)
                    m = np.zeros(g.shape[:2], np.float32)
                    for k in range(kp):
                        m = m + g[..., k] * c[:, k]
                    if dtype == torch.uint8:
                        m = np.minimum(m, np.float32(32767.0 / 128.0))
                ring[s % (kv + 1)] = m
                while i < rows and vend[i] == s:
                    cv = p["co_v"][rt * th + i]
                    window = [ring[(s - kv + 1 + k) % (kv + 1)] for k in range(kv)]
                    if exact:
                        acc = sum(w * int(ck) for w, ck in zip(window, cv)) + (64 << 12)
                        o = np.clip(acc >> 19, 0, 255)
                    else:
                        acc = np.zeros_like(window[0])
                        for w, ck in zip(window, cv):
                            acc = acc + w * ck
                        o = np.clip(np.floor(acc + np.float32(0.5)), 0, maxval)
                    out[:, rt * th + i, ct * tw:(ct + 1) * tw] = o
                    i += 1
            assert i == rows  # every row of the strip emitted once
    return out


def _emulate(x: np.ndarray, geom, kernel, dtype) -> np.ndarray:
    """csrc/resize.cu's blocking for the kernel the plan takes, in numpy."""
    p, exact = _plan(geom, kernel, dtype)
    run = _emulate_ring if p["ring"] else _emulate_stream
    return run(x, p, exact, dtype)[:, :geom[2], :geom[3]]


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos", "bilinear"])
@pytest.mark.parametrize("geom", CARD_GEOMS + (
    (8, 1280, 24, 3840), (8, 640, 48, 3840), (5, 67, 11, 203), (6, 33, 13, 9))
    + DOWNSCALE_GEOMS)
@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_resize_blocking_replay_equals_plain(kernel, geom, dtype, hi):
    rng = np.random.default_rng(sum(geom))
    x = rng.integers(0, hi + 1, (2,) + geom[:2])
    want = ck.resize_frames_plain(
        torch.from_numpy(x.astype(np.uint8 if hi == 255 else np.uint16)),
        geom[2], geom[3], kernel)
    np.testing.assert_array_equal(_emulate(x, geom, kernel, dtype), want.numpy().astype(np.int64))


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos", "bilinear"])
@pytest.mark.parametrize("elem", [1, 2])
def test_resize_plan_windows_lie_inside_the_staged_tile(kernel, elem):
    """Every output row's vertical window lies in its row tile's staged
    rows, every column's horizontal window in its column tile's staged
    window, and staging is whole 16-byte vectors, at every chain axis."""
    nv = 16 // elem
    for src, dst in CHAIN_AXES:
        dtype = torch.uint8 if elem == 1 else torch.uint16
        exact = ck._exact_route(dtype, src, src, dst, dst, kernel)
        p = ck._resize_plan(src, src, dst, dst, kernel, exact, elem)
        assert p["sw"] % nv == 0 and (p["tile_xb"] % nv == 0).all()
        assert p["hpos"].min() >= 0 and p["hpos"].max() + p["kh"] <= p["sw"]
        assert p["vpos"].min() >= 0 and p["vpos"].max() + p["kv"] <= p["rn"]
        # the vertical pass merges the windows of consecutive rows
        assert (np.diff(p["vpos"].reshape(p["n_rt"], p["tile_h"]), axis=1) >= 0).all()
        idx_v = ck._axis_plan(src, dst, kernel, exact, 1 << 12)[0]
        for rt in range(p["n_rt"]):
            rows = np.clip(p["tile_rlo"][rt] + np.arange(p["rn"]), 0, src - 1)
            i = np.arange(rt * p["tile_h"], min((rt + 1) * p["tile_h"], dst))
            staged = rows[p["vpos"][i][:, None] + np.arange(p["kv"])]
            np.testing.assert_array_equal(staged, idx_v[i])
        assert p["smem_bytes"] <= ck._RESIZE_SMEM_MAX
        assert p["tile_h"] == 64  # the chain's upscales take the tallest tile


@pytest.mark.parametrize("geom,kernel,ring", [
    ((1080, 1920, 2160, 3840), "bicubic", True), ((540, 960, 1080, 1920), "lanczos", True),
    ((360, 640, 2160, 3840), "lanczos", True), ((45, 80, 90, 160), "bilinear", True),
    ((300, 20, 21, 300), "bicubic", False), ((64, 64, 1000, 17), "lanczos", False),
    ((37, 61, 37, 130), "bicubic", False),
])
def test_resize_ring_walk_emits_every_row_once(geom, kernel, ring):
    """resize_ring takes the plans with kh == kv in (2, 4, 6). Its walk, run
    here on indices: staged row rr goes to ring slot rr % K, and output row
    i is emitted when row vpos[i] + K - 1 arrives, reading tap k from slot
    (rr % K + 1 + k) % K. Every row of every tile is emitted once, with the
    taps of its own window in order."""
    sh, sw, dh, dw = geom
    p = ck._resize_plan(sh, sw, dh, dw, kernel, ck._exact_route(torch.uint8, *geom, kernel), 1)
    assert p["ring"] == ring
    if not ring:
        return
    k = p["kh"]
    for rt in range(p["n_rt"]):
        vpos = p["vpos"][rt * p["tile_h"]:(rt + 1) * p["tile_h"]]
        rows = min(p["tile_h"], dh - rt * p["tile_h"])
        slots, emitted = [None] * k, []
        for rr in range(p["rn"]):
            slots[rr % k] = rr
            while len(emitted) < rows and vpos[len(emitted)] + k - 1 == rr:
                i = len(emitted)
                taps = [slots[(rr % k + 1 + j) % k] for j in range(k)]
                assert taps == [vpos[i] + j for j in range(k)]
                emitted.append(i)
        assert emitted == list(range(rows))


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
def test_exact_plan_taps_are_the_jax_swscale_taps(kernel):
    """On the exact route the plan's windows and integer coefficients,
    unfolded from tile-relative starts, are the JAX package's own swscale
    plan (14-bit horizontal, 12-bit vertical), at every chain axis."""
    for src, dst in CHAIN_AXES:
        assert ck._exact_route(torch.uint8, src, src, dst, dst, kernel)
        p = ck._resize_plan(src, src, dst, dst, kernel, True, 1)
        k = np.arange(p["kh"])
        j = np.arange(dst)
        xb = p["tile_xb"][j // ck._RESIZE_TILE_W]
        pos_h, co_h = jr.make_swscale_plan(src, dst, kernel, 1 << 14)
        np.testing.assert_array_equal(
            np.clip((xb + p["hpos"][j])[:, None] + k, 0, src - 1),
            np.clip(pos_h[:, None] + k, 0, src - 1))
        np.testing.assert_array_equal(p["co_h"][:dst], co_h)
        rlo = p["tile_rlo"][j // p["tile_h"]]
        pos_v, co_v = jr.make_swscale_plan(src, dst, kernel, 1 << 12)
        np.testing.assert_array_equal(
            np.clip((rlo + p["vpos"][j])[:, None] + k, 0, src - 1),
            np.clip(pos_v[:, None] + k, 0, src - 1))
        np.testing.assert_array_equal(p["co_v"][:dst], co_v)


def test_resize_plan_that_does_not_fit_raises(monkeypatch):
    """Both kernels' plans raise where no tile fits a block: resize_ring's
    double-buffered staged rows, resize_stream's ring of kv intermediate
    rows (1 KB at kv = 8 and the narrowest tile)."""
    monkeypatch.setattr(ck, "_RESIZE_SMEM_MAX", 1024)
    for geom in ((1080, 1920, 2160, 3840), (2160, 3840, 1080, 1920)):
        with pytest.raises(ValueError, match="shared memory"):
            ck._resize_plan(*geom, "bicubic", True, 1)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("geom", CHAIN_DOWNSCALES)
def test_resize_plan_fits_every_chain_downscale(geom, kernel, dtype):
    """Every downscale plane of the chain has a plan within a block's
    shared memory (the whole-strip design raised at 2160x3840 -> 180x320
    and 1080x1920 -> 90x160): resize_ring's for the 1.5x bicubic planes
    (6 taps a pass), resize_stream's for the rest, within the target that
    lets several blocks share an SM, with every window inside its staged
    tile."""
    p, exact = _plan(geom, kernel, dtype)
    assert exact == (dtype == torch.uint8)
    assert p["smem_bytes"] <= ck._RESIZE_SMEM_MAX
    if p["ring"]:
        assert p["kh"] == p["kv"] == 6 and kernel == "bicubic"
        return
    assert p["smem_bytes"] <= ck._RESIZE_STREAM_SMEM_TARGET
    assert p["tile_w"] in ck._RESIZE_STREAM_TILE_WS and p["tile_h"] in ck._RESIZE_TILE_HS
    assert p["kp"] >= p["kh"] and p["kp"] == ck._round_up(p["kh"], 4 * p["gu"])
    assert p["gu"] == ck._stream_group_unroll(p["tile_w"])
    assert p["hpos"].min() >= 0 and p["hpos"].max() + p["kp"] + 4 <= p["sw"]
    assert p["vpos"].min() >= 0 and p["vpos"].max() + p["kv"] <= p["rn"]
    elem = 1 if dtype == torch.uint8 else 2
    assert p["smem_bytes"] == ck._stream_smem_bytes(
        p["sw"], elem, p["tile_w"], p["tile_h"], p["kv"], p["kp"], exact)


# every swscale coefficient table the exact route can take: one source
# width at ratios from 1/4 to the envelope's 16
_ENVELOPE_AXES = tuple((960, round(960 / r)) for r in (
    0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 16.0))


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
def test_exact_route_ranges_fit_the_kernel_types(kernel):
    """The facts resize_stream's exact route relies on, over the envelope:
    every 14-bit horizontal coefficient fits int16 (dp2a's packed pairs);
    every partial sum of the horizontal MAC is below 255 * sum|c_h| < 2^24,
    so int32 holds it in any order; the intermediate (>> 7, top-clamped
    to 32767) lies in int16; and the vertical int32 sum, with its rounding
    constant, stays below 2^31 in any order."""
    for src, dst in _ENVELOPE_AXES:
        _, ch = tr.make_swscale_plan(src, dst, kernel, 1 << 14)
        _, cv = tr.make_swscale_plan(src, dst, kernel, 1 << 12)
        ch, cv = ch.astype(np.int64), cv.astype(np.int64)
        assert ch.min() >= -(1 << 15) and ch.max() < 1 << 15
        assert (255 * np.abs(ch).sum(1)).max() < 1 << 24
        lo = (255 * np.where(ch < 0, ch, 0).sum(1)).min() >> 7
        assert -(1 << 15) <= lo and min((255 * ch.sum(1)).max() >> 7, 32767) < 1 << 15
        assert (32767 * np.abs(cv).sum(1)).max() + (64 << 12) < 1 << 31


def test_exact_downscale_equals_the_jax_golden_path():
    """At a small 12x downscale the port's plain version (the card kernel's
    reference) and the JAX package's golden swscale path
    (processing_chain_tpu/ops/resize.py _swscale_exact) give equal frames
    from the same seeded input, bicubic and lanczos. Tolerance: exact."""
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (2, 192, 384)).astype(np.uint8)
    for kernel in ("bicubic", "lanczos"):
        want = np.asarray(jr._swscale_exact(x, 16, 32, kernel))
        got = ck.resize_frames_plain(torch.from_numpy(x), 16, 32, kernel).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile_w", [256, 128, 64, 32])
@pytest.mark.parametrize("kh", [1, 4, 6, 8, 11, 12, 17, 24, 34, 48, 70, 92])
def test_stream_taps_pad_to_whole_loop_steps(tile_w, kh):
    """resize_stream's tap loop takes gu 4-tap groups a step at tile_w /
    32 columns a lane, at least 4 column sums a step; the plan pads kh
    with zero-weight taps to whole steps, and the packed coefficients
    unpack to the plan's taps followed by zeros."""
    gu = ck._stream_group_unroll(tile_w)
    assert gu * (tile_w // 32) >= 4 and gu in (1, 2, 4)
    kp = ck._round_up(kh, 4 * gu)
    rng = np.random.default_rng(kh)
    co = rng.integers(-3000, 20000, (tile_w + 3, kh))
    for exact in (True, False):
        p = {"co_h": ck._stream_hco(co if exact else co.astype(np.float32), 2, tile_w, kp, exact)}
        got = _unpack_stream_hco(p, exact).reshape(2 * tile_w, kp)
        np.testing.assert_array_equal(got[:tile_w + 3, :kh], co)
        assert not got[:, kh:].any() and not got[tile_w + 3:].any()


def test_window_starts_recover_clipped_windows():
    for src, dst, kernel in ((20, 300, "lanczos"), (300, 21, "bicubic"),
                             (3, 40, "lanczos"), (2, 9, "bicubic"), (1, 5, "bilinear")):
        idx, _ = tr.make_plan(src, dst, kernel)
        starts = ck._window_starts(idx, src)
        np.testing.assert_array_equal(
            np.clip(starts[:, None] + np.arange(idx.shape[1]), 0, src - 1), idx)
    with pytest.raises(ValueError, match="window"):
        ck._window_starts(np.array([[0, 2, 1]], np.int32), 5)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 2160, 3840), torch.uint8), ((2, 3, 3, 3), torch.uint8),
    ((1, 5, 130, 257), torch.uint16), ((3, 2, 65, 4097), torch.uint8),
    ((1, 2, 64, 2049), torch.uint16),
])
def test_siti_partial_buffers_match_the_grid(shape, dtype):
    """The partials siti_partials writes hold one entry per block of its
    grid: ceil(H / 64) row strips x ceil(W / (256 threads x 16 bytes /
    sample size)) column blocks, for each of the B*T frames; the fused
    pass writes three int64 sums a block, the SI pass one."""
    b, t, h, w = shape
    size = torch.zeros((), dtype=dtype).element_size()
    cols = 256 * 16 // size
    grid = (-(-h // 64), -(-w // cols))
    assert ck._siti_grid(h, w, size) == grid
    for ti, n_int in ((True, 3), (False, 1)):
        ps1, pint = ck._siti_partial_buffers(b * t, h, w, size, "cpu", ti=ti)
        assert ps1.shape == (b * t, grid[0] * grid[1]) and ps1.dtype == torch.float64
        assert pint.shape == (n_int, b * t, grid[0] * grid[1]) and pint.dtype == torch.int64


def _strip_walk_counts(h: int, w: int, size: int) -> np.ndarray:
    """How often csrc/siti.cu's strip walk takes the SI term of each source
    pixel, replayed in numpy over its grid: block (x, y), thread k owns
    columns cb = C (256 x + k) .. cb + C - 1 (C = 16 / size) of rows
    64 y .. min(64 y + 64, H) - 1; a warp whose first column lies at or past
    W walks nothing, and the others take row r when 1 <= r <= H - 2 and
    column cb + j when bit j of colmask is set (1 <= cb + j <= W - 2)."""
    n_ty, n_tx = ck._siti_grid(h, w, size)
    c = 16 // size
    k = np.arange(256)
    lane, j = k % 32, np.arange(c)
    idx = []
    for by in range(n_ty):
        rows = np.arange(by * 64, min(by * 64 + 64, h))
        rows = rows[(rows >= 1) & (rows <= h - 2)]
        for bx in range(n_tx):
            cb = (bx * 256 + k) * c
            live = (cb - lane * c) < w
            cols = (cb[live][:, None] + j).ravel()
            colmask = (cols >= 1) & (cols <= w - 2)
            idx.append((rows[:, None] * w + cols[colmask][None, :]).ravel())
    return np.bincount(np.concatenate(idx), minlength=h * w).reshape(h, w)


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("w", [3, 17, 3840, 4097])
@pytest.mark.parametrize("h", [3, 64, 65, 2160])
def test_strip_walk_takes_every_interior_pixel_once(h, w, size):
    """Over (strip, thread, column, colmask) the walk takes each Sobel
    interior pixel (1 <= r <= H-2, 1 <= c <= W-2) exactly once and no
    other pixel, so the SI pass's Σ|∇| and Σ(gx²+gy²) cover the
    (H-2)(W-2) terms that si_frames_plain sums."""
    counts = _strip_walk_counts(h, w, size)
    want = np.zeros((h, w), np.int64)
    want[1:-1, 1:-1] = 1
    np.testing.assert_array_equal(counts, want)


@pytest.mark.parametrize("sms", [16, 132])
@pytest.mark.parametrize("t", [1, 2, 3, 9, 64, 1000])
def test_resize_grid_walks_every_frame(t, sms):
    """Z frame groups: block z walks frames z, z + Z, ... so each frame
    has exactly one group; every block walks at least two frames when
    T allows, and the grid stays within a few waves of the card's SMs."""
    for n_ct, n_rt in ((15, 34), (8, 17), (1, 1), (2, 3), (10, 6)):
        z = ck._resize_grid_z(t, n_ct, n_rt, sms)
        target = sms * ck._RESIZE_BLOCKS_PER_SM
        assert 1 <= z <= max(1, -(-t // 2))
        assert n_ct * n_rt * z <= max(target, n_ct * n_rt)
        walked = sorted(f for g in range(z) for f in range(g, t, z))
        assert walked == list(range(t))
