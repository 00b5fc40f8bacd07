"""Kernel against plain version on the card, at small and ragged shapes.

Every test here is marked `gpu` and skips on a host without CUDA (the
card's presence is decided inside the `cuda` fixture, never at import).
Run them on a machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q -p no:xdist
"""

import numpy as np
import pytest
import torch

from processing_chain_tpu_torch.models import avpvs
from processing_chain_tpu_torch.models import segments as tseg
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.ops import metrics as tm
from processing_chain_tpu_torch.ops import resize, siti
from processing_chain_tpu_torch.parallel.pipeline import iter_device_ahead
from processing_chain_tpu_torch.tools import quality_metrics as tqm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck.reset_launches()
    return torch.device("cuda", 0)


def _rand(shape, hi, dtype, device, seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, hi + 1, shape).astype(
        np.uint8 if dtype == torch.uint8 else np.uint16)
    return torch.from_numpy(arr).to(device)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos", "bilinear"])
@pytest.mark.parametrize("geom", [
    (45, 80, 90, 160), (101, 77, 33, 250), (37, 61, 37, 130), (300, 20, 21, 300),
    (64, 64, 1000, 17),
])
@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_resize_kernel_equals_plain(cuda, kernel, geom, dtype, hi):
    sh, sw, dh, dw = geom
    x = _rand((3, sh, sw), hi, dtype, cuda, sum(geom))
    out = ck.resize_frames_fused(x, dh, dw, kernel)
    assert out.dtype == dtype and tuple(out.shape) == (3, dh, dw)
    assert ck.LAUNCHES["resize_frames_fused"] == 1
    ref = ck.resize_frames_plain(x.cpu(), dh, dw, kernel)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
@pytest.mark.parametrize("geom", [
    (8, 1280, 24, 3840), (8, 640, 48, 3840), (8, 1920, 16, 3840), (5, 67, 11, 203),
    (9, 100, 20, 251),
])
@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_resize_kernel_chain_upscales_and_ragged_widths(cuda, kernel, geom, dtype, hi):
    """The chain's upscales onto 3840 columns at a few rows, and widths
    that are not a multiple of 8 output columns or 16 bytes; 9 frames,
    more than the persistent grid's frame groups, so blocks walk frames."""
    sh, sw, dh, dw = geom
    x = _rand((9, sh, sw), hi, dtype, cuda, sum(geom) + hi)
    plan = ck._resize_plan(sh, sw, dh, dw, kernel, dtype == torch.uint8, x.element_size())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ck._resize_grid_z(9, plan["n_ct"], plan["n_rt"], sms) < 9
    out = ck.resize_frames_fused(x, dh, dw, kernel)
    assert torch.equal(out.cpu(), ck.resize_frames_plain(x.cpu(), dh, dw, kernel))
    assert ck.LAUNCHES["resize_frames_fused"] == 1


@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_resize_kernel_unaligned_source_rows(cuda, dtype, hi):
    """A source whose base is not 16-byte aligned (a view at an odd offset,
    contiguous) takes the scalar staging branch of the same kernel: an
    upscale (resize_ring) and 2x and 12x downscales with a ragged output
    width (resize_stream)."""
    for (t, sh, sw), (dh, dw) in (((5, 48, 80), (96, 160)), ((5, 96, 400), (48, 198)),
                                  ((3, 192, 770), (16, 63))):
        flat = _rand((1, t * sh * sw + 1), hi, dtype, cuda, 17 + sw)
        x = flat[0, 1:].reshape(t, sh, sw)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        for kernel in ("bicubic", "lanczos", "bilinear"):
            out = ck.resize_frames_fused(x, dh, dw, kernel)
            assert torch.equal(out.cpu(), ck.resize_frames_plain(x.cpu(), dh, dw, kernel))
    assert ck.LAUNCHES["resize_frames_fused"] == 9


@pytest.mark.parametrize("dtype,hi,atol", [(torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)])
@pytest.mark.parametrize("shape", [(3, 40, 200), (2, 37, 61), (1, 3, 3), (5, 130, 257)])
def test_siti_kernels_equal_plain(cuda, dtype, hi, atol, shape):
    y = _rand(shape, hi, dtype, cuda, shape[2])
    prev = _rand(shape[1:], hi, dtype, cuda, shape[1])
    pairs = [
        (ck.si_frames_fused(y), ck.si_frames_plain(y.cpu())),
        (ck.ti_frames_fused(y), ck.ti_frames_plain(y.cpu())),
        (ck.ti_frames_fused(y, prev), ck.ti_frames_plain(y.cpu(), prev.cpu())),
    ]
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=atol)
    assert ck.LAUNCHES["si_frames_fused"] == 1
    assert ck.LAUNCHES["ti_frames_fused"] == (2 if shape[0] > 1 else 1)


@pytest.mark.parametrize("dtype,hi,atol", [(torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)])
def test_si_unaligned_frames_take_scalar_path(cuda, dtype, hi, atol):
    """Frames whose base is not 16-byte aligned (a view at an odd offset,
    contiguous) and rows that are a multiple of 16 bytes: the SI pass takes
    its predicated scalar loads (vec = 0)."""
    flat = _rand((1, 3 * 70 * 256 + 1), hi, dtype, cuda, 23)
    y = flat[0, 1:].reshape(3, 70, 256)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    torch.testing.assert_close(ck.si_frames_fused(y).cpu(), ck.si_frames_plain(y.cpu()),
                               rtol=1e-4, atol=atol)
    assert ck.LAUNCHES["si_frames_fused"] == 1


def test_ti_unaligned_predecessor_takes_scalar_path(cuda):
    y = _rand((3, 9, 17), 255, torch.uint8, cuda, 1)
    prev = _rand((1, 9 * 17 + 1), 255, torch.uint8, cuda, 2)[0, 1:].reshape(9, 17)
    torch.testing.assert_close(
        ck.ti_frames_fused(y, prev).cpu(), ck.ti_frames_plain(y.cpu(), prev.cpu()),
        rtol=1e-4, atol=1e-3)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((2, 20, 30), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ck.resize_frames_fused(x, 40, 60)
    with pytest.raises(TypeError):
        ck.si_frames_fused(x)
    # a float CUDA tensor takes the banded matrix products on the card
    # (no kernel of this module, no CPU detour)
    up = resize.resize_plane(x, 40, 60)
    assert up.is_cuda and up.dtype == torch.float32 and tuple(up.shape) == (2, 40, 60)
    with pytest.raises(ValueError):
        ck.ti_frames_fused(x.to(torch.uint8)[:, :, ::2])
    assert ck.LAUNCHES == {name: 0 for name in ck.LAUNCHES}


def test_iter_device_ahead_cuda_roundtrip(cuda):
    rng = np.random.default_rng(3)
    chunks = [[rng.integers(0, 256, (n, 6, 10)).astype(np.uint8) for _ in range(3)]
              for n in (4, 4, 4, 4, 2)]
    seen = []
    for host, dev in iter_device_ahead(iter(chunks), cuda):
        seen.append(host)
        for d, p in zip(dev, host):
            assert d.device.type == "cuda"
            np.testing.assert_array_equal(d.cpu().numpy(), p)
    assert [a is b for a, b in zip(seen, chunks)] == [True] * len(chunks)


class _Collect:
    def __init__(self):
        self.planes = []

    def put(self, planes, recycle=None):
        self.planes.append([p.cpu() for p in planes])


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_pump_ready_cuda_equals_cpu(cuda, pix_fmt):
    ten_bit = "10" in pix_fmt
    hi, dtype = (1023, np.uint16) if ten_bit else (255, np.uint8)
    rng = np.random.default_rng(5)
    chunks = [[rng.integers(0, hi + 1, s).astype(dtype)
               for s in ((8, 48, 80), (8, 24, 40), (8, 24, 40))] for _ in range(3)]
    out = {}
    for device in (cuda, "cpu"):
        w, feat = _Collect(), avpvs.SiTiAccumulator()
        avpvs.pump_ready(iter(chunks), w, feat, 96, 160, pix_fmt, device=device)
        out[str(device)] = (w.planes, torch.cat([s.cpu() for s in feat.si]),
                            torch.cat([t.cpu() for t in feat.ti]))
    assert ck.LAUNCHES == {"resize_frames_fused": 9, "si_frames_fused": 3,
                           "ti_frames_fused": 3, "siti_frames_fused": 0,
                           "siti_frames_fused_batch": 0}
    (gp, gsi, gti), (cp, csi, cti) = out[str(cuda)], out["cpu"]
    for a, b in zip(gp, cp):
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb)
    atol = 1e-2 if ten_bit else 1e-3
    torch.testing.assert_close(gsi, csi, rtol=1e-4, atol=atol)
    torch.testing.assert_close(gti, cti, rtol=1e-4, atol=atol)
    assert siti.ti_frames(torch.from_numpy(chunks[0][0]).to(cuda)).shape == (8,)


@pytest.mark.parametrize("dtype,hi,atol", [(torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 37, 61), (1, 3, 3), (5, 130, 257), (3, 48, 208)])
def test_fused_siti_kernels_equal_plain(cuda, dtype, hi, atol, shape):
    """Both fused entry points, ragged and 16-byte-aligned rows; the batch
    kernel with B = 1 and 3, a random predecessor and the self-halo."""
    y = _rand(shape, hi, dtype, cuda, shape[2] + 1)
    si, ti = ck.siti_frames_fused(y)
    psi, pti = ck.siti_frames_plain(y.cpu())
    torch.testing.assert_close(si.cpu(), psi, rtol=1e-4, atol=atol)
    torch.testing.assert_close(ti.cpu(), pti, rtol=1e-4, atol=atol)
    assert float(ti[0]) == 0.0
    # the fused kernel agrees with the separate kernels of the same frames
    torch.testing.assert_close(si, ck.si_frames_fused(y), rtol=1e-4, atol=atol)
    torch.testing.assert_close(ti, ck.ti_frames_fused(y), rtol=1e-4, atol=atol)
    for b in (1, 3):
        yb = _rand((b,) + shape, hi, dtype, cuda, b + shape[1])
        prev = _rand((b,) + shape[1:], hi, dtype, cuda, b + shape[2])
        for p in (prev, yb[:, 0].contiguous()):
            sib, tib = ck.siti_frames_fused_batch(yb, p)
            psib, ptib = ck.siti_frames_batch_plain(yb.cpu(), p.cpu())
            torch.testing.assert_close(sib.cpu(), psib, rtol=1e-4, atol=atol)
            torch.testing.assert_close(tib.cpu(), ptib, rtol=1e-4, atol=atol)
        assert tib[:, 0].tolist() == [0.0] * b  # self-halo
    assert ck.LAUNCHES["siti_frames_fused"] == 1
    assert ck.LAUNCHES["siti_frames_fused_batch"] == 4


@pytest.mark.parametrize("dtype,hi,atol", [(torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)])
@pytest.mark.parametrize("w", [3, 17, 33, 129, 257, 4100])
def test_fused_siti_narrow_widths_and_short_strips(cuda, dtype, hi, atol, w):
    """Widths that end inside a thread's 16 bytes, a warp's span or a
    block's, at heights shorter than one 64-row strip and just over it;
    the predecessor frame at an unaligned address (a view at an odd
    offset) takes the scalar loads of the same kernel. The SI pass, the
    same walk without TI, on the aligned frames and on the unaligned
    ones."""
    for h in (3, 5, 40, 67):
        y = _rand((2, 3, h, w), hi, dtype, cuda, h * w)
        flat = _rand((1, 2 * h * w + 1), hi, dtype, cuda, h + w)
        prev = flat[0, 1:].reshape(2, h, w)
        assert prev.is_contiguous() and prev.data_ptr() % 16 != 0
        si, ti = ck.siti_frames_fused_batch(y, prev)
        psi, pti = ck.siti_frames_batch_plain(y.cpu(), prev.cpu())
        torch.testing.assert_close(si.cpu(), psi, rtol=1e-4, atol=atol)
        torch.testing.assert_close(ti.cpu(), pti, rtol=1e-4, atol=atol)
        si1, ti1 = ck.siti_frames_fused(y[0])
        psi1, pti1 = ck.siti_frames_plain(y[0].cpu())
        torch.testing.assert_close(si1.cpu(), psi1, rtol=1e-4, atol=atol)
        torch.testing.assert_close(ti1.cpu(), pti1, rtol=1e-4, atol=atol)
        for frames in (y[0], prev):
            torch.testing.assert_close(ck.si_frames_fused(frames).cpu(),
                                       ck.si_frames_plain(frames.cpu()), rtol=1e-4, atol=atol)
    assert ck.LAUNCHES["siti_frames_fused_batch"] == ck.LAUNCHES["siti_frames_fused"] == 4
    assert ck.LAUNCHES["si_frames_fused"] == 8


def test_fused_siti_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((2, 3, 20, 30), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ck.siti_frames_fused(x[0])
    with pytest.raises(TypeError):
        ck.siti_frames_fused_batch(x, x[:, 0].contiguous())
    with pytest.raises(ValueError):
        ck.siti_frames_fused_batch(x.to(torch.uint8), x[:, 0].to(torch.uint8).cpu())
    assert ck.LAUNCHES == {name: 0 for name in ck.LAUNCHES}


@pytest.mark.parametrize("ten_bit", [False, True])
def test_run_bucket_cuda_equals_cpu_mesh(cuda, ten_bit):
    from processing_chain_tpu_torch.parallel import mesh, p03_batch

    hi, dtype = (1023, np.uint16) if ten_bit else (255, np.uint8)
    rng = np.random.default_rng(9)
    lengths = [11, 4, 2, 7, 5]
    srcs = [[rng.integers(0, hi + 1, s).astype(dtype)
             for s in ((n, 36, 64), (n, 18, 32), (n, 18, 32))] for n in lengths]
    out = {}
    for devices in ([cuda] * 4, ["cpu"] * 4):
        planes = {i: [] for i in range(len(lengths))}
        feats = {i: [] for i in range(len(lengths))}
        lanes = [p03_batch.Lane(
            chunks=iter([[p[:3] for p in yuv], [p[3:] for p in yuv]]),
            emit=planes[i].append, n_frames_hint=yuv[0].shape[0],
            emit_features=lambda s, t, i=i: feats[i].append((s, t)))
            for i, yuv in enumerate(srcs)]
        p03_batch.run_bucket(lanes, mesh.make_mesh(devices), 72, 128, "bicubic",
                             (2, 2), ten_bit, chunk=4)
        out[str(devices[0])] = (planes, feats)
    # t_step 4: 3 blocks in wave 0 (the 11-frame lane), 1 in wave 1
    assert ck.LAUNCHES == {"resize_frames_fused": 12, "si_frames_fused": 0,
                           "ti_frames_fused": 0, "siti_frames_fused": 0,
                           "siti_frames_fused_batch": 4}
    (gp, gf), (cp, cf) = out[str(cuda)], out["cpu"]
    atol = 1e-2 if ten_bit else 1e-3
    for i in range(len(lengths)):
        for p in range(3):
            np.testing.assert_array_equal(np.concatenate([b[p] for b in gp[i]]),
                                          np.concatenate([b[p] for b in cp[i]]))
        for k in range(2):
            np.testing.assert_allclose(np.concatenate([f[k] for f in gf[i]]),
                                       np.concatenate([f[k] for f in cf[i]]),
                                       rtol=1e-4, atol=atol)


def test_avpvs_siti_step_cuda_equals_cpu(cuda):
    from processing_chain_tpu_torch.parallel.pipeline import avpvs_siti_step

    planes = [_rand(s, 255, torch.uint8, "cpu", k)
              for k, s in enumerate(((6, 36, 64), (6, 18, 32), (6, 18, 32)))]
    prev = _rand((72, 128), 255, torch.uint8, "cpu", 7)
    for p in (None, prev):
        ours = avpvs_siti_step(*[x.to(cuda) for x in planes], 72, 128,
                               prev_last=None if p is None else p.to(cuda))
        ref = avpvs_siti_step(*planes, 72, 128, prev_last=p)
        for a, b in zip(ours[:3], ref[:3]):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(ours[3:], ref[3:]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-3)
    assert ck.LAUNCHES["resize_frames_fused"] == 6
    assert ck.LAUNCHES["siti_frames_fused"] == ck.LAUNCHES["siti_frames_fused_batch"] == 1


@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_one_gradient_frames_give_si_zero(cuda, dtype, hi):
    """A 3x3 frame has one Sobel gradient, so SI is exactly 0: the Σ|∇|
    partial must carry the square root to about double precision, or the
    rounding shows as σ ~ 0.03."""
    y = _rand((64, 3, 3), hi, dtype, cuda, 99)
    zero = torch.zeros(64, dtype=torch.float32)
    for si in (ck.si_frames_fused(y), ck.siti_frames_fused(y)[0],
               ck.siti_frames_fused_batch(y[:, None], y.clone())[0][:, 0]):
        torch.testing.assert_close(si.cpu(), zero, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_constant_gradient_frames_give_si_zero(cuda, dtype):
    """A flat frame (every gradient 0) and ramps of slope (1, 1), (1, -1)
    and (2, 0), whose gradients have one magnitude everywhere (8√2 for the
    first two), have SI exactly 0: Σ|∇| must hold the roots to about double
    precision over thousands of equal terms (a plain f32 sum leaves
    σ ≈ 0.005), and a zero gradient must add nothing measurable."""
    r = torch.arange(120)[:, None]
    c = torch.arange(130)[None, :]
    frames = torch.stack([torch.full((120, 130), 77), r + c, r - c + 129,
                          (2 * r).expand(120, 130)]).to(dtype).to(cuda)
    zero = torch.zeros(4, dtype=torch.float32)
    for si in (ck.si_frames_fused(frames), ck.siti_frames_fused(frames)[0],
               ck.siti_frames_fused_batch(frames[:, None], frames.clone())[0][:, 0]):
        torch.testing.assert_close(si.cpu(), zero, rtol=0, atol=1e-3)
    torch.testing.assert_close(ck.si_frames_plain(frames.cpu()), zero, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the downstream render: stall composite, CPVS transforms, fused fan-out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom,kernel,ring", [
    ((2160, 3840, 1080, 1920), "bicubic", False),   # the mobile CPVS downscale, Y
    ((1080, 1920, 540, 960), "bicubic", False),     # ... U and V
    ((45, 80, 90, 80), "bilinear", True),           # 420->422: identity width axis
    ((1080, 1920, 2160, 1920), "bilinear", True),
    # p01's quality ladder from 2160p and 1080p sources, luma and chroma
    ((2160, 3840, 720, 1280), "bicubic", False), ((2160, 3840, 720, 1280), "lanczos", False),
    ((2160, 3840, 360, 640), "bicubic", False), ((2160, 3840, 360, 640), "lanczos", False),
    ((2160, 3840, 180, 320), "bicubic", False), ((2160, 3840, 180, 320), "lanczos", False),
    ((1080, 1920, 90, 160), "bicubic", False), ((1080, 1920, 90, 160), "lanczos", False),
    ((1080, 1920, 360, 640), "bicubic", False), ((1080, 1920, 180, 320), "lanczos", False),
    ((1080, 1920, 720, 1280), "bicubic", True),     # 1.5x bicubic: 6 taps a pass
    ((1080, 1920, 720, 1280), "lanczos", False),
    ((2160, 3840, 1440, 2560), "lanczos", False),   # a 1440p context
])
@pytest.mark.parametrize("dtype,hi", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_resize_kernel_downstream_geometries_equal_plain(cuda, geom, kernel, ring, dtype, hi):
    """The downstream render's resizes and every downscale of the chain
    (resize_stream; resize_ring where both passes have 2, 4 or 6 taps),
    each one launch, equal to the plain version."""
    sh, sw, dh, dw = geom
    x = _rand((2, sh, sw), hi, dtype, cuda, sh + dw)
    exact = ck._exact_route(dtype, sh, sw, dh, dw, kernel)
    assert ck._resize_plan(sh, sw, dh, dw, kernel, exact, x.element_size())["ring"] == ring
    out = ck.resize_frames_fused(x, dh, dw, kernel)
    assert torch.equal(out.cpu(), ck.resize_frames_plain(x.cpu(), dh, dw, kernel))
    assert ck.LAUNCHES["resize_frames_fused"] == 1


def _yuv(shape_hw, pix_fmt, t, device, seed):
    h, w = shape_hw
    hi, dtype = (1023, torch.uint16) if "10" in pix_fmt else (255, torch.uint8)
    sub_h = 2 if "420" in pix_fmt else 1
    return [_rand(s, hi, dtype, device, seed + k)
            for k, s in enumerate(((t, h, w), (t, h // sub_h, w // 2), (t, h // sub_h, w // 2)))]


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le", "yuv422p"])
@pytest.mark.parametrize("skipping", [False, True])
def test_stall_compositor_cuda_equals_cpu(cuda, pix_fmt, skipping):
    from processing_chain_tpu_torch.ops import overlay as ov

    planes = _yuv((90, 160), pix_fmt, 12, cuda, 40)
    plan = ov.plan_stalling(12, 10.0, [[0.1, 0.3]] if skipping else [[0.4, 0.5]],
                            skipping=skipping)
    idx = torch.from_numpy(plan.src_idx.astype(np.int64)).to(cuda)
    gathered = [torch.index_select(p, 0, idx) for p in planes]
    rgba = np.random.default_rng(7).integers(0, 256, (128, 128, 4)).astype(np.uint8)
    masks = (plan.stall_mask, plan.black_mask, plan.phase)
    got = avpvs.make_stall_compositor(pix_fmt, rgba, skipping, 64, device=cuda)(gathered, *masks)
    want = avpvs.make_stall_compositor(pix_fmt, rgba, skipping, 64, device="cpu")(
        [g.cpu() for g in gathered], *masks)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert ck.LAUNCHES == {name: 0 for name in ck.LAUNCHES}


_PC = {"type": "pc", "displayWidth": 160, "displayHeight": 90, "codingWidth": 160,
       "codingHeight": 90, "displayFrameRate": 30}
_PC_PAD = {**_PC, "displayWidth": 192, "displayHeight": 108, "codingWidth": 192,
           "codingHeight": 108}
_MOBILE = {"type": "mobile", "displayWidth": 80, "displayHeight": 46, "codingWidth": 80,
           "codingHeight": 46}
_MOBILE_PAD = {"type": "tablet", "displayWidth": 160, "displayHeight": 120,
               "codingWidth": 160, "codingHeight": 100}


def _plan(pp, pad):
    base = {"fps": None, "normalize": False, "t": None, "scale": None, "audio": None}
    if pp["type"] == "pc":
        return {**base, "context": "pc", "fps": 30.0,
                "pad": (pp["displayWidth"], pp["displayHeight"]) if pad else None}
    return {**base, "context": "mobile",
            "pad": (pp["displayWidth"], pp["displayHeight"]) if pad else None}


@pytest.mark.parametrize("pp,pad,rawvideo", [
    (_PC, False, False), (_PC, False, True), (_PC_PAD, True, False),
    (_MOBILE, False, False), (_MOBILE_PAD, True, False),
])
@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_cpvs_transforms_cuda_equal_cpu(cuda, pp, pad, rawvideo, pix_fmt):
    from processing_chain_tpu_torch.config.domain import PostProcessing
    from processing_chain_tpu_torch.models import cpvs

    planes = _yuv((90, 160), pix_fmt, 5, cuda, 60)
    for tf in (cpvs.make_cpvs_transform(_plan(pp, pad), PostProcessing(pp), pix_fmt, rawvideo),
               cpvs.make_preview_transform(pix_fmt)):
        got = tf(planes)
        want = tf([p.cpu() for p in planes])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_fused_fanout_cuda_equals_cpu(cuda):
    """pump_ready's quantized chunks through the fused fan-out on the card
    (composited chunks never leave it) against the same on the CPU, and
    the staged route on the card against the fused one."""
    from processing_chain_tpu_torch.config.domain import PostProcessing
    from processing_chain_tpu_torch.engine import prefetch as pfe
    from processing_chain_tpu_torch.models import fused
    from processing_chain_tpu_torch.ops import overlay as ov

    class Keep:
        def __init__(self):
            self.chunks, self.closed = [], 0

        def put(self, planes, recycle=None):
            self.chunks.append([p.cpu() for p in planes])

        def close(self):
            self.closed += 1

    rng = np.random.default_rng(8)
    src = [[rng.integers(0, 256, s).astype(np.uint8) for s in ((8, 45, 80), (8, 22, 40), (8, 22, 40))]
           for _ in range(3)]
    rgba = rng.integers(0, 256, (128, 128, 4)).astype(np.uint8)
    events = [[0.1, 0.1], [0.3, 0.05]]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        comp = avpvs.make_stall_compositor("yuv420p", rgba, False, 64, device=dev)
        stall_w, pc_w, mob_w = Keep(), Keep(), Keep()
        pipes = [fused._ContextPipeline(pc_w, _plan(_PC, False), PostProcessing(_PC),
                                        "yuv420p", 60.0, False, 8),
                 fused._ContextPipeline(mob_w, _plan(_MOBILE, False), PostProcessing(_MOBILE),
                                        "yuv420p", 60.0, False, 8)]
        fan = fused.FusedFanout(pipes, compositor=comp, stall_writer=stall_w, fps=60.0,
                                events=events, chunk=8)
        kept = []

        class Tee:
            def put(self, planes, recycle=None):
                kept.append(planes)
                fan.feed(planes)

        avpvs.pump_ready(iter(src), Tee(), avpvs.SiTiAccumulator(), 90, 160, "yuv420p",
                         device=dev)
        fan.finish_streams()
        staged = Keep()
        plan = ov.plan_stalling(24, 60.0, events)
        avpvs.pump_stalled(pfe.iter_chunk_frames(kept), plan, comp, staged, 8)
        runs[dev.type] = (stall_w, pc_w, mob_w, staged)
    for a_w, b_w in zip(runs["cuda"], runs["cpu"]):
        assert len(a_w.chunks) == len(b_w.chunks) > 0
        for a, b in zip(a_w.chunks, b_w.chunks):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    stalled, staged = runs["cuda"][0], runs["cuda"][3]
    assert all(torch.equal(x, y) for a, b in zip(stalled.chunks, staged.chunks) for x, y in zip(a, b))
    assert sum(c[0].shape[0] for c in stalled.chunks) == 24 + 9


# ---------------------------------------------------------------------------
# The quality path: banded resize, metrics, p01's ladder, the quality tool
# ---------------------------------------------------------------------------


def _smooth_pair(t, h, w, sigma, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(16, 235, size=(t, h, w)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3.0
    deg = base + rng.normal(0, sigma, base.shape).astype(np.float32)
    return torch.from_numpy(base), torch.from_numpy(deg)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
@pytest.mark.parametrize("geom", [(270, 480, 1080, 1920), (270, 480, 90, 160),
                                  (135, 240, 1080, 1920), (101, 77, 250, 33)])
def test_banded_on_a_cuda_float_tensor_equals_the_cpu_route(cuda, kernel, geom):
    """f32 products of 14-bit weights on values up to 255: within 1e-3 of
    the CPU's banded route; TF32 (10-bit mantissas) would miss by ~0.1,
    so the check also holds with the global TF32 flag set."""
    sh, sw, dh, dw = geom
    x = _smooth_pair(3, sh, sw, 0.0, sh + dw)[0]
    want = resize.resize_plane(x, dh, dw, kernel, method="banded")
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            got = resize.resize_plane(x.to(cuda), dh, dw, kernel)
            assert got.is_cuda and torch.backends.cuda.matmul.allow_tf32 is flag
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert ck.LAUNCHES == {name: 0 for name in ck.LAUNCHES}


@pytest.mark.parametrize("sigma", [0.0, 6.0])
def test_metrics_on_the_card_equal_the_cpu(cuda, sigma):
    ref, deg = _smooth_pair(3, 180, 200, sigma, 5)
    r, d = ref.to(cuda), deg.to(cuda)
    torch.testing.assert_close(tm.psnr_frames(r, d).cpu(), tm.psnr_frames(ref, deg),
                               rtol=0, atol=1e-4)
    for fn in (tm.ssim_frames, tm.msssim_frames, tm.vif_frames):
        got = fn(r, d)
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), fn(ref, deg), rtol=0, atol=2e-5)
    if sigma == 0.0:
        assert (tm.psnr_frames(r, d) == 100.0).all()


@pytest.mark.parametrize("src,width,fps", [((384, 768), 64, 15.0), ((96, 192), 128, 30.0)])
def test_ladder_chunk_on_the_card_equals_the_cpu(cuda, src, width, fps):
    """p01's device half at 12x (resize_stream) and at 1.5x bicubic
    (resize_ring, 6 taps a pass): identical to the CPU's plain path."""
    h, w = src
    rng = np.random.default_rng(h)
    planes = [rng.integers(0, 256, (20,) + s).astype(np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    chunks = [[p[i:i + 8] for p in planes] for i in range(0, 20, 8)]
    th, tw, target_fps, _ = tseg.plan_segment_frames(h, w, 60.0, width, fps)
    runs = {}
    for dev in (cuda, "cpu"):
        ck.reset_launches()
        runs[str(dev)] = list(tseg.scaled_chunks(iter(chunks), 60.0, target_fps, th, tw,
                                                 "yuv420p", device=dev))
        if dev is cuda:
            assert ck.LAUNCHES["resize_frames_fused"] == 3 * len(runs[str(dev)])
    got, want = runs[str(cuda)], runs["cpu"]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for p, q in zip(a, b):
            assert p.dtype == np.uint8
            np.testing.assert_array_equal(p, q)


def test_score_chunks_on_the_card_equals_the_cpu_route(cuda):
    """One 8-frame chunk, MS-SSIM and VIF on, the SRC at half the AVPVS
    grid: the card (banded resize) against the CPU with banded forced."""
    rng = np.random.default_rng(8)
    deg = [torch.from_numpy(rng.integers(0, 256, (8,) + s).astype(np.uint8))
           for s in ((180, 192), (90, 96), (90, 96))]
    ref = [p[:, ::2, ::2].contiguous() for p in deg]
    tables = {}
    for dev, method in ((cuda, "auto"), ("cpu", "banded")):
        ck.reset_launches()
        tables[str(dev)] = tqm.score_chunks(iter([(deg, ref)]), msssim=True, vif=True,
                                            device=dev, resize_method=method)
        if dev is cuda:
            assert ck.LAUNCHES["si_frames_fused"] == ck.LAUNCHES["ti_frames_fused"] == 1
            assert ck.LAUNCHES["resize_frames_fused"] == 0
    got, want = tables[str(cuda)], tables["cpu"]
    assert list(got) == list(want)
    atol = {"psnr_y": 1e-3, "psnr_u": 1e-3, "psnr_v": 1e-3, "si": 1e-3, "ti": 1e-3}
    for k in list(got)[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol.get(k, 1e-4), err_msg=k)


# the serve path's wave executor: an upscale (resize_ring) and a downscale
# (resize_stream), lanes of unequal length in one batch
SERVE_GEOMETRIES = [
    {"src_h": 36, "src_w": 64, "dst_h": 72, "dst_w": 128},
    {"src_h": 72, "src_w": 128, "dst_h": 36, "dst_w": 64},
    {"src_h": 270, "src_w": 480, "dst_h": 540, "dst_w": 960},
]


@pytest.mark.parametrize("geo", SERVE_GEOMETRIES,
                         ids=lambda g: f"{g['src_h']}x{g['src_w']}-{g['dst_h']}x{g['dst_w']}")
def test_wave_executor_on_the_card_writes_the_cpu_bytes(cuda, tmp_path, geo):
    from processing_chain_tpu_torch.serve import api
    from processing_chain_tpu_torch.serve.executors import DeviceWaveExecutor

    units = [api.Unit("P2STR01", "SRC001", "HRC001", {**geo, "frames": 12}),
             api.Unit("P2STR01", "SRC002", "HRC001", {**geo, "frames": 21})]
    out = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        d = tmp_path / name
        d.mkdir()
        paths = [str(d / f"{u.pvs_id}.bin") for u in units]
        DeviceWaveExecutor(device=dev).run_batch(units, paths)
        out[name] = [open(p, "rb").read() for p in paths]
    blocks = sum(-(-u.params["frames"] // 8) for u in units)
    assert ck.LAUNCHES["resize_frames_fused"] == 3 * blocks
    assert ck.LAUNCHES["siti_frames_fused_batch"] == blocks
    assert out["card"] == out["cpu"]


def test_wave_service_on_the_card_serves_the_cpu_bytes(cuda, tmp_path):
    import json
    import urllib.request

    from processing_chain_tpu_torch import telemetry as ptm
    from processing_chain_tpu_torch.serve.api import Unit
    from processing_chain_tpu_torch.serve.executors import DeviceWaveExecutor
    from processing_chain_tpu_torch.serve.service import ChainServeService
    from processing_chain_tpu_torch.store import runtime as store_runtime

    geo = {"frames": 20, **SERVE_GEOMETRIES[2]}
    body = {"tenant": "lab-a", "database": "P2STR01", "srcs": ["SRC001", "SRC002"],
            "hrcs": ["HRC001"], "params": geo}
    svc = ChainServeService(root=str(tmp_path / "serve"), port=0, executor="wave",
                            workers=1, device=cuda).start()
    try:
        req = urllib.request.Request(svc.server.url + "/v1/requests",
                                     data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req) as resp:
            acc = json.load(resp)
        assert svc.wait_request(acc["request"], timeout=120.0) == "done"
        units = svc.request_status(acc["request"])["units"]
        assert ck.LAUNCHES["siti_frames_fused_batch"] == 2 * 3
        cpu = DeviceWaveExecutor(device="cpu")
        for pvs, u in units.items():
            with urllib.request.urlopen(svc.server.url + u["artifact"]) as resp:
                served = resp.read()
            _, src, hrc = pvs.split("_")
            path = str(tmp_path / f"{pvs}.bin")
            cpu.run_batch([Unit("P2STR01", src, hrc, dict(geo))], [path])
            assert served == open(path, "rb").read()
    finally:
        svc.stop()
        store_runtime.configure(None)
        ptm.disable()


def _wave_outputs(mesh, srcs, ten_bit):
    from processing_chain_tpu_torch.parallel import p03_batch

    planes = {i: [] for i in range(len(srcs))}
    feats = {i: [] for i in range(len(srcs))}
    lanes = [p03_batch.Lane(
        chunks=iter([[p[:3] for p in yuv], [p[3:] for p in yuv]]),
        emit=planes[i].append, n_frames_hint=yuv[0].shape[0],
        emit_features=lambda s, t, i=i: feats[i].append((s, t)))
        for i, yuv in enumerate(srcs)]
    p03_batch.run_bucket(lanes, mesh, 72, 128, "bicubic", (2, 2), ten_bit, chunk=4)
    return ([[np.concatenate([b[p] for b in planes[i]]) for p in range(3)] for i in planes],
            [[np.concatenate([f[k] for f in feats[i]]) for k in range(2)] for i in feats])


@pytest.mark.parametrize("ten_bit", [False, True])
def test_run_bucket_2x2_on_the_card_equals_plain(cuda, ten_bit):
    """The (pvs=2, time=2) wave on one card: planes equal to the same mesh on
    the CPU (the plain versions), features within tolerance, the halo at
    every time boundary; 3 resize + 1 fused SI/TI launch a block."""
    from processing_chain_tpu_torch.parallel import mesh

    hi, dtype = (1023, np.uint16) if ten_bit else (255, np.uint8)
    rng = np.random.default_rng(19)
    lengths = [11, 4, 2, 7, 5]
    srcs = [[rng.integers(0, hi + 1, s).astype(dtype)
             for s in ((n, 36, 64), (n, 18, 32), (n, 18, 32))] for n in lengths]
    got = _wave_outputs(mesh.make_mesh([cuda] * 4, time_parallel=2), srcs, ten_bit)
    # t_step 4; waves [11, 7], [5, 4], [2]: 3 + 2 + 1 blocks
    assert ck.LAUNCHES == {"resize_frames_fused": 18, "si_frames_fused": 0,
                           "ti_frames_fused": 0, "siti_frames_fused": 0,
                           "siti_frames_fused_batch": 6}
    want = _wave_outputs(mesh.make_mesh(["cpu"] * 4, time_parallel=2), srcs, ten_bit)
    lanes = _wave_outputs(mesh.make_mesh([cuda] * 4), srcs, ten_bit)
    atol = 1e-2 if ten_bit else 1e-3
    for (gp, gf), (wp, wf), (lp, lf) in zip(zip(*got), zip(*want), zip(*lanes)):
        for a, b, c in zip(gp, wp, lp):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        for a, b, c in zip(gf, wf, lf):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=atol)
        assert gf[1][0] == 0.0


def test_sharded_step_2x2_on_the_card_equals_cpu(cuda):
    from processing_chain_tpu_torch.parallel import mesh
    from processing_chain_tpu_torch.parallel.pipeline import make_sharded_step

    planes = [_rand(s, 255, torch.uint8, "cpu", 30 + k)
              for k, s in enumerate(((2, 8, 36, 64), (2, 8, 18, 32), (2, 8, 18, 32)))]
    ours = make_sharded_step(mesh.make_mesh([cuda] * 4, time_parallel=2), 72, 128)(
        *(p.to(cuda) for p in planes))
    assert ck.LAUNCHES["resize_frames_fused"] == 3
    assert ck.LAUNCHES["siti_frames_fused_batch"] == 1
    ref = make_sharded_step(mesh.make_mesh(["cpu"] * 4, time_parallel=2), 72, 128)(*planes)
    for a, b in zip(ours[:3], ref[:3]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(ours[3:], ref[3:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-3)


def test_halo_refuses_a_cuda_tensor_on_a_gloo_group(cuda, tmp_path):
    """A time split across ranks over gloo: the card's halo frame is refused,
    never staged through the host."""
    import torch.distributed as dist

    from processing_chain_tpu_torch.parallel import mesh
    from processing_chain_tpu_torch.parallel.pipeline import make_sharded_step

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        # rank 0's half of a (1, 2) grid whose second time slot is rank 1's
        grid = ((mesh.Slot(0, cuda), mesh.Slot(1, cuda)),)
        m = mesh.Mesh(grid, 0, dist.group.WORLD)
        planes = [_rand(s, 255, torch.uint8, cuda, k)
                  for k, s in enumerate(((1, 4, 36, 64), (1, 4, 18, 32), (1, 4, 18, 32)))]
        with pytest.raises(ValueError, match="CUDA tensor on a gloo"):
            make_sharded_step(m, 72, 128)(*planes)
    finally:
        dist.destroy_process_group()


def test_profiled_wave_trace_holds_the_kernel_launches(cuda, tmp_path):
    """A profiled run_bucket on the card: the torch.profiler trace holds one
    kernel event a wrapper launch, by the symbols the trace names; the
    transfer metrics, the wave and transfer spans and a verdict land."""
    from processing_chain_tpu_torch import telemetry as ptm
    from processing_chain_tpu_torch.parallel import mesh as pmesh
    from processing_chain_tpu_torch.parallel import p03_batch
    from processing_chain_tpu_torch.telemetry import profiling

    rng = np.random.default_rng(4)
    lanes = []
    for n in (13, 6):
        yuv = [rng.integers(0, 256, s).astype(np.uint8)
               for s in ((n, 72, 128), (n, 36, 64), (n, 36, 64))]
        lanes.append(p03_batch.Lane(chunks=iter([yuv]), emit=lambda p: None, n_frames_hint=n))
    mesh = pmesh.make_mesh([cuda] * 2)
    p03_batch.run_bucket(lanes[:1], mesh, 144, 256, chunk=4)  # build the kernels first
    ptm.reset()
    ptm.enable()
    try:
        prof = profiling.Profiler(str(tmp_path), interval_s=0.05, device_trace=True).start("s")
        ck.reset_launches()
        p03_batch.run_bucket(lanes[1:] + [p03_batch.Lane(
            chunks=iter([[rng.integers(0, 256, s).astype(np.uint8)
                          for s in ((13, 72, 128), (13, 36, 64), (13, 36, 64))]]),
            emit=lambda p: None, n_frames_hint=13)], mesh, 144, 256, chunk=4)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        paths = prof.stop("s")
        metrics = ptm.REGISTRY.snapshot()
    finally:
        ptm.disable()
    assert "device_trace_error" not in paths, paths
    trace = profiling.load_device_trace(paths["device_trace_dir"])
    counts = {}
    for ev in profiling.device_events(trace, "kernel"):
        names = ck.launch_names(ev["name"])
        if names:
            counts[names] = counts.get(names, 0) + 1
    assert launches["resize_frames_fused"] == 3 * 4 and launches["siti_frames_fused_batch"] == 4
    assert counts == {("resize_frames_fused",): 12,
                      ("siti_frames_fused", "siti_frames_fused_batch"): 4}
    assert profiling.device_events(trace, "copy")
    comps, missing = profiling.components_from_metrics(metrics)
    assert comps["transfer"] > 0 and "decode" in comps
    with open(paths["trace"]) as f:
        import json

        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert {"wave_step", "device_put", "device_get"} <= names


def test_memory_gauges_equal_memory_stats(cuda):
    from processing_chain_tpu_torch import telemetry as ptm
    from processing_chain_tpu_torch.telemetry import profiling

    keep = torch.empty(1 << 24, dtype=torch.uint8, device=cuda)
    ptm.reset()
    ptm.enable()
    try:
        sample = profiling.sample_resources()
        stats = torch.cuda.memory_stats(cuda)
        gauge = {tuple(sorted(s["labels"].items())): s["value"] for s in
                 ptm.REGISTRY.snapshot()["chain_device_memory_bytes"]["series"]}
    finally:
        ptm.disable()
    entry = sample["device_memory_by_device"]["cuda:0"]
    assert entry["bytes_in_use"] == stats["allocated_bytes.all.current"] >= keep.numel()
    assert entry["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"]
    assert entry["bytes_limit"] == torch.cuda.mem_get_info(cuda)[1]
    for kind, val in entry.items():
        assert gauge[(("device", "cuda:0"), ("kind", kind))] == val
    del keep
