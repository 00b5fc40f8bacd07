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
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.ops import resize, siti
from processing_chain_tpu_torch.parallel.pipeline import iter_device_ahead

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
    with pytest.raises(ValueError):
        resize.resize_plane(x, 40, 60)
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
                           "ti_frames_fused": 3}
    (gp, gsi, gti), (cp, csi, cti) = out[str(cuda)], out["cpu"]
    for a, b in zip(gp, cp):
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb)
    atol = 1e-2 if ten_bit else 1e-3
    torch.testing.assert_close(gsi, csi, rtol=1e-4, atol=atol)
    torch.testing.assert_close(gti, cti, rtol=1e-4, atol=atol)
    assert siti.ti_frames(torch.from_numpy(chunks[0][0]).to(cuda)).shape == (8,)
