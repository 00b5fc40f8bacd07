"""The slice as a whole: the port's `pump_ready` against the JAX package's
`_pump_ready` on the same seeded chunks, on the CPU.

Three chunks of 8 frames, 96x160 yuv420p -> a 192x320 canvas, bicubic.
u8 planes must be identical, 10-bit planes within one code value, SI/TI
within the reference's tolerance, and the sidecar CSV must have the same
header and row count."""

import csv

import numpy as np
import pytest
import torch

from processing_chain_tpu.models import avpvs as ja
from processing_chain_tpu_torch.models import avpvs as ta
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.parallel.pipeline import iter_device_ahead

H, W, DH, DW, T, CHUNKS = 96, 160, 192, 320, 8, 3


class ListWriter:
    """Fake writer: fetches each quantized chunk to host numpy."""

    def __init__(self):
        self.planes = []
        self.recycled = []

    def put(self, planes, recycle=None):
        self.planes.append([
            p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in planes
        ])
        self.recycled.append(recycle)


def make_chunks(ten_bit, seed=0):
    """A moving gradient plus noise, so SI and TI are non-trivial."""
    rng = np.random.default_rng(seed)
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    chunks = []
    for c in range(CHUNKS):
        planes = []
        for ph, pw in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
            t = np.arange(c * T, (c + 1) * T)[:, None, None]
            xx = np.arange(pw)[None, None, :]
            yy = np.arange(ph)[None, :, None]
            base = (xx * 3 + yy * 2 + t * 5) % (hi + 1)
            noise = rng.integers(-20, 21, (T, ph, pw))
            planes.append(np.clip(base + noise, 0, hi).astype(dtype))
        chunks.append(planes)
    return chunks


def read_sidecar(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_pump_ready_matches_jax(pix_fmt, tmp_path):
    ten_bit = "10" in pix_fmt
    chunks = make_chunks(ten_bit)

    jw, jfeat = ListWriter(), ja.SiTiAccumulator()
    ja._pump_ready(iter(chunks), jw, jfeat, DH, DW, pix_fmt)
    tk.reset_launches()
    tw, tfeat = ListWriter(), ta.SiTiAccumulator()
    ta.pump_ready(iter(chunks), tw, tfeat, DH, DW, pix_fmt, device="cpu")
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}

    assert len(tw.planes) == len(jw.planes) == CHUNKS
    assert [r is c for r, c in zip(tw.recycled, chunks)] == [True] * CHUNKS
    for ours, ref in zip(tw.planes, jw.planes):
        for a, b in zip(ours, ref):
            assert a.shape == b.shape and a.dtype == b.dtype
            if ten_bit:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_array_equal(a, b)

    atol = 1e-2 if ten_bit else 1e-3
    si = np.concatenate([s.numpy() for s in tfeat.si])
    ti = np.concatenate([t.numpy() for t in tfeat.ti])
    np.testing.assert_allclose(
        si, np.concatenate([np.asarray(s) for s in jfeat.si]), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(
        ti, np.concatenate([np.asarray(t) for t in jfeat.ti]), rtol=1e-4, atol=atol)
    assert ti[0] == 0.0 and np.all(ti[1:] > 0) and np.all(si > 0)

    ours_csv = read_sidecar(tfeat.write(str(tmp_path / "ours.avi")))
    ref_csv = read_sidecar(jfeat.write(str(tmp_path / "ref.avi")))
    assert ours_csv[0] == ref_csv[0] == ["frame", "si", "ti"]
    assert len(ours_csv) == len(ref_csv) == CHUNKS * T + 1
    assert [r[0] for r in ours_csv] == [r[0] for r in ref_csv]


def test_sidecar_write_and_discard(tmp_path):
    out = str(tmp_path / "x.avi")
    feat = ta.SiTiAccumulator()
    assert feat.write(out) is None
    feat.update(torch.full((2, 8, 8), 9, dtype=torch.uint8))
    path = feat.write(out)
    assert path == ta.siti_sidecar_path(out)
    assert read_sidecar(path) == [
        ["frame", "si", "ti"], ["0", "0.000000", "0.000000"], ["1", "0.000000", "0.000000"]]
    ta.SiTiAccumulator.discard(out)
    ta.SiTiAccumulator.discard(out)  # already gone: no error
    assert not (tmp_path / "x.avi.siti.csv").exists()


def test_chunk_frames(monkeypatch):
    monkeypatch.delenv("PC_CHUNK_FRAMES", raising=False)
    assert ta.chunk_frames("cpu") == 16
    assert ta.CHUNK == ja.CHUNK == 64
    monkeypatch.setenv("PC_CHUNK_FRAMES", "0")
    assert ta.chunk_frames("cpu") == 1
    monkeypatch.setenv("PC_CHUNK_FRAMES", "sixty")
    with pytest.raises(ValueError):
        ta.chunk_frames("cpu")


def test_iter_device_ahead_cpu_order():
    chunks = make_chunks(False)
    pairs = list(iter_device_ahead(iter(chunks), "cpu"))
    assert [host is c for (host, _), c in zip(pairs, chunks)] == [True] * CHUNKS
    for (_, dev), c in zip(pairs, chunks):
        for d, p in zip(dev, c):
            assert isinstance(d, torch.Tensor)
            np.testing.assert_array_equal(d.numpy(), p)
    assert list(iter_device_ahead(iter([]), "cpu")) == []

