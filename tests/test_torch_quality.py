"""Port parity: the device half of the quality tool
(processing_chain_tpu_torch/tools/quality_metrics.py) against the JAX
package's `compute_pvs_metrics`, on the CPU.

The fixtures are the clips tests/test_tools.py builds (FFV1 through the
JAX package's own VideoWriter); the port scores chunks decoded from them
by the JAX package's VideoReader, and its table is compared with the CSV
the JAX tool writes for the same pair. Tolerances: the CSV carries 5
decimals, and the two packages compute in f32 in another order, so PSNR
agrees within 1e-3 dB, SSIM, MS-SSIM and VIF within 1e-4, SI and TI
within 1e-3 (the port computes them at container depth, in f64 sums);
the frame column, PSNR's 100 dB cap and the column order are exact. The
CSV text is byte-equal to pandas'."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from processing_chain_tpu.engine import prefetch as jpf
from processing_chain_tpu.io.video import VideoReader, VideoWriter
from processing_chain_tpu.tools import quality_metrics as jqm
from processing_chain_tpu_torch.engine import prefetch as tpf
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.tools import quality_metrics as tqm

ATOL = {"psnr_y": 1e-3, "psnr_u": 1e-3, "psnr_v": 1e-3, "ssim_y": 1e-4,
        "msssim_y": 1e-4, "vif_y": 1e-4, "si": 1e-3, "ti": 1e-3}


def _write(path, planes, pix_fmt="yuv420p", fps=24):
    y = planes[0]
    n, h, w = y.shape
    with VideoWriter(str(path), "ffv1", w, h, pix_fmt, (fps, 1)) as wr:
        for k in range(n):
            wr.write(y[k], planes[1][k], planes[2][k])


def _flat_chroma(n, h, w, dtype, u, v):
    return (np.full((n, h // 2, w // 2), u, dtype), np.full((n, h // 2, w // 2), v, dtype))


class _Tc:
    def __init__(self, root):
        self.root = root

    def get_side_information_path(self):
        return os.path.join(self.root, "sideInfo")


class _Pvs:
    """The duck-typed PVS of tests/test_tools.py."""

    def __init__(self, root, pvs_id, avpvs, src, events=None):
        self.test_config = _Tc(root)
        self.src = type("Src", (), {"file_path": str(src)})()
        self.pvs_id = pvs_id
        self._avpvs = str(avpvs)
        self._events = events

    def get_avpvs_file_path(self):
        return self._avpvs

    def has_buffering(self):
        return bool(self._events)

    def has_framefreeze(self):
        return False

    def get_buff_events_media_time(self):
        return self._events


def _decode(path, chunk=tqm.CHUNK):
    with VideoReader(str(path)) as reader:
        chunks = [[np.array(p, copy=True) for p in c]
                  for c in jpf.iter_plane_chunks(reader, chunk)]
        return chunks, reader.fps


def _port_table(avpvs, src, msssim=False, vif=False, events=None, sidecar=None, chunk=tqm.CHUNK):
    deg, deg_fps = _decode(avpvs, chunk)
    ref, ref_fps = _decode(src, chunk)
    n_avpvs = sum(c[0].shape[0] for c in deg)
    out_index = tqm._src_index_map(deg_fps, ref_fps, events, n_avpvs)
    ref_frames = tpf.iter_chunk_frames([[torch.from_numpy(p) for p in c] for c in ref])
    pairs = tqm._paired_chunks(iter(deg), ref_frames, out_index, chunk)
    return tqm.score_chunks(pairs, msssim=msssim, vif=vif, sidecar=sidecar, device="cpu")


def _jax_table(tmp_path, pvs_id, avpvs, src, **kw):
    pvs = _Pvs(str(tmp_path), pvs_id, avpvs, src, kw.pop("events", None))
    return pd.read_csv(jqm.compute_pvs_metrics(pvs, **kw))


def _same_table(ours, ref):
    assert list(ours) == list(ref.columns)
    np.testing.assert_array_equal(ours["frame"], ref["frame"].to_numpy())
    for k in list(ours)[1:]:
        np.testing.assert_allclose(ours[k], ref[k].to_numpy(), rtol=0, atol=ATOL[k], err_msg=k)


@pytest.fixture
def clean_noisy(tmp_path):
    """tests/test_tools.py test_quality_metrics_identical_and_degraded's
    clips: a SRC, an identical AVPVS and a noisy one, 96x128, 10 frames."""
    rng = np.random.default_rng(3)
    h, w, n = 96, 128, 10
    frames = rng.integers(16, 235, size=(n, h, w), dtype=np.uint8)
    noisy = np.clip(frames.astype(int) + rng.integers(-25, 25, frames.shape), 0, 255
                    ).astype(np.uint8)
    paths = {}
    for name, y in (("src", frames), ("clean", frames), ("noisy", noisy)):
        paths[name] = tmp_path / f"{name}.avi"
        _write(paths[name], (y, *_flat_chroma(n, h, w, np.uint8, 128, 128)))
    return paths


@pytest.mark.parametrize("chunk", [tqm.CHUNK, 4])
def test_eight_bit_tables_equal_jax(tmp_path, clean_noisy, chunk):
    for pvs_id, name in (("DB_S_H0", "clean"), ("DB_S_H1", "noisy")):
        ours = _port_table(clean_noisy[name], clean_noisy["src"], chunk=chunk)
        _same_table(ours, _jax_table(tmp_path / str(chunk), pvs_id, clean_noisy[name],
                                     clean_noisy["src"]))
        if name == "clean":
            assert (ours["psnr_y"] == 100.0).all() and ours["ti"][0] == 0.0
        else:
            assert (ours["si"] > 0).all() and (ours["ti"][1:] > 0).all()
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}


def test_mixed_depth_table_equals_jax(tmp_path):
    """tests/test_tools.py test_quality_metrics_mixed_bit_depth's clips: a
    10-bit AVPVS holding an 8-bit SRC's samples x4 scores as identical."""
    rng = np.random.default_rng(7)
    h, w, n = 48, 64, 6
    y8 = rng.integers(16, 235, (n, h, w), np.uint8)
    src, ten = tmp_path / "src.avi", tmp_path / "ten.avi"
    _write(src, (y8, *_flat_chroma(n, h, w, np.uint8, 128, 118)))
    _write(ten, (y8.astype(np.uint16) * 4, *_flat_chroma(n, h, w, np.uint16, 512, 472)),
           "yuv420p10le")
    ours = _port_table(ten, src)
    _same_table(ours, _jax_table(tmp_path, "DB_S_H2", ten, src))
    assert (ours["psnr_y"] == 100.0).all() and (ours["psnr_u"] == 100.0).all()
    assert (ours["ssim_y"] > 0.9999).all()
    # the reused sidecar: container-depth SI/TI, scaled by 0.25 as in JAX
    si, ti = 40.0 + np.arange(n), 3.0 * np.arange(n)
    with open(str(ten) + ".siti.csv", "w") as f:
        f.write("frame,si,ti\n" + "".join(f"{k},{si[k]},{ti[k]}\n" for k in range(n)))
    ours = _port_table(ten, src, sidecar={"si": si, "ti": ti})
    ref = _jax_table(tmp_path / "sc", "DB_S_H2", ten, src)
    _same_table(ours, ref)
    np.testing.assert_allclose(ours["si"], si * 0.25)


def test_msssim_vif_table_equals_jax(tmp_path):
    """--msssim --vif on frames large enough for the 5-scale pyramid, a
    chroma offset and a resized SRC (the AVPVS grid is twice the SRC's)."""
    rng = np.random.default_rng(6)
    h, w, n = 180, 192, 3
    big = rng.integers(16, 235, size=(n, h, w)).astype(np.float32)
    big = ((big + np.roll(big, 1, 1) + np.roll(big, 1, 2)) / 3.0).astype(np.uint8)
    src, deg = tmp_path / "src.avi", tmp_path / "deg.avi"
    small = big[:, ::2, ::2].copy()
    _write(src, (small, *_flat_chroma(n, h // 2, w // 2, np.uint8, 120, 130)))
    noisy = np.clip(big.astype(int) + rng.integers(-6, 7, big.shape), 0, 255).astype(np.uint8)
    _write(deg, (noisy, *_flat_chroma(n, h, w, np.uint8, 124, 130)))
    ours = _port_table(deg, src, msssim=True, vif=True)
    assert list(ours) == ["frame"] + tqm.metric_columns(True, True)
    _same_table(ours, _jax_table(tmp_path, "DB_S_H5", deg, src, msssim=True, vif=True))
    assert (ours["vif_y"] < 1.0).all() and (ours["msssim_y"] > 0).all()


def test_stalled_table_equals_jax(tmp_path):
    """tests/test_tools.py test_quality_metrics_stall_alignment's clips:
    after the inserted stall frames the SRC realigns exactly."""
    h, w, fps, n_src = 48, 64, 24, 48
    stall_at, stall_dur = 1.0, 0.5

    def luma(i):
        return np.full((h, w), 20 + 4 * (i % 50), np.uint8)

    n_stall, insert_at = int(round(stall_dur * fps)), int(round(stall_at * fps))
    src_y = np.stack([luma(i) for i in range(n_src)])
    deg_y = np.concatenate([src_y[:insert_at], np.full((n_stall, h, w), 16, np.uint8),
                            src_y[insert_at:]])
    src, avpvs = tmp_path / "src.avi", tmp_path / "avpvs.avi"
    _write(src, (src_y, *_flat_chroma(n_src, h, w, np.uint8, 128, 128)))
    _write(avpvs, (deg_y, *_flat_chroma(len(deg_y), h, w, np.uint8, 128, 128)))
    events = [[stall_at, stall_dur]]
    ours = _port_table(avpvs, src, events=events, chunk=16)
    _same_table(ours, _jax_table(tmp_path, "DB_S_H3", avpvs, src, events=events))
    stall = np.zeros(len(deg_y), bool)
    stall[insert_at:insert_at + n_stall] = True
    assert (ours["psnr_y"][~stall] == 100.0).all() and (ours["psnr_y"][stall] < 40).all()


@pytest.mark.parametrize("rate,src_fps,events,n_avpvs,freeze", [
    (24.0, 24.0, [[1.0, 0.5]], 60, False),
    (60.0, 60.0, [[2.0, 1.0], [7.5, 0.5]], 690, False),
    (30.0, 60.0, [[0.5, 0.25], [1.0, 0.1]], 40, False),
    (25.0, 50.0, [[0.0, 0.4]], 3, False),
    (60.0, 60.0, [[0.5, 0.4]], 128, True),
    (60.0, 24.0, None, 100, False),
])
def test_src_index_map_equals_jax(monkeypatch, rate, src_fps, events, n_avpvs, freeze):
    """The JAX map reads the AVPVS frame count from a probe; the probe is
    monkeypatched on the JAX module (nothing in the package changes)."""
    monkeypatch.setattr(jqm.medialib, "probe", lambda path: {
        "streams": [{"codec_type": "video", "nb_frames": n_avpvs}]})
    pvs = _Pvs("/nonexistent", "DB_S_H9", "/nonexistent/x.avi", "/nonexistent/s.avi", events)
    pvs.has_framefreeze = lambda: freeze
    want = jqm._src_index_map(pvs, rate, src_fps)
    got = tqm._src_index_map(rate, src_fps, events, n_avpvs, freeze)
    assert [got(k) for k in range(n_avpvs + 20)] == [want(k) for k in range(n_avpvs + 20)]


def test_paired_chunks_follow_the_avpvs_and_hold_the_last_src_frame():
    """The AVPVS side decides the length: past the SRC's end the gather
    repeats its last frame (the reference's clamp), and each pair is cut
    to its shorter side."""
    deg = [[torch.full((n, 2, 2), k, dtype=torch.uint8)] * 3 for k, n in enumerate((4, 4, 2))]
    ref = [[torch.arange(5, dtype=torch.uint8).reshape(5, 1, 1).expand(5, 2, 2).contiguous()] * 3]
    pairs = list(tqm._paired_chunks(iter(deg), tpf.iter_chunk_frames(ref), lambda k: k, 4))
    assert [p[0][0].shape[0] for p in pairs] == [4, 4, 2]
    assert [p[1][0][:, 0, 0].tolist() for p in pairs] == [[0, 1, 2, 3], [4, 4, 4, 4], [4, 4]]


def test_csv_text_byte_equal_to_pandas(tmp_path):
    rng = np.random.default_rng(12)
    n = 50
    table = {"frame": np.arange(n)}
    for k in tqm.metric_columns(True, True):
        table[k] = (rng.normal(0, 30, n) * rng.choice([1e-6, 1, 1e4], n)).astype(np.float32)
    table["psnr_y"][:3] = [100.0, np.nan, -0.0]
    table["ssim_y"][3] = np.inf
    table["si"] = table["si"].astype(np.float64)
    want = pd.DataFrame(table).to_csv(index=False, float_format="%.5f")
    assert tqm.metrics_csv_text(table) == want
    path = str(tmp_path / "x.metrics.csv")
    assert tqm.write_metrics_csv(path, table) == path
    with open(path, "rb") as f:
        assert f.read() == want.encode()
    assert os.listdir(tmp_path) == ["x.metrics.csv"]
    empty = {"frame": np.arange(0), **{k: np.empty(0) for k in tqm.metric_columns()}}
    assert tqm.metrics_csv_text(empty) == pd.DataFrame(empty).to_csv(
        index=False, float_format="%.5f")


def test_empty_pairs_give_an_empty_table():
    table = tqm.score_chunks(iter([]), msssim=True, device="cpu")
    assert list(table) == ["frame"] + tqm.metric_columns(True, False)
    assert all(len(v) == 0 for v in table.values())
