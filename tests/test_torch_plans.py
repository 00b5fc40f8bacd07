"""Port parity: the plans that take a `Pvs` (processing_chain_tpu_torch/
models/avpvs, models/cpvs, models/segments, ops/resize.plan_resize_method)
against the JAX package's, on the CPU, on databases loaded by both
packages' TestConfig with StaticProber: the fixtures' short and long
databases, chip_smoke's phase-14 database and seeded random ones.

The one field the two packages' plans may not share is `resize`, the
resize-method identity: the port's values all start with "torch-", which
the JAX package never records, so a shared store can never hand bytes one
package built to a plan of the other. The tests assert that it differs,
then compare payloads and hashes with it set alike."""

import os

import numpy as np
import pytest

import chip_smoke
from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.models import cpvs as jcp
from processing_chain_tpu.models import segments as jseg
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu.ops import resize as jrs
from processing_chain_tpu.store import keys as jkeys
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.models import cpvs as tcp
from processing_chain_tpu_torch.models import segments as tseg
from processing_chain_tpu_torch.ops import overlay as tov
from processing_chain_tpu_torch.ops import resize as trs
from processing_chain_tpu_torch.store import keys as tkeys
from tests import _torch_db as db
from tests.fixtures import write_long_db, write_short_db

KNOBS = ("PC_FFV1_SLICES", "PC_FFV1_THREADS", "PC_FFV1_WORKERS", "PC_AVPVS_CODEC",
         "PC_RESIZE_METHOD")
# pinned writeback knobs: (slices, threads, workers, codec)
ENVS = [
    ("", "4", "0", "ffv1"),
    ("16", "4", "0", "ffv1"),
    ("", "", "3", "ffv1"),
    ("", "2", "0", "rawvideo"),
]


@pytest.fixture
def knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def pin(slices, threads, workers, codec):
        for k, v in zip(KNOBS, (slices, threads, workers, codec)):
            if v:
                monkeypatch.setenv(k, v)
            else:
                monkeypatch.delenv(k, raising=False)

    return pin


def _short(tmp_path):
    path, prober = write_short_db(tmp_path)
    return path, prober.table, {}


def _long(tmp_path):
    path, prober = write_long_db(tmp_path, src_duration=12.0)
    return path, prober.table, {}


def _phase14(tmp_path):
    path = chip_smoke.write_database(str(tmp_path), chip_smoke.DB_ID, chip_smoke.DB_YAML,
                                     chip_smoke.DB_SRCS)
    return path, chip_smoke.DB_SRCS, {}


def _random(seed):
    def make(tmp_path):
        db_id = f"P2SXM{seed:02d}" if seed % 2 else f"P2LTR{seed:02d}"
        data, table = db.random_database(seed, db_id)
        path = db.write_database(tmp_path, data, table)
        return path, table, {"complexity_csv_dir": db.complexity_dir(tmp_path)}

    make.__name__ = f"random{seed}"
    return make


DATABASES = [_short, _long, _phase14] + [_random(s) for s in (0, 1, 3, 5, 12, 16, 21, 42)]


def _load(make, tmp_path):
    """(JAX TestConfig, port TestConfig) of one database folder."""
    path, table, kwargs = make(tmp_path)
    return tuple(pkg.TestConfig(path, prober=db.prober(pkg, table), **kwargs)
                 for pkg in db.PACKAGES)


@pytest.mark.parametrize("make", DATABASES, ids=lambda m: m.__name__)
def test_canvas_and_segment_plans_equal(make, tmp_path):
    jtc, ttc = _load(make, tmp_path)
    assert list(jtc.pvses) == list(ttc.pvses) and jtc.pvses
    for pid, jp in jtc.pvses.items():
        tp = ttc.pvses[pid]
        for k in range(len(jtc.post_processings)):
            assert db.call(tav.avpvs_dimensions, tp, k) == db.call(jav.avpvs_dimensions, jp, k)
        for src_fps in (False, True):
            assert db.call(tav.canvas_fps, tp, src_fps) == db.call(jav.canvas_fps, jp, src_fps)
        assert len(tp.segments) == len(jp.segments)
        for ts, js in zip(tp.segments, jp.segments):
            assert ts.filename == js.filename
            assert db.call(tseg.plan_segment_frames, ts) == \
                db.call(jseg.plan_segment_frames, js)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: "-".join(v or "unset" for v in e))
@pytest.mark.parametrize("make", DATABASES[:3] + DATABASES[4:6], ids=lambda m: m.__name__)
def test_wo_buffer_and_cpvs_plans_and_hashes_equal(make, env, knobs, tmp_path):
    knobs(*env)
    jtc, ttc = _load(make, tmp_path)
    for pid, jp in jtc.pvses.items():
        tp = ttc.pvses[pid]
        w, h = jav.avpvs_dimensions(jp)
        pix_fmt = jp.get_pix_fmt_for_avpvs()
        assert (w, h) == tav.avpvs_dimensions(tp) and pix_fmt == tp.get_pix_fmt_for_avpvs()
        for flags in ((False, False), (False, True), (True, False)):
            ref = jav._wo_buffer_plan(jp, w, h, pix_fmt, *flags)
            ours = tav._wo_buffer_plan(tp, w, h, pix_fmt, *flags, device="cpu")
            assert ref["resize"] == "auto:cpu" and ours["resize"] == "torch-auto:cpu"
            assert jkeys.plan_hash(ref) != tkeys.plan_hash(ours)
            ours["resize"] = ref["resize"]
            assert ours == ref
            assert tkeys.plan_hash(ours) == jkeys.plan_hash(ref)
            # resolved against the segments' content digests, as at commit
            for seg in jp.segments:
                os.makedirs(os.path.dirname(seg.file_path), exist_ok=True)
                with open(seg.file_path, "wb") as f:
                    f.write(seg.filename.encode())
            assert tkeys.plan_hash(ours, tkeys.hash_file) == \
                jkeys.plan_hash(ref, jkeys.hash_file)
        assert tav._wo_buffer_provenance(tp, w, h, pix_fmt) == \
            jav._wo_buffer_provenance(jp, w, h, pix_fmt)
        assert tav._wo_buffer_out_path(tp) == jav._wo_buffer_out_path(jp)
        for jpp, tpp in zip(jtc.post_processings, ttc.post_processings):
            for kwargs in ({}, {"rawvideo": True}, {"nonraw_crf": 23, "mobile_preset": "slow"}):
                ref = db.call(jcp.cpvs_plan, jp, jpp, h, **kwargs)
                ours = db.call(tcp.cpvs_plan, tp, tpp, h, **kwargs)
                assert ours == ref
                if ref[0] == "ok":
                    assert tkeys.plan_hash(ours[1]) == jkeys.plan_hash(ref[1])


@pytest.mark.parametrize("make", DATABASES, ids=lambda m: m.__name__)
def test_stall_plans_equal(make, tmp_path):
    """plan_stalling over each buffering PVS's media-time events, at the
    60 fps canvas and at the SRC's rate, on the number of frames the
    events play."""
    jtc, ttc = _load(make, tmp_path)
    buffering = 0
    for pid, jp in jtc.pvses.items():
        tp = ttc.pvses[pid]
        assert tp.has_buffering() == jp.has_buffering()
        if not jp.has_buffering():
            continue
        buffering += 1
        events = tp.get_buff_events_media_time()
        assert events == jp.get_buff_events_media_time()
        skipping = tp.has_framefreeze()
        media = sum(float(s.duration) for s in tp.segments)
        for fps in (tav.canvas_fps(tp), tp.src.get_fps()):
            n = int(round(media * fps))
            ours = tov.plan_stalling(n, fps, events, skipping=skipping, black_frame=True,
                                     n_rotations=64)
            ref = jov.plan_stalling(n, fps, events, skipping=skipping, black_frame=True,
                                    n_rotations=64)
            for field in ("src_idx", "stall_mask", "black_mask", "phase"):
                np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
            assert ours.n_out == ref.n_out >= n
    if make in (_long, _phase14):
        assert buffering


@pytest.mark.parametrize("env", [
    {}, {"PC_AVPVS_CODEC": "rawvideo"}, {"PC_AVPVS_CODEC": "RawVideo"},
    {"PC_AVPVS_CODEC": "prores"}, {"PC_FFV1_WORKERS": "0", "PC_FFV1_THREADS": "5"},
    {"PC_FFV1_WORKERS": "0", "PC_FFV1_THREADS": "40"},
    {"PC_FFV1_WORKERS": "0", "PC_FFV1_SLICES": "12"},
    {"PC_FFV1_WORKERS": "0", "PC_FFV1_SLICES": "7"}, {"PC_FFV1_WORKERS": "two"},
    {"PC_FFV1_WORKERS": "-3"}, {"PC_FFV1_THREADS": "x"}, {"PC_FFV1_WORKERS": "6"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_ffv1_and_codec_knobs_equal(env, knobs, monkeypatch):
    knobs("", "", "", "")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in ("avpvs_codec", "ffv1_workers", "ffv1_coding_threads", "ffv1_effective_coding",
                 "ffv1_effective_slices"):
        assert db.call(getattr(tav, name)) == db.call(getattr(jav, name)), name
    for pix_fmt in ("yuv420p", "yuv420p10le", "yuv422p10le"):
        assert db.call(tav.effective_avpvs_codec, pix_fmt) == \
            db.call(jav.effective_avpvs_codec, pix_fmt)
    for threads in (1, 4, 9, 30, 31):
        assert db.call(tav.ffv1_slices, threads) == db.call(jav.ffv1_slices, threads)
    assert tav.FFV1_SLICE_COUNTS == jav.FFV1_SLICE_COUNTS


@pytest.mark.parametrize("value", [None, "", "auto", " Auto "])
def test_plan_resize_method_is_the_ports_own(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("PC_RESIZE_METHOD", raising=False)
    else:
        monkeypatch.setenv("PC_RESIZE_METHOD", value)
    assert trs.plan_resize_method("cpu") == "torch-auto:cpu"
    assert trs.plan_resize_method("cpu") != jrs.plan_resize_method()


@pytest.mark.parametrize("value", ["fused", "lanczos", "gather2", "gather", " Banded "])
def test_plan_resize_method_refuses_what_the_port_lacks(value, monkeypatch):
    """The port's render has no PC_RESIZE_METHOD switch, so a plan may
    name no method but the auto route: "gather" and "banded" are refused
    as well as the JAX package's "fused"."""
    monkeypatch.setenv("PC_RESIZE_METHOD", value)
    with pytest.raises(ValueError, match="PC_RESIZE_METHOD"):
        trs.plan_resize_method("cpu")


def test_plan_resize_method_means_the_card_by_default(monkeypatch):
    """`device=None` means cuda:0; a host without CUDA raises."""
    from processing_chain_tpu_torch.utils.device import DeviceError

    monkeypatch.delenv("PC_RESIZE_METHOD", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(DeviceError):
        trs.plan_resize_method()


@pytest.mark.parametrize("value", ["fused", "gather", "banded"])
def test_pc_resize_method_leaves_the_route_alone(value, monkeypatch):
    """PC_RESIZE_METHOD is the JAX package's switch: the port's renders
    keep the auto route whatever it says (its plans refuse the value,
    above), for u8 planes and for float work."""
    import torch

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (2, 36, 64)).astype(np.uint8))
    xf = x.to(torch.float32) / 255.0
    monkeypatch.delenv("PC_RESIZE_METHOD", raising=False)
    want = trs.resize_plane(x, 72, 128, "bicubic")
    want_f = trs.resize_plane(xf, 54, 96, "bicubic", quantize_output=False)
    monkeypatch.setenv("PC_RESIZE_METHOD", value)
    assert torch.equal(trs.resize_plane(x, 72, 128, "bicubic"), want)
    assert torch.equal(trs.resize_plane(xf, 54, 96, "bicubic", quantize_output=False), want_f)
