"""The fused p03+p04 route of the port (PC_FUSE_P04: models/fused.
FusedFanout, the fan-out hooks of models/avpvs.create_avpvs_wo_buffer,
stages/p03_generate_avpvs) against the JAX package's fused route and the
port's own staged route on the CPU: the contracts of tests/test_fused.py,
over the databases of tests/test_torch_p03_file.py (segments encoded by
the JAX p01 with libx264), run as p03 and then p04 since the port has no
p00.

Lossless members (the stalled AVPVS, the PC context's rawvideo UYVY422)
must decode identical; libx264 and prores_ks streams are not pinned, so
the x264 contexts and the preview are held by the sha1 of the planes each
writer is handed and by the PSNR of the decoded files. The JAX reference
takes the port's resize route (tests/test_torch_p04_file.py): its Pallas
kernel in interpret mode for the u8 bilinear 420->422 lift, its default
route for the u8 bicubic scales, and one device for its stall composite.
"""

import json
import os

import numpy as np
import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu.config import TestConfig as JTestConfig
from processing_chain_tpu.io import medialib as jml
from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.models import fused as jfused
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu.ops import pixfmt as jpf
from processing_chain_tpu.tools import bufferer_calibrate as jcal
from processing_chain_tpu_torch import telemetry as ttm
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from processing_chain_tpu_torch.io import video as tvideo
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.models import fused as tfused
from processing_chain_tpu_torch.ops import overlay as tov
from processing_chain_tpu_torch.store import runtime as truntime
from processing_chain_tpu_torch.tools import bufferer_calibrate as tcal
from processing_chain_tpu_torch.utils.parse_args import _DEFAULT_SPINNER
from tests.test_torch_p03_file import (  # noqa: F401  (fixtures)
    LONG_PVS,
    PVSES,
    _add_freeze,
    _copy,
    _decoded,
    _writeback_env,
    long_db,
    main_log,
    one_jax_device,
    short_db,
)
from tests.test_torch_p04_file import PSNR_FLOOR, EncoderInput, _add_contexts, _psnr

#: the short database's members: (folder, suffix) of each, per PVS
LOSSLESS = (("cpvs", "_PC.avi"),)
X264 = (("cpvs", "_TA.mp4"), ("cpvs", "_MO.mp4"))
STALLED = f"{PVSES[2]}.avi"  # the stall PVS's final AVPVS


@pytest.fixture(autouse=True)
def _clean_runtime():
    """No test leaks an active store or telemetry state."""
    was = ttm.enabled()
    yield
    truntime.configure(None)
    if not was:
        ttm.disable()


@pytest.fixture
def jax_like_port(monkeypatch, one_jax_device):
    """The JAX route the port's resize takes: the Pallas kernel (interpret
    mode) for the u8 bilinear chroma lift, the default route otherwise."""
    orig = jpf.resize_plane

    def resize_plane(x, h, w, kernel="lanczos", *args, **kwargs):
        if kernel == "bilinear":
            kwargs["method"] = "fused"
        return orig(x, h, w, kernel, *args, **kwargs)

    monkeypatch.setattr(jpf, "resize_plane", resize_plane)


def _summary(main_log, stage: str) -> dict:
    lines = [r.getMessage() for r in main_log.records
             if f"{stage} summary: " in r.getMessage()]
    assert len(lines) == 1, lines
    return json.loads(lines[0].split(f"{stage} summary: ", 1)[1])


def _path(yaml_path: str, folder: str, name: str) -> str:
    return os.path.join(os.path.dirname(yaml_path), folder, name)


def _assert_decoded_equal(a: str, b: str) -> None:
    (sa, pa), (sb, pb) = _decoded(a), _decoded(b)
    assert pa == pb and len(sa) == len(sb) == 3, (a, b)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y, err_msg=b)
    try:
        aa = jml.decode_audio_s16(a)
    except jml.MediaError:
        with pytest.raises(jml.MediaError):
            jml.decode_audio_s16(b)
        return
    ab = jml.decode_audio_s16(b)
    assert aa[1] == ab[1]
    np.testing.assert_array_equal(aa[0], ab[0], err_msg=b)


@pytest.fixture(scope="module")
def short_runs(short_db, tmp_path_factory):
    """The short database with the tablet and mobile contexts added,
    three times: the port's staged p03 then p04, the port's fused p03 then
    p04, and the JAX fused p03 (its single device, the port's resize
    route); each writer's input recorded, each port summary kept."""
    import logging

    import jax

    tmp = tmp_path_factory.mktemp("fusedshort")
    copies = {tag: _copy(short_db, tmp / tag) for tag in ("staged", "fused", "jax")}
    for y in copies.values():
        _add_contexts(y)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("main")
    keep = Keep()
    logger.addHandler(keep)
    saved = {k: os.environ.get(k) for k in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS", "PC_FUSE_P04")}
    orig_resize, orig_devices = jpf.resize_plane, jax.devices
    devs = jax.devices()

    def resize_plane(x, h, w, kernel="lanczos", *args, **kwargs):
        if kernel == "bilinear":
            kwargs["method"] = "fused"
        return orig_resize(x, h, w, kernel, *args, **kwargs)

    summaries = {}
    try:
        os.environ.update(PC_FFV1_WORKERS="2", PC_FFV1_THREADS="2")
        with EncoderInput() as enc:
            os.environ.pop("PC_FUSE_P04", None)
            for stage in ("p03", "p04"):
                records.clear()
                assert port_main([stage, "-c", copies["staged"]], device="cpu") == 0
                summaries[f"staged_{stage}"] = _parse(records, stage)
            os.environ["PC_FUSE_P04"] = "1"
            for stage in ("p03", "p04"):
                records.clear()
                assert port_main([stage, "-c", copies["fused"]], device="cpu") == 0
                summaries[f"fused_{stage}"] = _parse(records, stage)
            jpf.resize_plane = resize_plane
            jax.devices = lambda *a, **k: devs[:1]
            assert jax_main(["p03", "-c", copies["jax"], "--skip-requirements", "-g", "0"]) == 0
    finally:
        jpf.resize_plane, jax.devices = orig_resize, orig_devices
        logger.removeHandler(keep)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"copies": copies, "enc": enc, "summaries": summaries}


def _parse(records: list, stage: str) -> dict:
    lines = [m for m in records if f"{stage} summary: " in m]
    assert len(lines) == 1, lines
    return json.loads(lines[0].split(f"{stage} summary: ", 1)[1])


@pytest.mark.parametrize("pvs_id", PVSES)
def test_fused_lossless_members_equal_jax_fused_and_port_staged(short_runs, pvs_id):
    """The PC UYVY CPVS of every PVS and the stalled AVPVS, written by the
    port's fused p03 alone, decode identical to the JAX fused run's and to
    the port's staged p03+p04's, audio included."""
    c = short_runs["copies"]
    names = [("cpvs", f"{pvs_id}{suffix}") for _, suffix in LOSSLESS]
    if pvs_id == PVSES[2]:
        names.append(("avpvs", STALLED))
    names.append(("avpvs", os.path.basename(
        TTestConfig(c["fused"]).pvses[pvs_id].get_avpvs_wo_buffer_file_path()
        if pvs_id == PVSES[2] else f"{pvs_id}.avi")))
    for folder, name in names:
        fused = _path(c["fused"], folder, name)
        _assert_decoded_equal(_path(c["jax"], folder, name), fused)
        _assert_decoded_equal(_path(c["staged"], folder, name), fused)
    assert sorted(os.listdir(_path(c["fused"], "cpvs", ""))) == \
        sorted(os.listdir(_path(c["jax"], "cpvs", "")))


@pytest.mark.parametrize("pvs_id", PVSES)
def test_fused_x264_members_take_the_staged_encoder_input(short_runs, pvs_id):
    """The tablet and mobile x264 contexts: the encoder of the port's
    fused route is handed the bytes the JAX fused route's and the port's
    staged route's are; the decoded files agree within PSNR_FLOOR."""
    c, enc = short_runs["copies"], short_runs["enc"]
    for folder, suffix in X264:
        name = f"{pvs_id}{suffix}"
        fused = _path(c["fused"], folder, name)
        for ref in (_path(c["jax"], folder, name), _path(c["staged"], folder, name)):
            assert enc.digest(fused) == enc.digest(ref), name
            ours, theirs = _decoded(fused)[0], _decoded(ref)[0]
            assert len(ours) == len(theirs) == 3
            for x, y in zip(ours, theirs):
                assert _psnr(x, y, 255.0) >= PSNR_FLOOR, name


def test_fused_run_opens_only_the_segment_decoders(short_runs):
    """The staged p03 decodes each segment, then its stall pass the
    wo_buffer render (probe + gather), then p04 each AVPVS once a context;
    the fused p03 opens only the segment decoders, commits every member,
    and the p04 after it plans nothing."""
    s = short_runs["summaries"]
    assert s["staged_p03"]["decoder_opens"] == {"render": 3, "stall": 2}
    assert s["staged_p04"]["decoder_opens"] == 3 * 3 and s["staged_p04"]["renders"] == 9
    assert s["fused_p03"]["decoder_opens"] == {"render": 3, "stall": 0}
    assert (s["fused_p03"]["renders"], s["fused_p03"]["stalls"]) == (3, 0)
    # three fan-outs: 3 contexts each, and the stall PVS's stalled AVPVS
    assert s["fused_p03"]["fused"] == {"fanouts": 3, "members": 10, "degraded": 0}
    assert s["fused_p04"]["renders"] == 0 and s["fused_p04"]["decoder_opens"] == 0
    # the CPU route launches no kernel; the split adds up over the stage
    for key in ("decode_s", "device_s", "writeback_s"):
        assert s["fused_p03"][key] > 0
    assert s["fused_p03"]["frames"] == s["staged_p03"]["frames"] - 60  # 48 + 12 stall


def test_fused_abort_leaves_no_partial_output(short_db, tmp_path):
    """A fused render that dies mid-stream leaves no member output and no
    crash sentinel behind (tests/test_fused.py's abort contract)."""
    ty = _copy(short_db, tmp_path / "t")
    pvs = TTestConfig(ty).pvses[PVSES[2]]
    fanout = tfused.FusedFanout(pvs, spinner_path=None, device="cpu")
    boom = RuntimeError("mid-stream failure")
    fanout.feed = lambda planes: (_ for _ in ()).throw(boom)
    job = tav.create_avpvs_wo_buffer(pvs, device="cpu", fanout=fanout)
    with pytest.raises(RuntimeError):
        job.run()
    outs = [j.output_path for j in fanout.member_jobs()]
    assert len(outs) == 2
    for out in outs:
        assert not os.path.isfile(out), out
        assert not os.path.isfile(out + ".inprogress"), out


def test_fanout_refuses_two_members_writing_one_file(short_db, tmp_path):
    """Two contexts that write one CPVS path are a write-write race."""
    from processing_chain_tpu_torch.utils.runner import ChainError

    ty = _copy(short_db, tmp_path / "t")
    with open(ty) as f:
        text = f.read()
    line = [x for x in text.splitlines() if x.strip().startswith("- {type: pc")][0]
    with open(ty, "w") as f:
        f.write(text.rstrip("\n") + "\n" + line + "\n")
    with pytest.raises(ChainError, match="write-write race"):
        tfused.FusedFanout(TTestConfig(ty).pvses[PVSES[0]], device="cpu")


@pytest.mark.parametrize("member", ["cpvs", "stall"])
def test_a_failing_member_degrades_and_the_staged_pass_rebuilds_it(
        short_db, tmp_path, monkeypatch, main_log, member):
    """A member whose writer raises mid-stream is dropped alone: counted
    in chain_fused_members_degraded_total, logged, its output and sentinel
    removed, its siblings committed. A degraded stall member is rebuilt by
    p03's staged stall pass in the same run, a degraded CPVS by the next
    p04; each equals the staged route's file."""
    ty = _copy(short_db, tmp_path / "t")
    staged = _copy(short_db, tmp_path / "s")
    assert port_main(["p03", "-c", staged, "--filter-pvs", PVSES[2]], device="cpu") == 0
    assert port_main(["p04", "-c", staged, "--filter-pvs", PVSES[2]], device="cpu") == 0
    pvs = TTestConfig(ty).pvses[PVSES[2]]
    target = pvs.get_cpvs_file_path(context="pc") if member == "cpvs" \
        else pvs.get_avpvs_file_path()
    orig = tvideo.VideoWriter.write_batch
    calls = {"n": 0}

    def write_batch(writer, *planes):
        if writer.path == target:
            calls["n"] += 1
            if calls["n"] == 2:
                raise OSError(28, "No space left on device")
        return orig(writer, *planes)

    main_log.clear()
    ttm.enable()
    before = ttm.REGISTRY.sum_series("chain_fused_members_degraded_total", None) or 0.0
    events0 = len(ttm.EVENTS.records())
    monkeypatch.setenv("PC_FUSE_P04", "1")
    monkeypatch.setenv("PC_CHUNK_FRAMES", "16")  # the first stall chunk lands, then one fails
    monkeypatch.setattr(tvideo.VideoWriter, "write_batch", write_batch)
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[2]], device="cpu") == 0
    monkeypatch.setattr(tvideo.VideoWriter, "write_batch", orig)
    assert calls["n"] >= 2
    assert (ttm.REGISTRY.sum_series("chain_fused_members_degraded_total", None) or 0.0) \
        - before == 1
    events = [e for e in ttm.EVENTS.records()[events0:] if e["event"] == "fused_member_degraded"]
    assert [e["output"] for e in events] == [os.path.basename(target)]
    assert any("aborted mid-stream" in r.getMessage() for r in main_log.records)
    summary = _summary(main_log, "p03")
    assert summary["fused"] == {"fanouts": 1, "members": 1, "degraded": 1}
    assert summary["stalls"] == (1 if member == "stall" else 0)
    assert not os.path.isfile(target + ".inprogress")
    if member == "cpvs":
        assert not os.path.isfile(target)
        main_log.clear()
        assert port_main(["p04", "-c", ty, "--filter-pvs", PVSES[2]], device="cpu") == 0
        assert _summary(main_log, "p04")["renders"] == 1
    sibling = pvs.get_avpvs_file_path() if member == "cpvs" else \
        pvs.get_cpvs_file_path(context="pc")
    for out in (target, sibling):
        rel = os.path.relpath(out, os.path.dirname(ty))
        _assert_decoded_equal(os.path.join(os.path.dirname(staged), rel), out)


def test_fused_warm_store_plans_zero_and_partial_rebuilds_exactly_one(
        short_db, tmp_path, monkeypatch):
    """Every member commits under its staged job's plan hash: a warm p03 +
    p04 re-run plans no job, and corrupting one PC CPVS's store object
    rebuilds exactly that CPVS through p04."""
    from processing_chain_tpu_torch.models import cpvs as tcp

    ty = _copy(short_db, tmp_path / "t")
    store = str(tmp_path / "store")
    monkeypatch.setenv("PC_FUSE_P04", "1")
    ttm.enable()

    def planned() -> float:
        return ttm.REGISTRY.sum_series("chain_jobs_planned_total", None) or 0.0

    assert port_main(["p03", "-c", ty, "--store", store], device="cpu") == 0
    before = planned()
    assert port_main(["p03", "-c", ty, "--store", store], device="cpu") == 0
    assert port_main(["p04", "-c", ty, "--store", store], device="cpu") == 0
    assert planned() - before == 0
    active = truntime.active()
    tc = TTestConfig(ty)
    job = tcp.create_cpvs(tc.pvses[PVSES[0]], tc.post_processings[0], device="cpu")
    manifest = active.lookup(active.plan_hash(job.plan))
    assert manifest is not None
    obj = active.object_path(manifest.object["sha256"])
    os.chmod(obj, 0o644)
    with open(obj, "r+b") as f:
        f.write(b"\x00" * 16)
    before = planned()
    assert port_main(["p03", "-c", ty, "--store", store], device="cpu") == 0
    assert port_main(["p04", "-c", ty, "--store", store], device="cpu") == 0
    assert planned() - before == 1


def test_freeze_pvs_fuses_where_the_jax_fanout_raises(short_db, tmp_path, main_log):
    """A frame-freeze PVS: the JAX FusedFanout cannot build its stall
    member (its apply_stalling reads bare durations as pairs, ROADMAP
    Queue C); the port's fused p03 gives the frozen AVPVS and the PC CPVS
    its staged route gives, with one decode."""
    ty, staged = _copy(short_db, tmp_path / "t"), _copy(short_db, tmp_path / "s")
    pvs_id = _add_freeze(ty, "short")
    assert _add_freeze(staged, "short") == pvs_id
    with pytest.raises(TypeError):
        jfused.FusedFanout(JTestConfig(ty).pvses[pvs_id], spinner_path=None)
    assert port_main(["p03", "-c", staged, "--filter-pvs", pvs_id], device="cpu") == 0
    assert port_main(["p04", "-c", staged, "--filter-pvs", pvs_id], device="cpu") == 0
    main_log.clear()
    os.environ["PC_FUSE_P04"] = "1"
    try:
        assert port_main(["p03", "-c", ty, "--filter-pvs", pvs_id], device="cpu") == 0
    finally:
        os.environ.pop("PC_FUSE_P04", None)
    summary = _summary(main_log, "p03")
    assert summary["decoder_opens"] == {"render": 1, "stall": 0}
    assert summary["fused"] == {"fanouts": 1, "members": 2, "degraded": 0}
    pvs = TTestConfig(ty).pvses[pvs_id]
    for out in (pvs.get_avpvs_file_path(), pvs.get_cpvs_file_path(context="pc")):
        rel = os.path.relpath(out, os.path.dirname(ty))
        _assert_decoded_equal(os.path.join(os.path.dirname(staged), rel), out)
    assert tfused.FusedFanout(pvs, device="cpu").stall_job.plan["events"] == \
        [[0.0, 0.25], [0.25, 0.5]]


def test_fused_long_single_device_with_audio_resample_and_preview(
        long_db, tmp_path, jax_like_port):
    """The long test through the model layer (tests/test_fused.py's long
    case) with its PC context at 30 fps against the 60 fps canvas and the
    preview: the stalled AVPVS (silence inserted) and the PC CPVS
    (normalised audio) decode identical to the port's staged route and to
    the JAX fan-out's; the preview takes the staged encoder input and
    decodes within PSNR_FLOOR, with its AAC audio close."""
    copies = {}
    for tag in ("staged", "fused", "jax"):
        y = _copy(long_db, tmp_path / tag)
        with open(y) as f:
            text = f.read()
        with open(y, "w") as f:
            f.write(text.replace("displayFrameRate: 24", "displayFrameRate: 30"))
        copies[tag] = y
    assert port_main(["p03", "-c", copies["staged"]], device="cpu") == 0
    with EncoderInput() as enc:
        assert port_main(["p04", "-c", copies["staged"], "-e"], device="cpu") == 0
        tpvs = TTestConfig(copies["fused"]).pvses[LONG_PVS]
        fanout = tfused.FusedFanout(tpvs, spinner_path=_DEFAULT_SPINNER, preview=True,
                                    device="cpu")
        tav.create_avpvs_wo_buffer(tpvs, device="cpu", fanout=fanout).run()
        assert fanout.engaged and not fanout.degraded
        from processing_chain_tpu.utils.parse_args import _DEFAULT_SPINNER as jspinner

        jpvs = JTestConfig(copies["jax"]).pvses[LONG_PVS]
        jfan = jfused.FusedFanout(jpvs, spinner_path=jspinner, preview=True)
        jav.create_avpvs_wo_buffer(jpvs, fanout=jfan).run()
    outs = {"stalled": tpvs.get_avpvs_file_path(), "cpvs": tpvs.get_cpvs_file_path(context="pc"),
            "preview": tpvs.get_preview_file_path()}
    assert len(_decoded(outs["cpvs"])[1]) == 75  # 2.5 s at 30 fps
    for key, out in outs.items():
        rel = os.path.relpath(out, os.path.dirname(copies["fused"]))
        others = [os.path.join(os.path.dirname(copies[t]), rel) for t in ("staged", "jax")]
        if key != "preview":
            for ref in others:
                _assert_decoded_equal(ref, out)
            continue
        for ref in others:
            assert enc.digest(out) == enc.digest(ref)
            for x, y in zip(_decoded(out)[0], _decoded(ref)[0]):
                assert _psnr(x, y, 1023.0) >= PSNR_FLOOR
            a, b = jml.decode_audio_s16(out), jml.decode_audio_s16(ref)
            assert a[1] == b[1] and a[0].shape == b[0].shape
            assert float(np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).mean()) < 50.0


def test_fused_p03_lifts_the_pc_chroma_once_a_chunk(short_db, tmp_path, monkeypatch):
    """Each fused stream chunk goes through the PC context's 420->422 lift
    once (two resize calls, U and V), beside the canvas resize's three:
    the per-chunk counts the card holds the kernel launches to."""
    from processing_chain_tpu_torch.ops import pixfmt as tpf
    from processing_chain_tpu_torch.ops import resize as tresize

    ty = _copy(short_db, tmp_path / "t")
    calls = []

    def counting(orig):
        def resize_plane(x, dst_h, dst_w, kernel="lanczos", *args, **kwargs):
            calls.append((tuple(x.shape), dst_h, dst_w, kernel))
            return orig(x, dst_h, dst_w, kernel, *args, **kwargs)
        return resize_plane

    monkeypatch.setattr(tresize, "resize_plane", counting(tresize.resize_plane))
    monkeypatch.setattr(tpf, "resize_plane", counting(tpf.resize_plane))
    monkeypatch.setenv("PC_FUSE_P04", "1")
    monkeypatch.setenv("PC_CHUNK_FRAMES", "16")
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0]], device="cpu") == 0
    canvas = [c for c in calls if c[3] == "bicubic"]
    lift = [c for c in calls if c[3] == "bilinear"]
    assert len(canvas) == 3 * 3 and len(lift) == 2 * 3  # 48 frames in 16-frame chunks


def test_bufferer_calibrate_equals_jax_on_a_port_stall_render(short_db, tmp_path):
    """estimate_spinner_rps and the calibration report of both packages
    over a stalled AVPVS the port's stall pass rendered."""
    ty = _copy(short_db, tmp_path / "t")
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[2]], device="cpu") == 0
    pvs = TTestConfig(ty).pvses[PVSES[2]]
    events = pvs.get_buff_events_media_time()
    assert len(events) == 1
    out = pvs.get_avpvs_file_path()
    n_in = len(_decoded(pvs.get_avpvs_wo_buffer_file_path())[1])
    luma = _decoded(out)[0][0]
    plan = tov.plan_stalling(n_in, 24.0, events)
    stall = luma[np.flatnonzero(plan.stall_mask)[:12]]
    crop = stall[:, 45:135, 115:205]
    assert tov.estimate_spinner_rps(crop, 24.0) == jov.estimate_spinner_rps(crop, 24.0)
    want = jcal.calibrate(out, events, n_in)
    assert tcal.calibrate(out, events, n_in) == want
    assert want["insertion_matches_plan"] and len(want["events"]) == 1
    assert want["events"][0]["frames"] == 12 and "spinner_rps" in want["events"][0]
    assert tcal.main([out, "--events", json.dumps(events), "--input-frames", str(n_in)]) == 0
