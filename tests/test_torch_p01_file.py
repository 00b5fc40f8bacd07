"""p01's file path in the port (models/segments.encode_segment,
stages/p01_generate_segments, cli `p01`) against the JAX p01 on the CPU:
the same database in two copies, one encoded by each package, for libx264,
libx265, libvpx-vp9 and libaom-av1, each with one-pass bitrate, two-pass
bitrate, CRF and QP rate control (libvpx-vp9 has no QP form in the
reference), plus the fps drop, a 10-bit target, long-test audio, the
nvenc substitution and the online segments.

What is held equal: the planes each writer is handed (a sha1 of each plane
of each frame, pass 1 and pass 2 alike), the jobs' plans with the resize
identity aligned, the provenance, the statistics files, and the segment
bytes where the JAX package is shown to give the same bytes twice. libx264
is held by its decoded frames against the JAX segment instead (x264
streams are nondeterministic, ROADMAP Queue C).
"""

import hashlib
import logging
import os
import shutil
import textwrap

import numpy as np
import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu.config import StaticProber as JProber
from processing_chain_tpu.config import TestConfig as JTestConfig
from processing_chain_tpu.io import video as jvideo
from processing_chain_tpu.io.video import VideoReader as JReader
from processing_chain_tpu.models import segments as jseg
from processing_chain_tpu.store import keys as jkeys
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import StaticProber as TProber
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from processing_chain_tpu_torch.io import video as tvideo
from processing_chain_tpu_torch.models import segments as tseg
from processing_chain_tpu_torch.store import keys as tkeys
from tests.test_pipeline_e2e import luma_psnr, write_db

DB = "P2SXM92"
#: encoder -> (video codec, the codings its database carries)
ENCODERS = {
    "libx264": ("h264", ("VC01", "VC02", "VC03", "VC04")),
    "libx265": ("h265", ("VC01", "VC02", "VC03", "VC04")),
    "libvpx-vp9": ("vp9", ("VC01", "VC02", "VC03")),
    "libaom-av1": ("av1", ("VC01", "VC02", "VC03", "VC04")),
}
#: coding -> (its fields, the quality level it encodes)
CODINGS = {
    "VC01": ("passes: 1", "Q0"),
    "VC02": ("passes: 2", "Q0"),
    "VC03": ("crf: yes", "Q1"),
    "VC04": ("qp: yes", "Q1"),
}
EXTRA = {
    "libx264": ", preset: ultrafast",
    "libx265": ", preset: ultrafast",
    "libvpx-vp9": ", speed: 4",
    "libaom-av1": ", cpuUsed: 8",
}
#: the x264 segments decode at >= 60 dB against the JAX segment of the same
#: input (the same encoder on the same planes); the floor sits far above
#: what a different input would give at these rates (~30 dB)
X264_PSNR_FLOOR = 50.0


def _yaml(encoder: str) -> str:
    codec, codings = ENCODERS[encoder]
    lines = [
        f"databaseId: {DB}", "syntaxVersion: 6", "type: short",
        "qualityLevelList:",
        f"  Q0: {{index: 0, videoCodec: {codec}, videoBitrate: 150, width: 160, height: 90, fps: 24}}",
        f"  Q1: {{index: 1, videoCodec: {codec}, videoCrf: 32, videoQp: 32, width: 160, height: 90, "
        "fps: 24}",
        "codingList:",
    ]
    for vc in codings:
        lines.append(f"  {vc}: {{type: video, encoder: {encoder}, {CODINGS[vc][0]}, "
                     f"iFrameInterval: 1{EXTRA[encoder]}}}")
    lines += ["srcList:", "  SRC000: SRC000.avi", "hrcList:"]
    for k, vc in enumerate(codings):
        lines.append(f"  HRC00{k}: {{videoCodingId: {vc}, eventList: [[{CODINGS[vc][1]}, 1]]}}")
    lines.append("pvsList:")
    lines += [f"  - {DB}_SRC000_HRC00{k}" for k in range(len(codings))]
    lines += ["postProcessingList:",
              "  - {type: pc, displayWidth: 160, displayHeight: 90, codingWidth: 160, "
              "codingHeight: 90, displayFrameRate: 24}"]
    return "\n".join(lines) + "\n"


class EncoderInput:
    """The planes every writer of both packages is handed, by output path:
    a sha1 of each plane of each frame, and the luma planes themselves."""

    def __init__(self) -> None:
        self.frames: dict = {}
        self.luma: dict = {}
        self._saved = []

    def __enter__(self):
        for cls in (jvideo.VideoWriter, tvideo.VideoWriter):
            batch, single = cls.write_batch, cls.write

            def write_batch(writer, *planes, _orig=batch):
                arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes]
                rows = self.frames.setdefault(writer.path, [])
                for i in range(arrs[0].shape[0]):
                    rows.append(tuple(hashlib.sha1(a[i].tobytes()).hexdigest() for a in arrs))
                self.luma.setdefault(writer.path, []).extend(arrs[0].copy())
                return _orig(writer, *planes)

            def write(writer, *planes, _orig=single):
                arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes]
                self.frames.setdefault(writer.path, []).append(tuple(
                    hashlib.sha1(a.tobytes()).hexdigest() for a in arrs))
                self.luma.setdefault(writer.path, []).append(arrs[0].copy())
                return _orig(writer, *planes)

            self._saved.append((cls, batch, single))
            cls.write_batch, cls.write = write_batch, write
        return self

    def __exit__(self, *exc):
        for cls, batch, single in self._saved:
            cls.write_batch, cls.write = batch, single

    def under(self, folder: str, luma: bool = False) -> dict:
        """{path relative to `folder`: per-frame plane sha1s}, or with
        `luma` the stacked luma planes."""
        src = self.luma if luma else self.frames
        return {os.path.relpath(p, folder): np.stack(v) if luma else v
                for p, v in src.items() if p.startswith(folder + os.sep)}


def _copy(folder: str, dest) -> str:
    shutil.copytree(folder, dest / DB)
    return str(dest / DB / f"{DB}.yaml")


def _files(yaml_path: str, sub: str) -> dict:
    folder = os.path.join(os.path.dirname(yaml_path), sub)
    return {n: open(os.path.join(folder, n), "rb").read() for n in sorted(os.listdir(folder))}


def _decoded(path: str) -> list:
    with JReader(path) as r:
        stacks, _ = r.read_all()
    return stacks


def _run_both(yaml_path: str, tmp, *flags, jax_env=None) -> dict:
    """The JAX p01 twice (two copies) and the port's p01 once (a third),
    under one encoder-input recorder: {"j1", "j2", "t": yaml paths,
    "inputs": {tag: {relative path: rows}}}."""
    folder = os.path.dirname(yaml_path)
    out = {tag: _copy(folder, tmp / tag) for tag in ("j1", "j2", "t")}
    saved = {k: os.environ.get(k) for k in (jax_env or {})}
    with EncoderInput() as rec:
        os.environ.update(jax_env or {})
        try:
            for tag in ("j1", "j2"):
                assert jax_main(["p01", "-c", out[tag], "--skip-requirements", *flags]) == 0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert port_main(["p01", "-c", out["t"], "--skip-requirements", *flags],
                         device="cpu") == 0
    out["inputs"] = {tag: rec.under(os.path.dirname(out[tag])) for tag in ("j1", "j2", "t")}
    out["luma"] = {tag: rec.under(os.path.dirname(out[tag]), luma=True) for tag in ("j1", "t")}
    return out


@pytest.fixture(scope="module")
def encoded(request, tmp_path_factory):
    """One database an encoder (the indirect parameter), encoded by both
    packages."""
    encoder = request.param
    tmp = tmp_path_factory.mktemp(encoder)
    yaml_path = write_db(tmp / "src", DB, _yaml(encoder), {"SRC000.avi": dict(n=48, audio=True)})
    return encoder, _run_both(yaml_path, tmp)


#: (encoder, coding) of every coding an encoder's database carries
CASES = [(e, vc) for e in sorted(ENCODERS) for vc in ENCODERS[e][1]]


def _segment_name(yaml_path: str, vc: str) -> str:
    names = [n for n in os.listdir(os.path.join(os.path.dirname(yaml_path), "videoSegments"))
             if f"_{vc}_" in n]
    assert len(names) == 1, names
    return names[0]


@pytest.mark.parametrize("encoded,vc", CASES, indirect=["encoded"])
def test_encoder_input_equals_jax(encoded, vc):
    """Each pass's writer is handed the same planes, frame by frame, in
    both packages; a two-pass coding hands them twice (two decodes)."""
    _, out = encoded
    name = _segment_name(out["t"], vc)
    got = {p: rows for p, rows in out["inputs"]["t"].items() if name in p}
    want = {p: rows for p, rows in out["inputs"]["j1"].items() if name in p}
    passes = 2 if vc == "VC02" else 1
    assert sorted(got) == sorted(want) and len(got) == passes
    for path in got:
        assert got[path] == want[path] and len(got[path]) == 24, path


@pytest.mark.parametrize("encoded,vc", CASES, indirect=["encoded"])
def test_segment_equals_jax(encoded, vc):
    """Segment bytes equal the JAX segment's where the JAX package gives the
    same bytes twice (libx265, libvpx-vp9 and libaom-av1 here, shown first);
    libx264's decode within X264_PSNR_FLOOR of the JAX segment. No pass-1
    temporary is left."""
    encoder, out = encoded
    name = _segment_name(out["t"], vc)
    seg = {tag: _files(out[tag], "videoSegments") for tag in ("j1", "j2", "t")}
    for tag in seg:
        assert not [n for n in seg[tag] if ".pass1.tmp" in n], (tag, sorted(seg[tag]))
    if encoder == "libx264":
        a = _decoded(os.path.join(os.path.dirname(out["t"]), "videoSegments", name))
        b = _decoded(os.path.join(os.path.dirname(out["j1"]), "videoSegments", name))
        assert [p.shape for p in a] == [p.shape for p in b]
        assert a[0].shape[0] == 24
        assert luma_psnr(a[0], b[0]) >= X264_PSNR_FLOOR
        return
    assert seg["j1"][name] == seg["j2"][name]  # the JAX package is deterministic here
    assert seg["t"][name] == seg["j1"][name]


@pytest.mark.parametrize("encoded", sorted(ENCODERS), indirect=True)
def test_statistics_files_equal_jax(encoded):
    """The two-pass coding's statistics under logs/ (x264's own file, x265's
    pair through x265-params, libvpx/libaom's collected stats_out) carry
    the JAX package's names and bytes; the per-segment logs too."""
    encoder, out = encoded
    stem = os.path.splitext(_segment_name(out["t"], "VC02"))[0]
    got, want = _files(out["t"], "logs"), _files(out["j1"], "logs")
    stats = sorted(n for n in got if n.startswith("passlogfile_"))
    assert stats == sorted(n for n in want if n.startswith("passlogfile_"))
    assert stats and all(stem in n for n in stats)
    assert sorted(got) == sorted(want)
    for n in stats:
        assert got[n], n
        if encoder != "libx264":
            assert got[n] == want[n], n


@pytest.mark.parametrize("encoded,vc", CASES, indirect=["encoded"])
def test_plan_and_provenance_equal_jax(encoded, vc):
    """The encode jobs' plans hash equal with the resize identity aligned
    ("torch-auto:cpu" against "auto:cpu"), and their provenance and labels
    are the JAX package's."""
    _, out = encoded
    name = _segment_name(out["t"], vc)
    jsegs = {s.filename: s for s in JTestConfig(out["j1"]).get_required_segments()}
    tsegs = {s.filename: s for s in TTestConfig(out["t"]).get_required_segments()}
    jjob = jseg.encode_segment(jsegs[name])
    tjob = tseg.encode_segment(tsegs[name], device="cpu")
    assert tjob.label == jjob.label and tjob.provenance == jjob.provenance
    assert jjob.plan["resize"] == "auto:cpu" and tjob.plan["resize"] == "torch-auto:cpu"
    assert tkeys.plan_hash({**tjob.plan, "resize": "auto:cpu"}, tkeys.hash_file) == \
        jkeys.plan_hash(jjob.plan, jkeys.hash_file)


# --- the encoder options over the reference oracle's sweep -------------------

SRC_INFO = {"width": 640, "height": 360, "pix_fmt": "yuv420p", "r_frame_rate": "24/1",
            "video_duration": 10.0}


def _sweep_yaml(case: int, rng) -> tuple[str, str]:
    """tests/test_reference_oracle.py::test_encode_parameters_randomized_sweep's
    draw for `case` (seed 31), plus enc_options on every third case."""
    db_id = f"P2SXM{80 + case}"
    encoder = str(rng.choice(["libx264", "libx265", "libvpx-vp9", "libaom-av1"]))
    codec = {"libx264": "h264", "libx265": "h265", "libvpx-vp9": "vp9", "libaom-av1": "av1"}[encoder]
    rc_mode = str(rng.choice(["bitrate", "crf", "qp"]))
    if encoder == "libvpx-vp9" and rc_mode == "qp":
        rc_mode = "crf"
    coding = [f"type: video, encoder: {encoder}"]
    ql_rate = f"videoBitrate: {int(rng.integers(150, 900))}"
    if rc_mode == "bitrate":
        coding.append(f"passes: {int(rng.choice([1, 2]))}")
    elif rc_mode == "crf":
        coding.append("crf: yes")
        ql_rate = f"videoCrf: {int(rng.integers(20, 36))}"
    else:
        coding.append("qp: yes")
        ql_rate = f"videoQp: {int(rng.integers(20, 36))}"
    if rng.random() < 0.7:
        coding.append(f"iFrameInterval: {int(rng.choice([1, 2]))}")
    if rng.random() < 0.5:
        coding.append(f"scenecut: {str(bool(rng.random() < 0.5)).lower()}")
    if encoder in ("libx264", "libx265"):
        coding.append(f"preset: {str(rng.choice(['ultrafast', 'fast']))}")
        if rng.random() < 0.4:
            coding.append(f"bframes: {int(rng.integers(0, 4))}")
    if rc_mode == "bitrate" and rng.random() < 0.5:
        coding.append(f"maxrateFactor: {float(rng.choice([1.5, 2.0]))}")
        coding.append(f"bufsizeFactor: {float(rng.choice([2.0, 3.0]))}")
    if encoder == "libvpx-vp9":
        coding.append(f"speed: {int(rng.integers(0, 5))}")
        coding.append(f"quality: {str(rng.choice(['good', 'best']))}")
    if encoder == "libaom-av1":
        coding.append(f"cpuUsed: {int(rng.integers(4, 9))}")
    if case % 3 == 0:
        coding.append('enc_options: "-tune zerolatency -g:v 48"' if case == 3
                      else 'enc_options: "-tune psnr -x264opts keyint=48:min-keyint=48"')
    return db_id, "\n".join([
        f"databaseId: {db_id}", "syntaxVersion: 6", "type: short",
        "qualityLevelList:",
        f"  Q0: {{index: 0, videoCodec: {codec}, {ql_rate}, width: 640, height: 360, fps: 24}}",
        "codingList:", f"  VC01: {{{', '.join(coding)}}}",
        "srcList:", "  SRC000: SRC000.avi",
        "hrcList:", "  HRC000: {videoCodingId: VC01, eventList: [[Q0, 6]]}",
        "pvsList:", f"  - {db_id}_SRC000_HRC000",
        "postProcessingList:",
        "  - {type: pc, displayWidth: 1280, displayHeight: 720, codingWidth: 1280, "
        "codingHeight: 720, displayFrameRate: 24}",
    ]) + "\n"


@pytest.mark.parametrize("case", range(10))
def test_rate_control_and_options_equal_jax(tmp_path, case):
    """`rate_control_kwargs` and `_encoder_opts` (each pass of a two-pass
    coding, with its stats path) equal the JAX package's over the
    reference oracle's seeded draw; an enc_options string the option
    translation refuses raises the same error in both."""
    rng = np.random.default_rng(31)
    for k in range(case + 1):
        db_id, text = _sweep_yaml(k, rng)
    folder = tmp_path / db_id
    (folder / "srcVid").mkdir(parents=True)
    (folder / "srcVid" / "SRC000.avi").write_bytes(b"")
    (folder / f"{db_id}.yaml").write_text(text)
    yaml_path = str(folder / f"{db_id}.yaml")
    jsegm = JTestConfig(yaml_path, prober=JProber({"SRC000.avi": SRC_INFO})).get_required_segments()
    tsegm = TTestConfig(yaml_path, prober=TProber({"SRC000.avi": SRC_INFO})).get_required_segments()
    [js], [ts] = sorted(jsegm), sorted(tsegm)
    assert tseg.rate_control_kwargs(ts) == jseg.rate_control_kwargs(js)
    passes = 2 if js.video_coding.passes == 2 else 1
    for p in range(1, passes + 1):
        try:
            want = jseg._encoder_opts(js, p, passes, "/logs/passlogfile_x")
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:30]):
                tseg._encoder_opts(ts, p, passes, "/logs/passlogfile_x")
            continue
        assert tseg._encoder_opts(ts, p, passes, "/logs/passlogfile_x") == want


# --- substitution, online segments, failures ---------------------------------

NVENC_YAML = textwrap.dedent(f"""\
    databaseId: {DB}
    syntaxVersion: 6
    type: short
    qualityLevelList:
      Q0: {{index: 0, videoCodec: h264, videoBitrate: 150, width: 160, height: 90, fps: 24}}
      Q1: {{index: 1, videoCodec: h264, videoBitrate: 250, width: 320, height: 180, fps: 24}}
    codingList:
      VC01: {{type: video, encoder: h264_nvenc, passes: 1, iFrameInterval: 1}}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000: {{videoCodingId: VC01, eventList: [[Q0, 1]]}}
      HRC001: {{videoCodingId: VC01, eventList: [[Q1, 1]]}}
    pvsList:
      - {DB}_SRC000_HRC000
      - {DB}_SRC000_HRC001
    postProcessingList:
      - {{type: pc, displayWidth: 320, displayHeight: 180, codingWidth: 320, codingHeight: 180, displayFrameRate: 24}}
""")


@pytest.fixture
def main_log(caplog):
    """caplog on the chain's "main" logger, which does not propagate."""
    logger = logging.getLogger("main")
    logger.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        logger.removeHandler(caplog.handler)


def test_nvenc_substitution_is_warned_once_a_run(tmp_path, main_log):
    """Two h264_nvenc segments: one warning a run (each run warns again),
    the substitute's provenance key on every segment, both as JAX."""
    yaml_path = write_db(tmp_path, DB, NVENC_YAML, {"SRC000.avi": dict(n=24)})
    for _ in range(2):
        assert port_main(["p01", "-c", yaml_path, "--skip-requirements", "-n"], device="cpu") == 0
    warned = [r for r in main_log.records if "substituting libx264" in r.getMessage()]
    assert len(warned) == 2 and "h264_nvenc" in warned[0].getMessage()
    jseg.reset_run_state()
    tseg.reset_run_state()
    jsegs = sorted(JTestConfig(yaml_path).get_required_segments())
    tsegs = sorted(TTestConfig(yaml_path).get_required_segments())
    for js, ts in zip(jsegs, tsegs):
        jjob, tjob = jseg.encode_segment(js), tseg.encode_segment(ts, device="cpu")
        assert tjob.provenance == jjob.provenance
        assert tjob.provenance["pipeline"]["encoder_requested"] == "h264_nvenc"
        assert tjob.plan["encoder"] == "libx264"


ONLINE_YAML = NVENC_YAML.replace(
    "VC01: {type: video, encoder: h264_nvenc, passes: 1, iFrameInterval: 1}",
    "VC01: {type: video, encoder: libx264, passes: 1, iFrameInterval: 1, preset: ultrafast}\n"
    "  VC02: {type: video, encoder: youtube, protocol: dash}").replace(
    "HRC001: {videoCodingId: VC01", "HRC001: {videoCodingId: VC02").replace(
    "videoCodec: h264, videoBitrate: 250", "videoCodec: vp9, videoBitrate: 250")


def test_online_segments_are_skipped_or_refused(tmp_path, main_log):
    """With -sos the online segment is skipped and the offline one encoded,
    as in the JAX package; without it the stage refuses at plan time,
    naming every online segment and ROADMAP Queue A item 9b, exit 1, and
    nothing is encoded. The run that encodes logs once that priors
    priming waits for ROADMAP Queue A item 4b."""
    yaml_path = write_db(tmp_path, DB, ONLINE_YAML, {"SRC000.avi": dict(n=24)})
    segs = os.path.join(os.path.dirname(yaml_path), "videoSegments")
    assert port_main(["p01", "-c", yaml_path, "--skip-requirements"], device="cpu") == 1
    refusal = [r.getMessage() for r in main_log.records if "item 9b" in r.getMessage()]
    assert len(refusal) == 1 and "_Q1_VC02_" in refusal[0] and "-sos" in refusal[0]
    assert not os.path.isdir(segs) or not os.listdir(segs)
    assert port_main(["p01", "-c", yaml_path, "--skip-requirements", "-sos"], device="cpu") == 0
    assert [n for n in os.listdir(segs)] == [f"{DB}_SRC000_Q0_VC01_0000_0-1.mp4"]
    assert any("Skipping online segment" in r.getMessage() for r in main_log.records)
    priming = [r.getMessage() for r in main_log.records if "priors priming" in r.getMessage()]
    assert len(priming) == 1 and "item 4b" in priming[0]


def test_failed_pass_two_leaves_no_temporary(tmp_path, monkeypatch):
    """A two-pass encode whose second pass fails leaves neither the pass-1
    temporary nor the segment (JAX :1436-1443's contract)."""
    yaml_path = write_db(tmp_path, DB, _yaml("libx264"), {"SRC000.avi": dict(n=24)})
    [seg] = [s for s in TTestConfig(yaml_path).get_required_segments() if "_VC02_" in s.filename]
    orig = tvideo.VideoWriter.__init__

    def failing(writer, path, *args, **kw):
        if kw.get("pass_num") == 2:
            raise tvideo.MediaError("injected pass-2 failure")
        return orig(writer, path, *args, **kw)

    monkeypatch.setattr(tvideo.VideoWriter, "__init__", failing)
    job = tseg.encode_segment(seg, device="cpu")
    with pytest.raises(tvideo.MediaError, match="injected"):
        job.fn()
    folder = os.path.dirname(seg.file_path)
    assert not [n for n in os.listdir(folder) if ".pass1.tmp" in n]
    assert not os.path.exists(seg.file_path)


# --- the fps drop, a 10-bit target, long-test audio --------------------------

FPS_YAML = textwrap.dedent(f"""\
    databaseId: {DB}
    syntaxVersion: 6
    type: short
    qualityLevelList:
      Q0: {{index: 0, videoCodec: h265, videoBitrate: 150, width: 160, height: 90, fps: 30}}
      Q1: {{index: 1, videoCodec: h265, videoBitrate: 250, width: 192, height: 108, fps: original}}
    codingList:
      VC01: {{type: video, encoder: libx265, passes: 2, iFrameInterval: 1, preset: ultrafast}}
      VC02: {{type: video, encoder: libx265, passes: 1, iFrameInterval: 1, preset: ultrafast, pixFmt: yuv420p10le}}
    srcList:
      SRC000: SRC000.avi
      SRC001: SRC001.avi
    hrcList:
      HRC000: {{videoCodingId: VC01, eventList: [[Q0, 1]]}}
      HRC001: {{videoCodingId: VC02, eventList: [[Q1, 1]]}}
    pvsList:
      - {DB}_SRC000_HRC000
      - {DB}_SRC001_HRC001
    postProcessingList:
      - {{type: pc, displayWidth: 320, displayHeight: 180, codingWidth: 320, codingHeight: 180, displayFrameRate: 30}}
""")

LONG_YAML = textwrap.dedent(f"""\
    databaseId: {DB}
    syntaxVersion: 6
    type: long
    segmentDuration: 1
    qualityLevelList:
      Q0: {{index: 0, videoCodec: h264, videoBitrate: 200, width: 160, height: 90, fps: 24, audioCodec: aac, audioBitrate: 96}}
    codingList:
      VC01: {{type: video, encoder: libx264, passes: 2, iFrameInterval: 1, preset: ultrafast}}
      AC01: {{type: audio, encoder: aac}}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000: {{videoCodingId: VC01, audioCodingId: AC01, eventList: [[Q0, 1], [stall, 0.5], [Q0, 1]]}}
    pvsList:
      - {DB}_SRC000_HRC000
    postProcessingList:
      - {{type: pc, displayWidth: 320, displayHeight: 180, codingWidth: 320, codingHeight: 180, displayFrameRate: 24}}
""")


#: case -> (the PVS it encodes, the JAX run's environment, encodes)
FPS_CASES = {
    "drop": (f"{DB}_SRC000_HRC000", {}, 2),
    "ten_bit": (f"{DB}_SRC001_HRC001", {"PC_RESIZE_METHOD": "fused"}, 1),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_drop_and_ten_bit_target_equal_jax(tmp_path, case):
    """`drop`: a 60 fps SRC dropped to 30 fps before the scale (two-pass):
    the same planes and the same segment bytes. `ten_bit`: a 10-bit SRC
    kept at 10 bits through the u16 resize (yuv420p10le), against the JAX
    resize on its fused kernel: the u16 route is f32 arithmetic, not the
    golden integer path, so the luma is held to the JAX package's stated
    tolerance for it (ops/resize.py:464-473: at most one code value, on a
    few percent of the pixels), the flat chroma to equality."""
    pvs, env, n_files = FPS_CASES[case]
    yaml_path = write_db(tmp_path / "src", DB, FPS_YAML, {
        "SRC000.avi": dict(n=60, fps=60, audio=True),
        "SRC001.avi": dict(n=24, ten_bit=True)})
    out = _run_both(yaml_path, tmp_path, "--filter-pvs", pvs, jax_env=env)
    got, want = out["inputs"]["t"], out["inputs"]["j1"]
    assert sorted(got) == sorted(want) and len(got) == n_files
    seg = {tag: _files(out[tag], "videoSegments") for tag in ("j1", "j2", "t")}
    assert seg["j1"] == seg["j2"] and len(seg["t"]) == 1
    [name] = seg["t"]
    planes = _decoded(os.path.join(os.path.dirname(out["t"]), "videoSegments", name))
    for path in got:
        # 60 frames at 60 fps -> 30; the 10-bit SRC's 24 frames at 24 fps
        assert len(got[path]) == (30 if case == "drop" else 24)
        if case == "drop":
            assert got[path] == want[path], path
            continue
        assert [r[1:] for r in got[path]] == [r[1:] for r in want[path]], path
        a, b = out["luma"]["t"][path], out["luma"]["j1"][path]
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape == (24, 108, 192)
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff > 0) < 0.05, (diff.max(), np.mean(diff > 0))
    if case == "drop":
        assert seg["t"] == seg["j1"]
        assert planes[0].shape == (30, 90, 160)
    else:
        assert planes[0].dtype == np.uint16 and planes[0].max() > 255


def test_long_test_audio_equals_jax(tmp_path):
    """A long test's two segments with AAC audio from the SRC window
    (two-pass libx264, audio in pass 2 only): the same encoder input and
    the same decoded audio as the JAX segments."""
    from processing_chain_tpu.io import medialib as jml

    yaml_path = write_db(tmp_path / "src", DB, LONG_YAML, {"SRC000.avi": dict(n=72, audio=True)})
    out = _run_both(yaml_path, tmp_path)
    got, want = out["inputs"]["t"], out["inputs"]["j1"]
    assert sorted(got) == sorted(want) and len(got) == 4
    for path in got:
        assert got[path] == want[path], path
    for name in _files(out["t"], "videoSegments"):
        a = jml.decode_audio_s16(os.path.join(os.path.dirname(out["t"]), "videoSegments", name))
        b = jml.decode_audio_s16(os.path.join(os.path.dirname(out["j1"]), "videoSegments", name))
        assert a[1] == b[1] == 48000
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].shape[0] > 40000
