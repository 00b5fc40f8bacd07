"""p04's file-level staged route in the port (models/cpvs.create_cpvs and
create_preview, stages/p04_generate_cpvs, cli `p04`) against the JAX
package's p04 stage on the CPU, over the short-test and long-test
databases tests/test_torch_p03_file.py builds (their AVPVS rendered by
the JAX p03), with a tablet and a mobile context added to the short one.

Lossless outputs (the PC context's rawvideo UYVY422, `-a` passthrough and
10-bit v210) must decode identical. libx264 and prores_ks streams are not
pinned, so the x264 contexts and the ProRes preview are held by the sha1
of the planes each writer is handed (the encoder input) and by the PSNR
of the decoded files. The JAX reference takes the route the port's resize
takes: its Pallas kernel in interpret mode (PC_RESIZE_METHOD=fused) for
the u8 bilinear 420->422 lift of the PC context and the preview, its
default route for the tablet's u8 bicubic scale (tests/test_torch_cpvs.py).
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu.config import TestConfig as JTestConfig
from processing_chain_tpu.io import medialib as jml
from processing_chain_tpu.io import video as jvideo
from processing_chain_tpu.io.video import VideoWriter as JWriter
from processing_chain_tpu.models import cpvs as jcp
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from processing_chain_tpu_torch.io import video as tvideo
from processing_chain_tpu_torch.models import cpvs as tcp
from tests.test_pipeline_e2e import write_db
from tests.test_torch_p03_file import (  # noqa: F401  (fixtures)
    DB,
    LONG_PVS,
    PVSES,
    ROOT,
    SHORT_YAML,
    _decoded,
    _plans_agree,
    _writeback_env,
    long_db,
    main_log,
    short_db,
)

#: the two x264 contexts the short database gains: the tablet scales the
#: 320x180 AVPVS down (bicubic), the mobile letterboxes it (pad only)
CONTEXTS = (
    "  - {type: tablet, displayWidth: 256, displayHeight: 144, codingWidth: 256, "
    "codingHeight: 144}\n"
    "  - {type: mobile, displayWidth: 320, displayHeight: 240, codingWidth: 320, "
    "codingHeight: 180}\n"
)
#: PSNR floor (dB) of a decoded x264 or ProRes file: the JAX package's own
#: files decode at 48.4-51.5 dB (x264, CRF 17) and 65.4-67.3 dB (ProRes, on
#: the 10-bit scale) against the planes their encoders were handed (luma,
#: this database), so a port file at 45 dB from the JAX file is within the
#: codec's own loss
PSNR_FLOOR = 45.0


def _add_contexts(yaml_path: str) -> None:
    with open(yaml_path) as f:
        text = f.read()
    with open(yaml_path, "w") as f:
        f.write(text.rstrip("\n") + "\n" + CONTEXTS)


def _psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-12)))


class EncoderInput:
    """The planes each writer of both packages is handed, by output path:
    a sha1 over the bytes, and the luma stack."""

    def __init__(self) -> None:
        self.sha1, self.luma = {}, {}
        self._saved = []

    def __enter__(self):
        for cls in (jvideo.VideoWriter, tvideo.VideoWriter):
            orig = cls.write_batch

            def write_batch(writer, *planes, _orig=orig):
                h = self.sha1.setdefault(writer.path, hashlib.sha1())
                arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes]
                for a in arrs:
                    h.update(a.tobytes())
                self.luma.setdefault(writer.path, []).append(arrs[0].copy())
                return _orig(writer, *planes)

            self._saved.append((cls, orig))
            cls.write_batch = write_batch
        return self

    def __exit__(self, *exc):
        for cls, orig in self._saved:
            cls.write_batch = orig

    def digest(self, path: str) -> str:
        return self.sha1[path].hexdigest()

    def frames(self, path: str) -> np.ndarray:
        return np.concatenate(self.luma[path])


def _jax_p04(yaml_path: str, resize: str, *flags) -> None:
    """The JAX p04 stage on its single device with PC_RESIZE_METHOD=resize
    ("auto": unset), restored after."""
    saved = os.environ.pop("PC_RESIZE_METHOD", None)
    if resize != "auto":
        os.environ["PC_RESIZE_METHOD"] = resize
    try:
        assert jax_main(["p04", "-c", yaml_path, "--skip-requirements", "-g", "0",
                         *flags]) == 0
    finally:
        if saved is None:
            os.environ.pop("PC_RESIZE_METHOD", None)
        else:
            os.environ["PC_RESIZE_METHOD"] = saved


def _with_avpvs(yaml_path: str, dest) -> str:
    """A copy of a database whose AVPVS the JAX p03 rendered."""
    y = _fresh_copy(yaml_path, dest)
    for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
        os.environ[name] = "2"
    try:
        assert jax_main(["p03", "-c", y, "--skip-requirements", "-g", "0"]) == 0
    finally:
        for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
            os.environ.pop(name, None)
    return y


@pytest.fixture(scope="module")
def short_avpvs(short_db, tmp_path_factory):
    return _with_avpvs(short_db, tmp_path_factory.mktemp("p04shortavpvs"))


@pytest.fixture(scope="module")
def long_avpvs(long_db, tmp_path_factory):
    return _with_avpvs(long_db, tmp_path_factory.mktemp("p04longavpvs"))


def _fresh_copy(yaml_path: str, dest) -> str:
    """A copy of a database with its AVPVS and no CPVS."""
    folder = os.path.dirname(yaml_path)
    shutil.copytree(folder, dest / os.path.basename(folder))
    y = str(dest / os.path.basename(folder) / os.path.basename(yaml_path))
    shutil.rmtree(os.path.join(os.path.dirname(y), "cpvs"), ignore_errors=True)
    os.makedirs(os.path.join(os.path.dirname(y), "cpvs"))
    return y


@pytest.fixture(scope="module")
def short_runs(short_avpvs, tmp_path_factory):
    """The short database with the tablet and mobile contexts, through the
    JAX p04 stage (the Pallas route for the PC context and the preview,
    the default route for the x264 contexts) and the port's p04 CLI on the
    CPU, each on its own copy, all with --lightweight-preview; the encoder
    input of every writer recorded."""
    tmp = tmp_path_factory.mktemp("p04short")
    for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
        os.environ[name] = "2"
    copies = {tag: _fresh_copy(short_avpvs, tmp / tag) for tag in ("fused", "auto", "port")}
    for y in copies.values():
        _add_contexts(y)
    try:
        with EncoderInput() as enc:
            _jax_p04(copies["fused"], "fused", "-e")
            _jax_p04(copies["auto"], "auto", "-e")
            assert port_main(["p04", "-c", copies["port"], "-e"], device="cpu") == 0
    finally:
        for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
            os.environ.pop(name, None)
    return {"copies": copies, "enc": enc,
            "dirs": {k: os.path.join(os.path.dirname(y), "cpvs") for k, y in copies.items()}}


#: the JAX run each output is held against
REFERENCE_RUN = {"PC.avi": "fused", "preview.mov": "fused", "TA.mp4": "auto",
                 "MO.mp4": "fused"}


def test_p04_main_writes_the_jax_set_of_outputs(short_runs):
    names = sorted(os.listdir(short_runs["dirs"]["port"]))
    assert names == sorted(os.listdir(short_runs["dirs"]["fused"]))
    assert len(names) == 3 * 4  # three PVSes x (pc, tablet, mobile, preview)


@pytest.mark.parametrize("pvs_id", PVSES)
def test_pc_uyvy_cpvs_decodes_identical(short_runs, pvs_id):
    name = f"{pvs_id}_PC.avi"
    ours = os.path.join(short_runs["dirs"]["port"], name)
    (a, pa), (b, pb) = _decoded(ours), _decoded(os.path.join(short_runs["dirs"]["fused"], name))
    assert pa == pb and len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    video = [s for s in jml.probe(ours)["streams"] if s["codec_type"] == "video"]
    assert (video[0]["codec_name"], video[0]["pix_fmt"]) == ("rawvideo", "uyvy422")
    with pytest.raises(jml.MediaError):
        jml.decode_audio_s16(ours)  # a short test's CPVS carries no audio
    enc = short_runs["enc"]
    assert enc.digest(ours) == enc.digest(os.path.join(short_runs["dirs"]["fused"], name))


@pytest.mark.parametrize("suffix", ["TA.mp4", "MO.mp4", "preview.mov"])
@pytest.mark.parametrize("pvs_id", PVSES)
def test_lossy_outputs_take_the_jax_encoder_input(short_runs, pvs_id, suffix):
    """The x264 contexts and the ProRes preview: the encoder of each
    package is handed the same bytes; the decoded files agree within
    PSNR_FLOOR, which the JAX file meets against its own encoder input."""
    name = f"{pvs_id}_{suffix}"
    enc = short_runs["enc"]
    ref_path = os.path.join(short_runs["dirs"][REFERENCE_RUN[suffix]], name)
    our_path = os.path.join(short_runs["dirs"]["port"], name)
    assert enc.digest(our_path) == enc.digest(ref_path)
    peak = 1023.0 if suffix == "preview.mov" else 255.0
    ours, ref = _decoded(our_path)[0], _decoded(ref_path)[0]
    assert len(ours) == len(ref) == 3
    assert _psnr(ref[0], enc.frames(ref_path), peak) >= PSNR_FLOOR
    for x, y in zip(ours, ref):
        assert _psnr(x, y, peak) >= PSNR_FLOOR
    codec = [s for s in jml.probe(os.path.join(short_runs["dirs"]["port"], name))["streams"]
             if s["codec_type"] == "video"][0]
    if suffix == "preview.mov":
        assert (codec["codec_name"], codec["pix_fmt"]) == ("prores", "yuv422p10le")
    else:
        assert codec["codec_name"] == "h264"
        assert (codec["width"], codec["height"]) == ((256, 144) if suffix == "TA.mp4"
                                                      else (320, 240))


@pytest.mark.parametrize("rawvideo", [False, True])
@pytest.mark.parametrize("pvs_id", PVSES[:2])
def test_create_cpvs_jobs_equal_jax(short_avpvs, tmp_path, pvs_id, rawvideo, monkeypatch):
    """The PC job of each package on its own copy: equal labels, output
    names and provenance, plans equal but for the resize identity, and
    the CPVS decoded identical (`-a` passes the AVPVS's yuv420p through
    into MKV)."""
    jy, ty = _fresh_copy(short_avpvs, tmp_path / "j"), _fresh_copy(short_avpvs, tmp_path / "t")
    jpvs, tpvs = JTestConfig(jy).pvses[pvs_id], TTestConfig(ty).pvses[pvs_id]
    jjob = jcp.create_cpvs(jpvs, jpvs.test_config.post_processings[0], rawvideo=rawvideo)
    tjob = tcp.create_cpvs(tpvs, tpvs.test_config.post_processings[0], rawvideo=rawvideo,
                           device="cpu")
    assert tjob.label == jjob.label and tjob.provenance == jjob.provenance
    assert os.path.basename(tjob.output_path) == os.path.basename(jjob.output_path)
    _plans_agree(jjob.plan, tjob.plan)
    jprev, tprev = jcp.create_preview(jpvs), tcp.create_preview(tpvs, device="cpu")
    assert tprev.plan["codec"] == jprev.plan["codec"] and tprev.provenance == jprev.provenance
    monkeypatch.setenv("PC_RESIZE_METHOD", "fused")  # read by the JAX render only
    jjob.run()
    tjob.run()
    (a, pa), (b, pb) = _decoded(jjob.output_path), _decoded(tjob.output_path)
    assert pa == pb
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if rawvideo:
        assert tjob.output_path.endswith(".mkv")
        assert [s["pix_fmt"] for s in jml.probe(tjob.output_path)["streams"]] == ["yuv420p"]


@pytest.fixture(scope="module")
def ten_bit_db(tmp_path_factory):
    """A 10-bit short test (its segment written as FFV1 through the JAX
    VideoWriter, as tests/test_torch_p03_file.py's 10-bit test does), its
    AVPVS rendered by the JAX p03."""
    tmp = tmp_path_factory.mktemp("p04tenbit")
    yaml_path = write_db(tmp, "P2SXM91", SHORT_YAML.replace(DB, "P2SXM91"),
                         {"SRC000.avi": dict(n=48, ten_bit=True)})
    pvs = JTestConfig(yaml_path).pvses["P2SXM91_SRC000_HRC001"]
    seg = pvs.segments[0]
    os.makedirs(os.path.dirname(seg.file_path), exist_ok=True)
    stacks, _ = _decoded(pvs.src.file_path)
    tmp_avi = seg.file_path + ".avi"
    with JWriter(tmp_avi, "ffv1", 320, 180, "yuv420p10le", (24, 1)) as w:
        for k in range(stacks[0].shape[0]):
            w.write(*(p[k] for p in stacks))
    os.replace(tmp_avi, seg.file_path)
    for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
        os.environ[name] = "2"
    try:
        assert jax_main(["p03", "-c", yaml_path, "--skip-requirements", "-g", "0",
                         "--filter-pvs", pvs.pvs_id]) == 0
    finally:
        for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS"):
            os.environ.pop(name, None)
    return yaml_path, pvs.pvs_id


def test_ten_bit_v210_cpvs_decodes_identical(ten_bit_db, tmp_path, main_log):
    """The 10-bit PC context: v210 from planar yuv422p10le in both
    packages, decoded identical; the port's summary counts one render and
    one decoder open."""
    yaml_path, pvs_id = ten_bit_db
    jy, ty = _fresh_copy(yaml_path, tmp_path / "j"), _fresh_copy(yaml_path, tmp_path / "t")
    _jax_p04(jy, "fused", "--filter-pvs", pvs_id)
    assert port_main(["p04", "-c", ty, "--filter-pvs", pvs_id], device="cpu") == 0
    name = f"{pvs_id}_PC.avi"
    ours = os.path.join(os.path.dirname(ty), "cpvs", name)
    (a, pa), (b, pb) = _decoded(ours), _decoded(os.path.join(os.path.dirname(jy), "cpvs", name))
    assert pa == pb and len(pa) == 48
    for x, y in zip(a, b):
        assert x.dtype == np.uint16
        np.testing.assert_array_equal(x, y)
    assert [s["codec_name"] for s in jml.probe(ours)["streams"]] == ["v210"]
    summary = _summary(main_log)
    assert (summary["renders"], summary["decoder_opens"], summary["frames"]) == (1, 1, 48)
    assert summary["bufpool"]["outstanding"] == 0


def _summary(main_log) -> dict:
    import json

    lines = [r.getMessage() for r in main_log.records if "p04 summary: " in r.getMessage()]
    assert len(lines) == 1, lines
    return json.loads(lines[0].split("p04 summary: ", 1)[1])


def test_long_cpvs_and_its_audio_equal_jax(long_avpvs, tmp_path, main_log):
    """The long test's PC CPVS: decoded identical to the JAX stage's, its
    pcm audio the AVPVS audio trimmed to the HRC's duration and
    RMS-normalised, array-equal to the JAX package's; the job plans
    agree with the `-t` cap recorded."""
    jy, ty = _fresh_copy(long_avpvs, tmp_path / "j"), _fresh_copy(long_avpvs, tmp_path / "t")
    _jax_p04(jy, "fused")
    assert port_main(["p04", "-c", ty], device="cpu") == 0
    name = f"{LONG_PVS}_PC.avi"
    jpath, tpath = (os.path.join(os.path.dirname(y), "cpvs", name) for y in (jy, ty))
    (a, pa), (b, pb) = _decoded(tpath), _decoded(jpath)
    assert pa == pb
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    (sa, ra), (sb, rb) = jml.decode_audio_s16(tpath), jml.decode_audio_s16(jpath)
    assert ra == rb
    np.testing.assert_array_equal(sa, sb)
    tpvs = TTestConfig(ty).pvses[LONG_PVS]
    raw, rate = jml.decode_audio_s16(tpvs.get_avpvs_file_path())
    want = tcp.trim_normalize_long_audio(raw, rate, tpvs, normalize=True)
    np.testing.assert_array_equal(sa, want)
    jpvs = JTestConfig(jy).pvses[LONG_PVS]
    np.testing.assert_array_equal(
        want, jcp.trim_normalize_long_audio(raw, rate, jpvs, normalize=True))
    tjob = tcp.create_cpvs(tpvs, tpvs.test_config.post_processings[0], device="cpu")
    jjob = jcp.create_cpvs(jpvs, jpvs.test_config.post_processings[0])
    _plans_agree(jjob.plan, tjob.plan)
    assert tjob.plan["t"] == 2.5
    assert _summary(main_log)["renders"] == 1


@pytest.mark.parametrize("case", ["ok", "missing_avpvs", "bad_flags", "cards"])
def test_p04_exit_codes(short_avpvs, tmp_path, monkeypatch, main_log, case):
    """0 on a run, also when several cards are visible without -g (p04
    has no batch route: it renders on the default device, as the JAX
    stage does); 1 when an AVPVS is missing (the failed job named); 2 on
    a flag p04 does not have."""
    ty = _fresh_copy(short_avpvs, tmp_path / "t")
    args = ["p04", "-c", ty, "--filter-pvs", PVSES[0]]
    if case == "missing_avpvs":
        os.unlink(os.path.join(os.path.dirname(ty), "avpvs", f"{PVSES[0]}.avi"))
        assert port_main(args, device="cpu") == 1
        assert any(PVSES[0] in r.getMessage() for r in main_log.records
                   if r.levelname == "ERROR")
    elif case == "bad_flags":
        with pytest.raises(SystemExit) as exc:
            port_main(args + ["--force-60-fps"], device="cpu")
        assert exc.value.code == 2
    else:
        if case == "cards":
            from processing_chain_tpu_torch.utils import device as tdevice

            monkeypatch.setattr(tdevice, "device_count", lambda: 2)
        assert port_main(args, device="cpu") == 0
        assert os.listdir(os.path.join(os.path.dirname(ty), "cpvs")) == [f"{PVSES[0]}_PC.avi"]
        assert not any("item 7" in r.getMessage() for r in main_log.records)
    if case not in ("ok", "cards"):
        assert os.listdir(os.path.join(os.path.dirname(ty), "cpvs")) == []


def test_p04_process_imports_no_jax(short_avpvs, tmp_path):
    """A p04 run of the port, as a process on the CPU, imports no jax and
    nothing of the JAX package."""
    ty = _fresh_copy(short_avpvs, tmp_path / "t")
    code = ("import sys\n"
            "from processing_chain_tpu_torch.cli import main\n"
            f"assert main(['p04', '-c', {ty!r}, '--filter-pvs', {PVSES[2]!r}, '-e'],"
            " device='cpu') == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'processing_chain_tpu')]\n"
            "print('FORBIDDEN', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout
    assert sorted(os.listdir(os.path.join(os.path.dirname(ty), "cpvs"))) == [
        f"{PVSES[2]}_PC.avi", f"{PVSES[2]}_preview.mov"]
