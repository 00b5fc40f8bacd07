"""p03's file-level single-device route in the port
(models/avpvs.create_avpvs_wo_buffer and apply_stalling,
stages/p03_generate_avpvs, cli `p03`), short and long tests, against the
JAX package's single-device route on the CPU: the same database, its
segments encoded by the JAX p01 with libx264 here, rendered by each
package into its own copy, the AVPVS decoded and compared. A frame-freeze
PVS, whose stall job the JAX package cannot build (ROADMAP Queue C), is
held against the JAX package's device half on the same wo_buffer file.

Every test that runs the stage restores PC_FFV1_WORKERS/PC_FFV1_THREADS:
the stage installs its pool-aware defaults into os.environ, which would
otherwise change what later tests in the same worker plan.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu.config import TestConfig as JTestConfig
from processing_chain_tpu.io import medialib as jml
from processing_chain_tpu.io.video import VideoReader as JReader
from processing_chain_tpu.io.video import VideoWriter as JWriter
from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu.store import keys as jkeys
from processing_chain_tpu_torch import telemetry as ttm
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.stages import p03_generate_avpvs as tstage
from processing_chain_tpu_torch.store import keys as tkeys
from tests.test_pipeline_e2e import write_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DB = "P2SXM90"
SHORT_YAML = textwrap.dedent("""\
    databaseId: P2SXM90
    syntaxVersion: 6
    type: short
    qualityLevelList:
      Q0: {index: 0, videoCodec: h264, videoBitrate: 200, width: 160, height: 90, fps: 24}
      Q1: {index: 1, videoCodec: h264, videoCrf: 28, width: 320, height: 180, fps: 24}
    codingList:
      VC01: {type: video, encoder: libx264, passes: 1, iFrameInterval: 1, preset: ultrafast}
      VC02: {type: video, encoder: libx264, crf: yes, iFrameInterval: 1, preset: ultrafast}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000:
        videoCodingId: VC01
        eventList: [[Q0, 2]]
      HRC001:
        videoCodingId: VC02
        eventList: [[Q1, 2]]
      HRC002:
        videoCodingId: VC01
        eventList: [[Q0, 2], [stall, 0.5]]
    pvsList:
      - P2SXM90_SRC000_HRC000
      - P2SXM90_SRC000_HRC001
      - P2SXM90_SRC000_HRC002
    postProcessingList:
      - {type: pc, displayWidth: 320, displayHeight: 180, codingWidth: 320, codingHeight: 180, displayFrameRate: 24}
""")
PVSES = [f"{DB}_SRC000_HRC00{k}" for k in range(3)]
#: the same database as a long test (tests/test_pipeline_e2e.py:244's shape):
#: two 1 s segments with AAC audio, a 0.5 s stall at the join
LONG_YAML = textwrap.dedent("""\
    databaseId: P2SXM90
    syntaxVersion: 6
    type: long
    segmentDuration: 1
    qualityLevelList:
      Q0: {index: 0, videoCodec: h264, videoBitrate: 200, width: 160, height: 90, fps: 24, audioCodec: aac, audioBitrate: 96}
    codingList:
      VC01: {type: video, encoder: libx264, passes: 1, iFrameInterval: 1, preset: ultrafast}
      AC01: {type: audio, encoder: aac}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000: {videoCodingId: VC01, audioCodingId: AC01, eventList: [[Q0, 1], [stall, 0.5], [Q0, 1]]}
    pvsList:
      - P2SXM90_SRC000_HRC000
    postProcessingList:
      - {type: pc, displayWidth: 320, displayHeight: 180, codingWidth: 320, codingHeight: 180, displayFrameRate: 24}
""")


@pytest.fixture(autouse=True)
def _writeback_env(monkeypatch):
    """The stage writes its writeback defaults into os.environ: restore
    them after each test, and start every test from the same unpinned
    state in both packages."""
    for name in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS", "PC_FFV1_SLICES", "PC_AVPVS_CODEC",
                 "PC_CHUNK_FRAMES", "PC_FUSE_P04", "PC_STORE_DIR", "PC_DECODE_WORKERS"):
        monkeypatch.delenv(name, raising=False)
    # set then removed by monkeypatch at teardown, whatever the stage wrote
    monkeypatch.setenv("PC_FFV1_WORKERS", "2")
    monkeypatch.setenv("PC_FFV1_THREADS", "2")


@pytest.fixture
def main_log(caplog):
    """caplog on the chain's "main" logger, which does not propagate."""
    import logging

    logger = logging.getLogger("main")
    logger.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        logger.removeHandler(caplog.handler)


def _summary(main_log) -> dict:
    """The p03 stage's summary line, parsed."""
    lines = [r.getMessage() for r in main_log.records if "p03 summary: " in r.getMessage()]
    assert len(lines) == 1, lines
    return json.loads(lines[0].split("p03 summary: ", 1)[1])


@pytest.fixture(scope="module")
def short_db(tmp_path_factory):
    """The JAX short_db (tests/test_pipeline_e2e.py:74): its segments
    encoded by the JAX p01 with libx264; SRC with FLAC audio."""
    tmp = tmp_path_factory.mktemp("shortdb")
    yaml_path = write_db(tmp, DB, SHORT_YAML, {"SRC000.avi": dict(n=48, audio=True)})
    assert jax_main(["p00", "-c", yaml_path, "-str", "1", "--skip-requirements"]) == 0
    return yaml_path


LONG_PVS = f"{DB}_SRC000_HRC000"


@pytest.fixture(scope="module")
def long_db(tmp_path_factory):
    """LONG_YAML, its two segments encoded by the JAX p01 (libx264 + AAC);
    SRC with FLAC audio."""
    tmp = tmp_path_factory.mktemp("longdb")
    yaml_path = write_db(tmp, DB, LONG_YAML, {"SRC000.avi": dict(n=48, audio=True)})
    assert jax_main(["p00", "-c", yaml_path, "-str", "1", "--skip-requirements"]) == 0
    return yaml_path


#: a freeze HRC over the segments the database already has: (HRC line, PVS)
FREEZE_HRC = {
    "short": "  HRC003: {videoCodingId: VC01, eventList: [[Q0, 2], [freeze, 0.25], [freeze, 0.5]]}\n",
    "long": "  HRC001: {videoCodingId: VC01, audioCodingId: AC01, "
            "eventList: [[Q0, 1], [freeze, 0.25], [Q0, 1]]}\n",
}


def _add_freeze(yaml_path: str, kind: str) -> str:
    """Add the freeze HRC of `kind` and its PVS to a copied database;
    returns the PVS id."""
    line = FREEZE_HRC[kind]
    pvs_id = f"{DB}_SRC000_{line.split(':')[0].strip()}"
    with open(yaml_path) as f:
        text = f.read()
    text = text.replace("pvsList:\n", f"{line}pvsList:\n  - {pvs_id}\n", 1)
    with open(yaml_path, "w") as f:
        f.write(text)
    return pvs_id


def _copy(yaml_path: str, dest) -> str:
    folder = os.path.dirname(yaml_path)
    shutil.copytree(folder, dest / DB)
    return str(dest / DB / os.path.basename(yaml_path))


def _decoded(path: str):
    with JReader(path) as r:
        stacks, pts = r.read_all()
    return stacks, pts


def _assert_same_avpvs(a: str, b: str, atol: float = 1e-3) -> None:
    """Decoded-identical planes and audio, and SI/TI sidecars within atol."""
    (sa, pa), (sb, pb) = _decoded(a), _decoded(b)
    assert pa == pb and len(sa) == len(sb) == 3
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)
    try:
        aa = jml.decode_audio_s16(a)
    except jml.MediaError:
        aa = None
    if aa is None:
        with pytest.raises(jml.MediaError):
            jml.decode_audio_s16(b)
    else:
        ab = jml.decode_audio_s16(b)
        assert aa[1] == ab[1]
        np.testing.assert_array_equal(aa[0], ab[0])
    side = a + ".siti.csv"
    assert os.path.isfile(side) == os.path.isfile(b + ".siti.csv")
    if os.path.isfile(side):
        x = np.loadtxt(side, delimiter=",", skiprows=1, ndmin=2)
        y = np.loadtxt(b + ".siti.csv", delimiter=",", skiprows=1, ndmin=2)
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _plans_agree(jplan: dict, tplan: dict) -> None:
    """Plans equal but for the documented resize identity ("auto:cpu" in
    the JAX package, "torch-auto:cpu" in the port, so a shared store never
    serves one package's bytes for the other's plan): with it aligned, the
    plan hashes (file references resolved to content digests) are equal."""
    assert jplan["resize"] == "auto:cpu" and tplan["resize"] == "torch-auto:cpu"
    assert tkeys.plan_hash({**tplan, "resize": "auto:cpu"}, tkeys.hash_file) == \
        jkeys.plan_hash(jplan, jkeys.hash_file)
    assert tkeys.plan_hash(tplan, tkeys.hash_file) != jkeys.plan_hash(jplan, jkeys.hash_file)


ROUTES = {"native": dict(), "f60": dict(force_60_fps=True), "z": dict(avpvs_src_fps=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("pvs_id", PVSES[:2])
def test_create_avpvs_wo_buffer_equals_jax(short_db, tmp_path, pvs_id, route):
    """The wo_buffer job of each package on its own copy of the database:
    decoded-identical AVPVS, SI/TI within 1e-3, equal provenance and plans
    (but for the resize identity)."""
    kw = ROUTES[route]
    jy, ty = _copy(short_db, tmp_path / "j"), _copy(short_db, tmp_path / "t")
    jjob = jav.create_avpvs_wo_buffer(JTestConfig(jy).pvses[pvs_id], **kw)
    tjob = tav.create_avpvs_wo_buffer(TTestConfig(ty).pvses[pvs_id], device="cpu", **kw)
    assert tjob.label == jjob.label and tjob.sidecar_suffixes == jjob.sidecar_suffixes
    assert tjob.provenance == jjob.provenance
    _plans_agree(jjob.plan, tjob.plan)
    jjob.run()
    tjob.run()
    rel = os.path.relpath(jjob.output_path, os.path.dirname(jy))
    assert rel == os.path.relpath(tjob.output_path, os.path.dirname(ty))
    _assert_same_avpvs(jjob.output_path, tjob.output_path)
    if route == "f60":
        assert len(_decoded(tjob.output_path)[1]) == 120  # 2 s at 60 fps
    with open(jjob.logfile_path) as a, open(tjob.logfile_path) as b:
        assert a.read() == b.read()


def test_ten_bit_avpvs_equals_jax(tmp_path):
    """A 10-bit short-test PVS (its segment written as FFV1 through the JAX
    VideoWriter): decoded-identical, SI/TI within 1e-2; the rawvideo
    request takes the FFV1 fallback in both."""
    yaml_text = SHORT_YAML.replace("P2SXM90", "P2SXM91")
    base = tmp_path / "base"
    yaml_path = write_db(base, "P2SXM91", yaml_text,
                         {"SRC000.avi": dict(n=48, ten_bit=True)})
    tc = JTestConfig(yaml_path)
    pvs = tc.pvses["P2SXM91_SRC000_HRC001"]
    seg = pvs.segments[0]
    os.makedirs(os.path.dirname(seg.file_path), exist_ok=True)
    with JReader(pvs.src.file_path) as r:
        stacks, _ = r.read_all()
    tmp_avi = seg.file_path + ".avi"
    with JWriter(tmp_avi, "ffv1", 320, 180, "yuv420p10le", (24, 1)) as w:
        for k in range(stacks[0].shape[0]):
            w.write(*(p[k] for p in stacks))
    os.replace(tmp_avi, seg.file_path)  # the demuxer reads the bytes, not the name
    os.environ["PC_AVPVS_CODEC"] = "rawvideo"  # restored by the autouse fixture
    folder = os.path.dirname(yaml_path)
    copies = {}
    for tag in ("j", "t"):
        shutil.copytree(folder, tmp_path / tag / "P2SXM91")
        copies[tag] = str(tmp_path / tag / "P2SXM91" / "P2SXM91.yaml")
    jjob = jav.create_avpvs_wo_buffer(JTestConfig(copies["j"]).pvses[pvs.pvs_id])
    tjob = tav.create_avpvs_wo_buffer(TTestConfig(copies["t"]).pvses[pvs.pvs_id], device="cpu")
    _plans_agree(jjob.plan, tjob.plan)
    assert tjob.plan["codec"] == "ffv1" and tjob.plan["pix_fmt"] == "yuv420p10le"
    jjob.run()
    tjob.run()
    _assert_same_avpvs(jjob.output_path, tjob.output_path, atol=1e-2)
    assert [s["codec_name"] for s in jml.probe(tjob.output_path)["streams"]] == ["ffv1"]


def test_apply_stalling_equals_jax(short_db, tmp_path):
    """The stall pass of both packages over one wo_buffer AVPVS (the JAX
    package's): decoded-identical stalled AVPVS with the silence inserted,
    equal plans and provenance."""
    pvs_id = PVSES[2]
    jy, ty = _copy(short_db, tmp_path / "j"), _copy(short_db, tmp_path / "t")
    jpvs, tpvs = JTestConfig(jy).pvses[pvs_id], TTestConfig(ty).pvses[pvs_id]
    jav.create_avpvs_wo_buffer(jpvs).run()
    shutil.copyfile(jpvs.get_avpvs_wo_buffer_file_path(), tpvs.get_avpvs_wo_buffer_file_path())
    from processing_chain_tpu.utils.parse_args import _DEFAULT_SPINNER as jspinner
    from processing_chain_tpu_torch.utils.parse_args import _DEFAULT_SPINNER as tspinner

    jjob = jav.apply_stalling(jpvs, spinner_path=jspinner)
    tjob = tav.apply_stalling(tpvs, spinner_path=tspinner, device="cpu")
    assert tjob.provenance == jjob.provenance
    jjob.run()
    tjob.run()
    assert tkeys.plan_hash(tjob.plan, tkeys.hash_file) == \
        jkeys.plan_hash(jjob.plan, jkeys.hash_file)
    _assert_same_avpvs(jpvs.get_avpvs_file_path(), tpvs.get_avpvs_file_path())
    n_wo = len(_decoded(tpvs.get_avpvs_wo_buffer_file_path())[1])
    assert len(_decoded(tpvs.get_avpvs_file_path())[1]) == n_wo + 12  # 0.5 s at 24 fps
    assert tav.apply_stalling(TTestConfig(ty).pvses[PVSES[0]]) is None  # no buffering


def test_p03_main_equals_jax_and_skips_existing(short_db, tmp_path, main_log):
    """`p03` through each package's CLI: the same AVPVS set, decoded
    identical, the same provenance logs; a second port run plans nothing
    and leaves the outputs untouched; --force renders again."""
    jy, ty = _copy(short_db, tmp_path / "j"), _copy(short_db, tmp_path / "t")
    # -g 0: the JAX package's single-device route (the suite's 8 CPU
    # devices would otherwise take its batch route)
    assert jax_main(["p03", "-c", jy, "--skip-requirements", "-g", "0"]) == 0
    assert port_main(["p03", "-c", ty], device="cpu") == 0
    jdir, tdir = (os.path.join(os.path.dirname(y), "avpvs") for y in (jy, ty))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    avis = sorted(n for n in os.listdir(tdir) if n.endswith(".avi"))
    assert len(avis) == 4  # three PVSes and the stalled one's wo_buffer render
    for name in avis:
        _assert_same_avpvs(os.path.join(jdir, name), os.path.join(tdir, name))
    jlogs, tlogs = (os.path.join(os.path.dirname(y), "logs") for y in (jy, ty))
    assert sorted(os.listdir(jlogs)) == sorted(os.listdir(tlogs))
    for name in os.listdir(tlogs):
        with open(os.path.join(jlogs, name)) as a, open(os.path.join(tlogs, name)) as b:
            assert a.read() == b.read(), name
    stamps = {n: os.stat(os.path.join(tdir, n)).st_mtime_ns for n in avis}
    main_log.clear()
    assert port_main(["p03", "-c", ty], device="cpu") == 0
    assert {n: os.stat(os.path.join(tdir, n)).st_mtime_ns for n in avis} == stamps
    assert sum("already exists" in r.getMessage() for r in main_log.records) == 4
    assert port_main(["p03", "-c", ty, "--force", "--filter-pvs", PVSES[0]], device="cpu") == 0
    assert os.stat(os.path.join(tdir, f"{PVSES[0]}.avi")).st_mtime_ns != stamps[f"{PVSES[0]}.avi"]


def test_p03_main_dry_run_and_store(short_db, tmp_path, main_log):
    """--dry-run plans every job and writes nothing; with --store the
    outputs are committed, and a later run without the files materializes
    them from the store instead of rendering."""
    ty = _copy(short_db, tmp_path / "t")
    avpvs_dir = os.path.join(os.path.dirname(ty), "avpvs")
    assert port_main(["p03", "-c", ty, "--dry-run"], device="cpu") == 0
    assert os.listdir(avpvs_dir) == []
    # three wo_buffer renders and the stalling pass
    assert sum("[dry-run]" in r.getMessage() for r in main_log.records) == 4
    store = str(tmp_path / "store")
    try:
        assert port_main(["p03", "-c", ty, "--store", store,
                          "--filter-pvs", PVSES[0]], device="cpu") == 0
        out = os.path.join(avpvs_dir, f"{PVSES[0]}.avi")
        want = _decoded(out)
        os.unlink(out)
        os.unlink(out + ".siti.csv")
        main_log.clear()
        assert port_main(["p03", "-c", ty, "--store", store,
                          "--filter-pvs", PVSES[0]], device="cpu") == 0
        assert not any("p03 summary" in r.getMessage() and '"renders": 1' in r.getMessage()
                       for r in main_log.records)
        assert os.path.isfile(out + ".siti.csv")
        got = _decoded(out)
        for x, y in zip(got[0], want[0]):
            np.testing.assert_array_equal(x, y)
    finally:
        from processing_chain_tpu_torch.store import runtime

        runtime.configure(None)


def test_p03_adopts_pre_store_outputs(short_db, tmp_path, main_log):
    """An AVPVS rendered before the store was on is adopted on the first
    store run (committed as it is, not rebuilt), as in the JAX package."""
    ty = _copy(short_db, tmp_path / "t")
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0]], device="cpu") == 0
    out = os.path.join(os.path.dirname(ty), "avpvs", f"{PVSES[0]}.avi")
    main_log.clear()
    try:
        assert port_main(["p03", "-c", ty, "--store", str(tmp_path / "store"),
                          "--filter-pvs", PVSES[0]], device="cpu") == 0
    finally:
        from processing_chain_tpu_torch.store import runtime

        runtime.configure(None)
    assert any("adopted into the artifact store" in r.getMessage() for r in main_log.records)
    assert any('"renders": 0' in r.getMessage() for r in main_log.records)


@pytest.mark.parametrize("case", ["fused", "cards", "observability", "no_cuda"])
def test_p03_refuses_routes_it_does_not_have(short_db, tmp_path, monkeypatch, main_log, case):
    """The stage never takes a route the JAX package would not take:
    several cards (item 7) are refused with the item named; without a
    device argument the CLI runs on cuda:0 and refuses a host without
    CUDA. The routes ported since run: PC_FUSE_P04 writes the fused
    members (the stalled AVPVS and the CPVS) from p03 alone, and the
    observability flags write their artifacts."""
    ty = _copy(short_db, tmp_path / "t")
    args, device, code, message = ["p03", "-c", ty], "cpu", 1, None
    db = os.path.dirname(ty)
    if case == "fused":
        monkeypatch.setenv("PC_FUSE_P04", "1")
        args += ["--filter-pvs", PVSES[2]]
        assert port_main(args, device=device) == 0
        assert sorted(os.listdir(os.path.join(db, "cpvs"))) == [f"{PVSES[2]}_PC.avi"]
        assert f"{PVSES[2]}.avi" in os.listdir(os.path.join(db, "avpvs"))
        assert not any("item 8" in r.getMessage() for r in main_log.records)
        return
    if case == "observability":
        out = tmp_path / "tm"
        args += ["--filter-pvs", PVSES[0], "--telemetry", str(out)]
        assert port_main(args, device=device) == 0
        kinds = sorted(n.split("_")[0] + "_" + n.rsplit(".", 1)[-1] for n in os.listdir(out)
                       if os.path.isfile(out / n))
        assert kinds == ["events_jsonl", "metrics_json", "metrics_prom", "trace_json"]
        assert not any("item 6" in r.getMessage() for r in main_log.records)
        return
    if case == "cards":
        monkeypatch.setattr(tstage, "device_count", lambda: 2)
        message = "item 7"
    else:
        if __import__("torch").cuda.is_available():
            pytest.skip("this host has CUDA; the default device resolves")
        device, message = None, "CUDA is not available"
    assert port_main(args, device=device) == code
    assert any(message in r.getMessage() for r in main_log.records)
    assert os.listdir(os.path.join(db, "avpvs")) == []


@pytest.mark.parametrize("kind", ["short", "long", "fused"])
def test_p03_process_imports_no_jax(short_db, long_db, tmp_path, kind):
    """A p03 run of the port, as a process on the CPU, imports no jax and
    nothing of the JAX package, over the short and the long database, and
    on the fused route (PC_FUSE_P04) over the long one."""
    ty = _copy(short_db if kind == "short" else long_db, tmp_path / "t")
    pvs_id = PVSES[2] if kind == "short" else LONG_PVS
    code = ("import os, sys\n"
            f"os.environ['PC_FUSE_P04'] = {'1' if kind == 'fused' else '0'!r}\n"
            "from processing_chain_tpu_torch.cli import main\n"
            f"assert main(['p03', '-c', {ty!r}, '--filter-pvs', {pvs_id!r}],"
            " device='cpu') == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'processing_chain_tpu')]\n"
            "print('FORBIDDEN', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout
    assert os.path.isfile(os.path.join(os.path.dirname(ty), "avpvs", f"{pvs_id}.avi"))
    assert os.path.isfile(os.path.join(os.path.dirname(ty), "cpvs", f"{pvs_id}_PC.avi")) == \
        (kind == "fused")


# ------------------------------------------------------------------ long tests


@pytest.mark.parametrize("decode_workers", ["1", "3"])
def test_long_avpvs_wo_buffer_equals_jax(long_db, tmp_path, monkeypatch, decode_workers):
    """The long test's wo_buffer job of each package: decoded-identical
    AVPVS (2 s of segments on the 60 fps canvas, the SRC's stereo audio),
    SI/TI within 1e-3 with TI chained across the segment join, equal
    provenance and plans (but for the resize identity); the port opens
    one decoder a segment, at any decode width."""
    monkeypatch.setenv("PC_DECODE_WORKERS", decode_workers)
    jy, ty = _copy(long_db, tmp_path / "j"), _copy(long_db, tmp_path / "t")
    jjob = jav.create_avpvs_wo_buffer(JTestConfig(jy).pvses[LONG_PVS])
    tpvs = TTestConfig(ty).pvses[LONG_PVS]
    tjob = tav.create_avpvs_wo_buffer(tpvs, device="cpu")
    assert tjob.label == jjob.label and tjob.sidecar_suffixes == jjob.sidecar_suffixes
    assert tjob.provenance == jjob.provenance
    _plans_agree(jjob.plan, tjob.plan)
    assert tjob.plan["durations"] == [1.0, 1.0] and tjob.plan["src_audio"] is not None
    jjob.run()
    was = ttm.enabled()
    ttm.enable()
    try:
        opens0 = ttm.REGISTRY.sum_series("chain_io_decoder_opens_total", None) or 0.0
        tjob.run()
        opens = ttm.REGISTRY.sum_series("chain_io_decoder_opens_total", None) - opens0
    finally:
        if not was:
            ttm.disable()
    assert opens == len(tpvs.segments) == 2
    assert jjob.output_path.endswith("_concat_wo_buffer.avi")
    _assert_same_avpvs(jjob.output_path, tjob.output_path)
    assert len(_decoded(tjob.output_path)[1]) == 120
    samples, rate = jml.decode_audio_s16(tjob.output_path)
    want, want_rate = jml.decode_audio_s16(tpvs.src.file_path, 0.0, 2.0, channels=2)
    assert rate == want_rate
    np.testing.assert_array_equal(samples, want)


def test_long_p03_main_equals_jax(long_db, tmp_path, main_log):
    """`p03` through each package's CLI over the long database: the
    wo_buffer render and its stalled AVPVS (120 + 30 stall frames)
    decoded identical with the silence inserted, the same provenance
    logs; both stall jobs over one wo_buffer file plan to one hash."""
    jy, ty = _copy(long_db, tmp_path / "j"), _copy(long_db, tmp_path / "t")
    assert jax_main(["p03", "-c", jy, "--skip-requirements", "-g", "0"]) == 0
    assert port_main(["p03", "-c", ty], device="cpu") == 0
    summary = _summary(main_log)
    assert (summary["renders"], summary["stalls"]) == (1, 1)
    # one decoder open a segment; the stall pass opens its input twice
    assert summary["decoder_opens"] == {"render": 2, "stall": 2}
    jdir, tdir = (os.path.join(os.path.dirname(y), "avpvs") for y in (jy, ty))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    avis = sorted(n for n in os.listdir(tdir) if n.endswith(".avi"))
    assert avis == [f"{LONG_PVS}.avi", f"{LONG_PVS}_concat_wo_buffer.avi"]
    for name in avis:
        _assert_same_avpvs(os.path.join(jdir, name), os.path.join(tdir, name))
    assert len(_decoded(os.path.join(tdir, avis[0]))[1]) == 150
    jlogs, tlogs = (os.path.join(os.path.dirname(y), "logs") for y in (jy, ty))
    assert sorted(os.listdir(jlogs)) == sorted(os.listdir(tlogs))
    for name in os.listdir(tlogs):
        with open(os.path.join(jlogs, name)) as a, open(os.path.join(tlogs, name)) as b:
            assert a.read() == b.read(), name
    jpvs, tpvs = JTestConfig(jy).pvses[LONG_PVS], TTestConfig(ty).pvses[LONG_PVS]
    shutil.copyfile(jpvs.get_avpvs_wo_buffer_file_path(), tpvs.get_avpvs_wo_buffer_file_path())
    from processing_chain_tpu.utils.parse_args import _DEFAULT_SPINNER as jspinner
    from processing_chain_tpu_torch.utils.parse_args import _DEFAULT_SPINNER as tspinner

    jjob = jav.apply_stalling(jpvs, spinner_path=jspinner)
    tjob = tav.apply_stalling(tpvs, spinner_path=tspinner, device="cpu")
    assert tjob.provenance == jjob.provenance
    assert tkeys.plan_hash(tjob.plan, tkeys.hash_file) == \
        jkeys.plan_hash(jjob.plan, jkeys.hash_file)


# ------------------------------------------------------------- frame freezes


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX compositor's single-device route (the suite's 8 CPU devices
    would shard it)."""
    import jax

    devs = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs[:1])


def _jax_frozen(wo_path: str, events) -> list:
    """The JAX package's device half of a freeze: `plan_stalling` in
    skipping mode over the wo_buffer file, its frames gathered and put
    through `make_stall_compositor`."""
    with JReader(wo_path) as r:
        stacks, pts = r.read_all()
        rate, pix_fmt = r.fps, r.pix_fmt
    plan = jov.plan_stalling(len(pts), rate, events, skipping=True)
    composite = jav.make_stall_compositor(pix_fmt, None, True, 64)
    out = composite([p[plan.src_idx] for p in stacks], plan.stall_mask, plan.black_mask,
                    plan.phase)
    return [np.asarray(o) for o in out]


FREEZE_PAIRS = {"short": [[0.0, 0.25], [0.25, 0.5]], "long": [[0.0, 0.25]]}


@pytest.mark.parametrize("kind", ["short", "long"])
def test_freeze_pvs_gets_its_avpvs_through_the_cli(short_db, long_db, tmp_path, main_log,
                                                   one_jax_device, kind):
    """A frame-freeze PVS through the port's CLI: exit 0, the frozen
    AVPVS equal to the JAX package's device half on the same wo_buffer
    file, as long as it, with its audio untouched; the stall job's plan
    and provenance hold the events as back-to-back (t, d) pairs."""
    ty = _copy(short_db if kind == "short" else long_db, tmp_path / "t")
    pvs_id = _add_freeze(ty, kind)
    assert port_main(["p03", "-c", ty, "--filter-pvs", pvs_id], device="cpu") == 0
    summary = _summary(main_log)
    assert (summary["renders"], summary["stalls"]) == (1, 1)
    assert summary["decoder_opens"] == {"render": 1 if kind == "short" else 2, "stall": 2}
    tpvs = TTestConfig(ty).pvses[pvs_id]
    wo, final = tpvs.get_avpvs_wo_buffer_file_path(), tpvs.get_avpvs_file_path()
    want = _jax_frozen(wo, JTestConfig(ty).pvses[pvs_id].get_buff_events_media_time())
    (got, pts), (_, wo_pts) = _decoded(final), _decoded(wo)
    assert pts == wo_pts and len(pts) == (48 if kind == "short" else 120)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(got[0][1], got[0][0])  # frame 0 is held
    a_wo, a_out = jml.decode_audio_s16(wo), jml.decode_audio_s16(final)
    assert a_wo[1] == a_out[1]
    np.testing.assert_array_equal(a_out[0], a_wo[0])
    job = tav.apply_stalling(tpvs, device="cpu")
    assert job.plan["events"] == FREEZE_PAIRS[kind] and job.plan["mode"] == "skipping"
    assert job.provenance["events"] == FREEZE_PAIRS[kind]
