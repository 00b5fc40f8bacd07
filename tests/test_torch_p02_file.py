"""p02 in the port (io/framesizes, models/metadata, stages/
p02_generate_metadata, cli `p02`) against the JAX p02 on the CPU: the
segments of one database encoded once by the JAX p01 (libx264, libx265,
libvpx-vp9 with its hidden alt-ref frames, libaom-av1, a stall HRC) and a
long test with AAC audio, each package's p02 run over its own copy of the
same segment files, and `.qchanges`, `.vfi`, `.afi` and `.buff` compared
byte for byte. A frame-freeze PVS, whose metadata job the JAX package
cannot build (ROADMAP Queue C), gets its four files from the port.
"""

import os
import shutil
import struct
import textwrap

import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu.config import TestConfig as JTestConfig
from processing_chain_tpu.io import framesizes as jfs
from processing_chain_tpu.io import medialib as jml
from processing_chain_tpu.io import sharedscan as jscan
from processing_chain_tpu.models import metadata as jmd
from processing_chain_tpu.store import keys as jkeys
from processing_chain_tpu.utils.runner import ChainError as JChainError
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from processing_chain_tpu_torch.io import framesizes as tfs
from processing_chain_tpu_torch.io import medialib as tml
from processing_chain_tpu_torch.io import sharedscan as tscan
from processing_chain_tpu_torch.models import metadata as tmd
from processing_chain_tpu_torch.store import keys as tkeys
from processing_chain_tpu_torch.utils.runner import ChainError as TChainError
from tests.test_pipeline_e2e import write_db

DB = "P2SXM93"
SHORT_YAML = textwrap.dedent(f"""\
    databaseId: {DB}
    syntaxVersion: 6
    type: short
    qualityLevelList:
      Q0: {{index: 0, videoCodec: h264, videoBitrate: 200, width: 160, height: 90, fps: 24}}
      Q1: {{index: 1, videoCodec: h265, videoBitrate: 200, width: 160, height: 90, fps: 24}}
      Q2: {{index: 2, videoCodec: vp9, videoBitrate: 200, width: 160, height: 90, fps: 24}}
      Q3: {{index: 3, videoCodec: av1, videoBitrate: 200, width: 160, height: 90, fps: 24}}
    codingList:
      VC01: {{type: video, encoder: libx264, passes: 1, iFrameInterval: 1, preset: ultrafast}}
      VC02: {{type: video, encoder: libx265, passes: 1, iFrameInterval: 1, preset: ultrafast}}
      VC03: {{type: video, encoder: libvpx-vp9, passes: 2, speed: 4}}
      VC04: {{type: video, encoder: libaom-av1, passes: 1, iFrameInterval: 1, cpuUsed: 8}}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000: {{videoCodingId: VC01, eventList: [[Q0, 2]]}}
      HRC001: {{videoCodingId: VC02, eventList: [[Q1, 2]]}}
      HRC002: {{videoCodingId: VC03, eventList: [[Q2, 2]]}}
      HRC003: {{videoCodingId: VC04, eventList: [[Q3, 2]]}}
      HRC004: {{videoCodingId: VC01, eventList: [[Q0, 2], [stall, 0.5]]}}
    pvsList:
      - {DB}_SRC000_HRC000
      - {DB}_SRC000_HRC001
      - {DB}_SRC000_HRC002
      - {DB}_SRC000_HRC003
      - {DB}_SRC000_HRC004
    postProcessingList:
      - {{type: pc, displayWidth: 160, displayHeight: 90, codingWidth: 160, codingHeight: 90, displayFrameRate: 24}}
""")
LONG_YAML = textwrap.dedent(f"""\
    databaseId: {DB}
    syntaxVersion: 6
    type: long
    segmentDuration: 1
    qualityLevelList:
      Q0: {{index: 0, videoCodec: h264, videoBitrate: 200, width: 160, height: 90, fps: 24, audioCodec: aac, audioBitrate: 96}}
    codingList:
      VC01: {{type: video, encoder: libx264, passes: 1, iFrameInterval: 1, preset: ultrafast}}
      AC01: {{type: audio, encoder: aac}}
    srcList:
      SRC000: SRC000.avi
    hrcList:
      HRC000: {{videoCodingId: VC01, audioCodingId: AC01, eventList: [[Q0, 1], [stall, 0.5], [Q0, 1]]}}
    pvsList:
      - {DB}_SRC000_HRC000
    postProcessingList:
      - {{type: pc, displayWidth: 160, displayHeight: 90, codingWidth: 160, codingHeight: 90, displayFrameRate: 24}}
""")
#: case -> (database, PVS)
CASES = {
    "h264": ("short", f"{DB}_SRC000_HRC000"),
    "h265": ("short", f"{DB}_SRC000_HRC001"),
    "vp9": ("short", f"{DB}_SRC000_HRC002"),
    "av1": ("short", f"{DB}_SRC000_HRC003"),
    "stall": ("short", f"{DB}_SRC000_HRC004"),
    "long": ("long", f"{DB}_SRC000_HRC000"),
}
FAMILIES = {"qchanges": "qualityChangeEventFiles", "vfi": "videoFrameInformation",
            "afi": "audioFrameInformation", "buff": "buffEventFiles"}


def _copy(yaml_path: str, dest) -> str:
    shutil.copytree(os.path.dirname(yaml_path), dest / DB)
    return str(dest / DB / f"{DB}.yaml")


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    """{kind: (JAX copy, port copy)}: the segments encoded once by the JAX
    p01, then each package's p02 over its own copy."""
    out = {}
    for kind, text in (("short", SHORT_YAML), ("long", LONG_YAML)):
        tmp = tmp_path_factory.mktemp(kind)
        y = write_db(tmp / "src", DB, text, {"SRC000.avi": dict(n=72, audio=True)})
        assert jax_main(["p00", "-c", y, "-str", "1", "--skip-requirements"]) == 0
        jy, ty = _copy(y, tmp / "j"), _copy(y, tmp / "t")
        assert jax_main(["p02", "-c", jy, "--skip-requirements"]) == 0
        assert port_main(["p02", "-c", ty, "--skip-requirements"]) == 0
        out[kind] = (jy, ty)
    return out


def _artifact(yaml_path: str, family: str, pvs: str) -> bytes:
    path = os.path.join(os.path.dirname(yaml_path), FAMILIES[family], f"{pvs}.{family}")
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_metadata_files_equal_jax(databases, case):
    """The four files, byte for byte; `.buff` only for the stall PVSes."""
    kind, pvs = CASES[case]
    jy, ty = databases[kind]
    families = ["qchanges", "vfi", "afi"] + (["buff"] if case in ("stall", "long") else [])
    for family in families:
        assert _artifact(ty, family, pvs) == _artifact(jy, family, pvs), family
    assert not os.path.exists(os.path.join(os.path.dirname(ty), "buffEventFiles", f"{pvs}.buff")) \
        or case in ("stall", "long")
    assert _artifact(ty, "vfi", pvs).count(b"\n") > 24
    if case == "long":
        assert _artifact(ty, "afi", pvs).count(b"\n") > 40


def _superframes(ivf: bytes) -> int:
    """IVF frames that end in a VP9 superframe index."""
    n, off = 0, 32
    while off + 12 <= len(ivf):
        (size,) = struct.unpack_from("<I", ivf, off)
        last = ivf[off + 12 + size - 1]
        n += (last & 0xE0) == 0xC0
        off += 12 + size
    return n


def _segment(yaml_path: str, pvs: str) -> str:
    [seg] = TTestConfig(yaml_path).pvses[pvs].segments
    return seg.file_path


@pytest.mark.parametrize("codec", ["h264", "h265", "vp9", "av1"])
def test_framesizes_equal_jax(databases, codec, tmp_path):
    """io/framesizes per codec against the JAX module on the same file
    (a memo hit in both the second time); the VP9 segment's hidden alt-ref
    frames ride in superframes, which p02 merges before size replacement."""
    path = _segment(databases["short"][1], CASES[codec][1])
    want = jfs.get_framesizes(path, codec, force=True)
    assert tfs.get_framesizes(path, codec, force=True) == want and len(want) >= 48
    assert tfs.get_framesizes(path, codec) == want
    if codec == "vp9":
        tml.extract_ivf(path, str(tmp_path / "v.ivf"))
        assert _superframes((tmp_path / "v.ivf").read_bytes()) > 0


def test_av1_without_ffprobe_raises_the_same_error_in_both(databases, monkeypatch):
    """The AV1 fallback runs `ffprobe` through utils.runner.shell. Its
    docstring promises ChainError, but with no ffprobe installed (this
    host, the card) subprocess.run raises FileNotFoundError before `shell`
    can wrap anything, in both packages; the port keeps that behaviour,
    directly and when the native scan fails."""
    path = _segment(databases["short"][1], CASES["av1"][1])
    for fs in (jfs, tfs):
        with pytest.raises(FileNotFoundError, match="ffprobe"):
            fs.ffprobe_av1_frame_info(path)

    def no_scan(error):
        def scan(p):
            raise error("native scan refused")
        return scan

    monkeypatch.setattr(jscan, "video", no_scan(jml.MediaError))
    monkeypatch.setattr(tscan, "video", no_scan(tml.MediaError))
    for fs in (jfs, tfs):
        with pytest.raises(FileNotFoundError, match="ffprobe"):
            fs.get_framesize_av1(path)
    assert not issubclass(FileNotFoundError, (JChainError, TChainError))


def test_stall_plan_hash_equals_jax(databases):
    """A stall PVS's metadata job over one copy: the same plan, plan hash,
    extra outputs and provenance as the JAX job."""
    ty = databases["short"][1]
    pvs = CASES["stall"][1]
    jjob = jmd.metadata_job(JTestConfig(ty).pvses[pvs])
    tjob = tmd.metadata_job(TTestConfig(ty).pvses[pvs])
    assert tjob.plan == jjob.plan and tjob.plan["events"] == [[2.0, 0.5]]
    assert tkeys.plan_hash(tjob.plan, tkeys.hash_file) == jkeys.plan_hash(jjob.plan, jkeys.hash_file)
    assert tjob.extra_outputs == jjob.extra_outputs and tjob.provenance == jjob.provenance


FREEZE = f"  HRC005: {{videoCodingId: VC01, eventList: [[Q0, 2], [freeze, 0.25], [freeze, 0.5]]}}\n"


def test_freeze_pvs_gets_its_metadata_where_jax_raises(databases, tmp_path):
    """A frame-freeze PVS over the stall PVS's segment: the JAX job raises
    TypeError building its plan (`[float(e[0]), float(e[1])]` from a bare
    duration); the port's CLI writes the four files, `.buff` with the JAX
    format (the sorted durations), the others equal to the same segment's
    files, and plans the durations as back-to-back pairs."""
    ty = _copy(databases["short"][1], tmp_path)
    pvs = f"{DB}_SRC000_HRC005"
    with open(ty) as f:
        text = f.read()
    with open(ty, "w") as f:
        f.write(text.replace("pvsList:\n", f"{FREEZE}pvsList:\n  - {pvs}\n", 1))
    with pytest.raises(TypeError):
        jmd.metadata_job(JTestConfig(ty).pvses[pvs])
    assert port_main(["p02", "-c", ty, "--skip-requirements", "--filter-pvs", pvs]) == 0
    assert _artifact(ty, "buff", pvs) == b"0.25\n0.5\n"
    same = CASES["h264"][1]
    for family in ("qchanges", "vfi", "afi"):
        assert _artifact(ty, family, pvs) == _artifact(ty, family, same).replace(
            same.encode(), pvs.encode()), family
    job = tmd.metadata_job(TTestConfig(ty).pvses[pvs])
    assert job.plan["events"] == [[0.0, 0.25], [0.25, 0.5]]
