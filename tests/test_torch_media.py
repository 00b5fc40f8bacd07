"""The port's media boundary (csrc/media.cpp + io/medialib, io/probe,
io/sharedscan, io/video, engine/prefetch.AsyncWriter) against the JAX
package's native boundary on this host's FFmpeg 5.1: the same files
through both, compared exactly.

Inputs: the committed fixtures (processing_chain_tpu_torch/assets/media:
H.264+AAC, HEVC, VP9) and files the JAX `VideoWriter` writes here (u8 and
10-bit; 4:2:0, 4:2:2, 4:4:4; packed uyvy422; with and without audio).
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from processing_chain_tpu.io import medialib as jml
from processing_chain_tpu.io import probe as jprobe
from processing_chain_tpu.io import sharedscan as jscan
from processing_chain_tpu.io.video import VideoReader as JReader
from processing_chain_tpu.io.video import VideoWriter as JWriter
from processing_chain_tpu_torch.engine import prefetch as tpfe
from processing_chain_tpu_torch.io import bufpool as tbufpool
from processing_chain_tpu_torch.io import medialib as tml
from processing_chain_tpu_torch.io import probe as tprobe
from processing_chain_tpu_torch.io import sharedscan as tscan
from processing_chain_tpu_torch.io.video import VideoReader as TReader
from processing_chain_tpu_torch.io.video import VideoWriter as TWriter
from tests import _torch_media_fixtures as fx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(fx.CLIPS)
SEED = 15

#: file -> (codec, pix_fmt, fps, frames, audio codec or "", encoder opts)
WRITTEN = {
    "ffv1_420_flac.avi": ("ffv1", "yuv420p", (24, 1), 13, "flac", "level=3:slicecrc=1"),
    "ffv1_422p10.mkv": ("ffv1", "yuv422p10le", (30, 1), 9, "", ""),
    "ffv1_444_pcm.avi": ("ffv1", "yuv444p", (25, 1), 8, "pcm_s16le", ""),
    "uyvy_packed.avi": ("rawvideo", "uyvy422", (24, 1), 12, "", ""),
    "x264_aac.mp4": ("libx264", "yuv420p", (24, 1), 12, "aac", "preset=ultrafast:crf=28"),
}
W, H = 64, 36


def seeded_planes(pix_fmt: str, n: int, seed: int = SEED):
    """n frames of seeded planes in `pix_fmt`'s layout (one packed plane
    for uyvy422)."""
    rng = np.random.default_rng(seed)
    if pix_fmt == "uyvy422":
        return [(rng.integers(0, 256, (H, 2 * W), dtype=np.uint8),) for _ in range(n)]
    sub_w, sub_h = {"yuv420p": (2, 2), "yuv422p10le": (2, 1), "yuv444p": (1, 1)}[pix_fmt]
    ten = "10" in pix_fmt
    dtype, hi = (np.uint16, 1024) if ten else (np.uint8, 256)
    shapes = [(H, W), (H // sub_h, W // sub_w), (H // sub_h, W // sub_w)]
    return [tuple(rng.integers(0, hi, s).astype(dtype) for s in shapes) for _ in range(n)]


def seeded_audio(n: int, seed: int = SEED) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.integers(-12000, 12000, (n, 2)).astype(np.int16)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{name: path} of the files the JAX VideoWriter writes here."""
    folder = tmp_path_factory.mktemp("media")
    out = {}
    for name, (codec, pix_fmt, fps, n, acodec, opts) in WRITTEN.items():
        path = str(folder / name)
        audio = dict(audio_codec=acodec, sample_rate=48000, channels=2) if acodec else {}
        with JWriter(path, codec, W, H, pix_fmt, fps, threads=1, opts=opts, **audio) as w:
            if acodec:
                w.write_audio(seeded_audio(48000 * n * fps[1] // fps[0]))
            for planes in seeded_planes(pix_fmt, n):
                w.write(*planes)
        out[name] = path
    return out


def _inputs(written):
    return {**{n: os.path.join(fx.ASSETS, n) for n in FIXTURES}, **written}


ALL = FIXTURES + sorted(WRITTEN)


def _assert_packets_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype


# --- the boundary itself ----------------------------------------------------

LAYOUT_PROBE = r"""
#include <stddef.h>
#include <stdio.h>
#include <libavcodec/avcodec.h>
#include <libavcodec/bsf.h>
#include <libavformat/avformat.h>
#include <libavutil/pixdesc.h>
#define P(T, F, N) printf("%s %d\n", N, (int)offsetof(T, F));
int main(void) {
P(AVFrame, data, "AVFrame.data") P(AVFrame, linesize, "AVFrame.linesize")
P(AVFrame, extended_data, "AVFrame.extended_data") P(AVFrame, width, "AVFrame.width")
P(AVFrame, height, "AVFrame.height") P(AVFrame, nb_samples, "AVFrame.nb_samples")
P(AVFrame, format, "AVFrame.format") P(AVFrame, pts, "AVFrame.pts")
P(AVFrame, sample_rate, "AVFrame.sample_rate")
P(AVFrame, best_effort_timestamp, "AVFrame.best_effort_timestamp")
P(AVFrame, ch_layout, "AVFrame.ch_layout")
P(AVPacket, pts, "AVPacket.pts") P(AVPacket, dts, "AVPacket.dts")
P(AVPacket, data, "AVPacket.data") P(AVPacket, size, "AVPacket.size")
P(AVPacket, stream_index, "AVPacket.stream_index") P(AVPacket, flags, "AVPacket.flags")
P(AVPacket, duration, "AVPacket.duration")
P(AVFormatContext, iformat, "AVFormatContext.iformat")
P(AVFormatContext, oformat, "AVFormatContext.oformat") P(AVFormatContext, pb, "AVFormatContext.pb")
P(AVFormatContext, nb_streams, "AVFormatContext.nb_streams")
P(AVFormatContext, streams, "AVFormatContext.streams")
P(AVFormatContext, duration, "AVFormatContext.duration")
P(AVFormatContext, bit_rate, "AVFormatContext.bit_rate")
P(AVStream, index, "AVStream.index") P(AVStream, codecpar, "AVStream.codecpar")
P(AVStream, time_base, "AVStream.time_base") P(AVStream, duration, "AVStream.duration")
P(AVStream, nb_frames, "AVStream.nb_frames")
P(AVStream, avg_frame_rate, "AVStream.avg_frame_rate")
P(AVStream, r_frame_rate, "AVStream.r_frame_rate")
P(AVCodecParameters, codec_type, "AVCodecParameters.codec_type")
P(AVCodecParameters, codec_id, "AVCodecParameters.codec_id")
P(AVCodecParameters, extradata, "AVCodecParameters.extradata")
P(AVCodecParameters, extradata_size, "AVCodecParameters.extradata_size")
P(AVCodecParameters, format, "AVCodecParameters.format")
P(AVCodecParameters, bit_rate, "AVCodecParameters.bit_rate")
P(AVCodecParameters, profile, "AVCodecParameters.profile")
P(AVCodecParameters, width, "AVCodecParameters.width")
P(AVCodecParameters, height, "AVCodecParameters.height")
P(AVCodecParameters, ch_layout, "AVCodecParameters.ch_layout")
P(AVCodecParameters, sample_rate, "AVCodecParameters.sample_rate")
P(AVOutputFormat, name, "AVOutputFormat.name") P(AVOutputFormat, flags, "AVOutputFormat.flags")
P(AVInputFormat, name, "AVInputFormat.name")
P(AVPixFmtDescriptor, log2_chroma_w, "AVPixFmtDescriptor.log2_chroma_w")
P(AVPixFmtDescriptor, log2_chroma_h, "AVPixFmtDescriptor.log2_chroma_h")
P(AVPixFmtDescriptor, comp[0].depth, "AVPixFmtDescriptor.comp0_depth")
P(AVCodec, sample_fmts, "AVCodec.sample_fmts")
P(AVCodecContext, coded_width, "AVCodecContext.coded_width")
P(AVCodecContext, stats_out, "AVCodecContext.stats_out")
P(AVCodecContext, stats_in, "AVCodecContext.stats_in")
P(AVBSFContext, par_in, "AVBSFContext.par_in")
P(AVBSFContext, time_base_in, "AVBSFContext.time_base_in")
printf("versions %d %d %d\n", LIBAVUTIL_VERSION_MAJOR, LIBAVFORMAT_VERSION_MAJOR,
       LIBAVCODEC_VERSION_MAJOR);
return 0;
}
"""


@pytest.fixture(scope="module")
def header_offsets(tmp_path_factory):
    """{field: offsetof} compiled against this host's libav headers."""
    folder = tmp_path_factory.mktemp("layout")
    src, exe = folder / "layout.c", folder / "layout"
    src.write_text(LAYOUT_PROBE)
    proc = subprocess.run(["gcc", str(src), "-o", str(exe)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    return dict(line.rsplit(" ", 1) if not line.startswith("versions") else ("versions", line)
                for line in out.splitlines())


def test_layout_table_equals_offsetof_from_the_headers(header_offsets):
    """The FFmpeg 5.1 table in csrc/media.cpp is the headers' offsetof, so
    a hand error in it cannot pass here; the bound table is that one."""
    versions = [int(v) for v in header_offsets.pop("versions").split()[1:]]
    binding = tml.binding()
    assert re.match(rf"lavu {versions[0]}\.\d+\.\d+ lavf {versions[1]}\.\d+\.\d+ "
                    rf"lavc {versions[2]}\.", binding["versions"])
    # the AVCodecContext fields reached from an option's offset, each
    # proved by a round trip: the coded dims, and the two-pass statistics
    # (stats_out/stats_in) by the libvpx/libaom two-pass encodes at load
    derived = [n for n in header_offsets if n.startswith("AVCodecContext.")]
    for name in derived:
        assert f"{name}@{header_offsets.pop(name)}" in binding["checks"], name
    assert binding["twopass"] == {"libvpx-vp9": "ok", "libaom-av1": "ok"}
    for name, off in header_offsets.items():
        assert tml.layout_offset(name) == int(off), name
    # every table entry (and the derived fields) was exercised by a round trip
    assert sorted(c.split("@")[0] for c in binding["checks"]) == sorted(
        [*header_offsets, *derived])


def test_media_source_includes_no_libav_header():
    with open(os.path.join(ROOT, "processing_chain_tpu_torch", "csrc", "media.cpp")) as f:
        src = f.read()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", src, re.M)
    assert includes and not [i for i in includes if i.startswith(("libav", "libsw"))]


def test_no_libav_raises_media_error(tmp_path):
    """Pointed at a folder without libav, the locator raises MediaError
    naming what it searched: no skip, no stand-in."""
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PC_LIBAV_DIRS": str(tmp_path)}
    code = ("from processing_chain_tpu_torch.io import medialib\n"
            "try:\n    medialib.ensure_loaded()\nexcept medialib.MediaError as exc:\n"
            "    print('MediaError:', exc)\nelse:\n    print('bound')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("MediaError: no libav") and str(tmp_path) in proc.stdout


def test_pinned_folder_binds_that_copy():
    """PC_LIBAV_DIRS names the folder to bind; the binding reports it."""
    folder = os.path.dirname(tml.binding()["libs"][0])
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PC_LIBAV_DIRS": folder}
    code = ("from processing_chain_tpu_torch.io import medialib\n"
            "print(medialib.binding()['found'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"PC_LIBAV_DIRS folder {folder}"


def test_codecs_reports_decoders_and_encoders():
    assert tml.codecs(["h264", "ffv1", "no-such-codec"]) == {
        "h264": True, "ffv1": True, "no-such-codec": False}
    assert tml.codecs(["ffv1", "flac"], encoder=True) == {"ffv1": True, "flac": True}


# --- fixtures ---------------------------------------------------------------

def test_fixture_record_is_what_the_jax_reader_reads():
    """fixtures.json re-derived through the JAX reader equals the
    committed record, and the clips stay within their size budget."""
    with open(fx.RECORD) as f:
        assert fx.record() == json.load(f)
    sizes = [os.path.getsize(os.path.join(fx.ASSETS, n)) for n in FIXTURES]
    assert max(sizes) < 64 * 1024 and sum(sizes) < 256 * 1024


@pytest.mark.parametrize("name", FIXTURES)
def test_port_reader_decodes_fixture_to_the_record(name):
    with open(fx.RECORD) as f:
        want = json.load(f)[name]
    with TReader(os.path.join(fx.ASSETS, name)) as r:
        stacks, pts = r.read_all()
    md5 = [[hashlib.md5(np.ascontiguousarray(p[k]).tobytes()).hexdigest() for p in stacks]
           for k in range(len(pts))]
    assert md5 == want["md5"]
    info = tprobe.LibavProber().src_info(os.path.join(fx.ASSETS, name))
    assert (info["width"], info["height"], info["pix_fmt"], info["r_frame_rate"]) == (
        want["width"], want["height"], want["pix_fmt"], want["r_frame_rate"])
    assert abs(info["video_duration"] - want["duration"]) <= 1e-3


# --- probe and scans --------------------------------------------------------

@pytest.mark.parametrize("coded", [False, True], ids=["display", "coded"])
@pytest.mark.parametrize("name", ALL)
def test_probe_equals_jax(written, name, coded):
    path = _inputs(written)[name]
    assert tml.probe(path, coded_dims=coded) == jml.probe(path, coded_dims=coded)


@pytest.mark.parametrize("name", ALL)
def test_packet_scans_equal_jax(written, name):
    path = _inputs(written)[name]
    _assert_packets_equal(tml.scan_packets(path, "video"), jml.scan_packets(path, "video"))
    t_all, j_all = tml.scan_packets_all(path), jml.scan_packets_all(path)
    _assert_packets_equal(t_all["video"], j_all["video"])
    assert (t_all["audio"] is None) == (j_all["audio"] is None)
    if j_all["audio"] is not None:
        _assert_packets_equal(t_all["audio"], j_all["audio"])
        _assert_packets_equal(tml.scan_packets(path, "audio"), jml.scan_packets(path, "audio"))
    else:
        with pytest.raises(tml.MediaError, match="no such stream"):
            tml.scan_packets(path, "audio")


@pytest.mark.parametrize("name", ["h264_aac.mp4", "ffv1_420_flac.avi", "ffv1_444_pcm.avi",
                                  "x264_aac.mp4"])
def test_audio_decode_equals_jax(written, name):
    path = _inputs(written)[name]
    for channels, start, dur in ((0, 0.0, 0.0), (2, 0.0, 0.0), (1, 0.1, 0.2)):
        t, j = (m.decode_audio_s16(path, start, dur, channels=channels) for m in (tml, jml))
        assert t[1] == j[1]
        np.testing.assert_array_equal(t[0], j[0])


def test_audio_decode_without_audio_stream_raises(written):
    for m in (tml, jml):
        with pytest.raises(m.MediaError, match="no audio stream"):
            m.decode_audio_s16(written["ffv1_422p10.mkv"])


@pytest.mark.parametrize("name", ["h264_aac.mp4", "ffv1_420_flac.avi", "ffv1_422p10.mkv"])
def test_probe_module_equals_jax(written, name, tmp_path):
    """io/probe (segment info, frame tables, the sidecar-caching prober)
    and io/sharedscan through both packages."""
    import pandas as pd

    path = _inputs(written)[name]
    assert tprobe.get_segment_info(path, target_video_bitrate=7) == \
        jprobe.get_segment_info(path, target_video_bitrate=7)
    pd.testing.assert_frame_equal(tprobe.get_video_frame_info(path, "s"),
                                  jprobe.get_video_frame_info(path, "s"))
    if "flac" in name or "aac" in name:
        pd.testing.assert_frame_equal(tprobe.get_audio_frame_info(path, "s"),
                                      jprobe.get_audio_frame_info(path, "s"))
    sides = [str(tmp_path / f"{k}.yaml") for k in ("t", "j")]
    assert tprobe.LibavProber().src_info(path, sides[0]) == \
        jprobe.LibavProber().src_info(path, sides[1])
    with open(sides[0]) as a, open(sides[1]) as b:
        assert a.read() == b.read()
    assert tprobe.LibavProber().duration(path, sides[0]) == \
        jprobe.LibavProber().duration(path, sides[1])
    tscan.clear()
    jscan.clear()
    for _ in range(2):  # a miss, then a hit
        t_scan, j_scan = tscan.get_scan(path), jscan.get_scan(path)
        _assert_packets_equal(t_scan["video"], j_scan["video"])


# --- reading ----------------------------------------------------------------

@pytest.mark.parametrize("window", [(0.0, 0.0), (0.25, 0.0), (0.1, 0.2)],
                         ids=["all", "from_0.25s", "0.1s+0.2s"])
@pytest.mark.parametrize("name", ALL)
def test_reader_equals_jax(written, name, window):
    path = _inputs(written)[name]
    start, dur = window
    with TReader(path, start, dur) as t, JReader(path, start, dur) as j:
        for attr in ("width", "height", "pix_fmt", "container_pix_fmt", "fps", "fps_fraction",
                     "duration", "n_planes", "plane_shapes", "dtype"):
            assert getattr(t, attr) == getattr(j, attr), attr
        pool = tbufpool.BufferPool()
        got = [[np.array(p) for p in c] for c in t.iter_chunks(5, pool=pool)]
        want = [[np.array(p) for p in c] for c in j.iter_chunks(5)]
    assert len(got) == len(want) and len(got) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with TReader(path, start, dur) as t, JReader(path, start, dur) as j:
        (ts, tp), (js, jp) = t.read_all(), j.read_all()
    assert tp == jp
    for x, y in zip(ts, js):
        np.testing.assert_array_equal(x, y)
    with TReader(path, start, dur) as t, JReader(path, start, dur) as j:
        for a, b in zip(t, j, strict=True):
            assert a.pts == b.pts and a.pix_fmt == b.pix_fmt
            for x, y in zip(a.planes, b.planes, strict=True):
                np.testing.assert_array_equal(x, y)


def test_reader_rejects_what_jax_rejects(tmp_path):
    for cls in (TReader, JReader):
        with pytest.raises(Exception, match="open"):
            cls(str(tmp_path / "missing.avi"))


# --- writing ----------------------------------------------------------------

#: (name, codec, pix_fmt, VideoWriter kwargs)
WRITES = [
    ("ffv1_slices", "ffv1", "yuv420p", dict(threads=2, opts="level=3:coder=1:context=1:"
                                            "slicecrc=1:slices=4")),
    ("ffv1_fp_workers", "ffv1", "yuv420p", dict(threads=1, opts="level=3:coder=1:context=1:"
                                                "slicecrc=1:pc_fp_workers=3")),
    ("ffv1_10bit_fp", "ffv1", "yuv422p10le", dict(threads=1, opts="level=3:pc_fp_workers=2")),
    ("rawvideo", "rawvideo", "yuv420p", {}),
    ("ffv1_444", "ffv1", "yuv444p", dict(threads=1)),
]


@pytest.mark.parametrize("batch", [True, False], ids=["write_batch", "write"])
@pytest.mark.parametrize("case", WRITES, ids=[w[0] for w in WRITES])
def test_writer_output_reads_back_through_jax(tmp_path, case, batch):
    """What the port's VideoWriter writes, the JAX reader decodes to
    exactly what was written, audio included; FFV1 and rawvideo from one
    libav are byte-identical to the JAX writer's."""
    name, codec, pix_fmt, kw = case
    planes = seeded_planes(pix_fmt, 11)
    audio = seeded_audio(48000 * 11 // 24)
    paths = {}
    for tag, cls in (("t", TWriter), ("j", JWriter)):
        paths[tag] = str(tmp_path / f"{name}_{tag}.avi")
        with cls(paths[tag], codec, W, H, pix_fmt, (24, 1), audio_codec="flac",
                 sample_rate=48000, channels=2, **kw) as w:
            w.write_audio(audio[:4000])
            if batch and tag == "t":
                w.write_batch(*(np.stack([p[k] for p in planes[:7]]) for k in range(3)))
                w.write_batch(*(np.stack([p[k] for p in planes[7:]]) for k in range(3)))
            else:
                for p in planes:
                    w.write(*p)
            w.write_audio(audio[4000:])
    with JReader(paths["t"]) as r:
        stacks, _ = r.read_all()
    for k in range(3):
        np.testing.assert_array_equal(stacks[k], np.stack([p[k] for p in planes]))
    back, rate = jml.decode_audio_s16(paths["t"])
    assert rate == 48000
    np.testing.assert_array_equal(back, audio)
    with open(paths["t"], "rb") as a, open(paths["j"], "rb") as b:
        assert a.read() == b.read()


def test_writer_refuses_what_it_does_not_carry(tmp_path):
    """Two-pass is carried now: a pass-1 x264 writer opens and writes its
    statistics file. Frame-parallel FFV1 stays single-pass and intra-only;
    an unknown encoder or pixel format is refused by name."""
    stats = str(tmp_path / "s")
    with TWriter(str(tmp_path / "a.mp4"), "libx264", W, H, threads=1, opts="preset=ultrafast",
                 pass_num=1, stats_path=stats) as w:
        for planes in seeded_planes("yuv420p", 3):
            w.write(*planes)
    assert os.path.getsize(stats) > 0
    with pytest.raises(tml.MediaError, match="single-pass"):
        TWriter(str(tmp_path / "e.avi"), "ffv1", W, H, opts="pc_fp_workers=2", pass_num=1,
                stats_path=stats)
    with pytest.raises(tml.MediaError, match="intra-only"):
        TWriter(str(tmp_path / "b.mp4"), "libx264", W, H, opts="pc_fp_workers=2")
    with pytest.raises(tml.MediaError, match="no encoder"):
        TWriter(str(tmp_path / "c.avi"), "no-such-encoder", W, H)
    with pytest.raises(tml.MediaError, match="bad pix_fmt"):
        TWriter(str(tmp_path / "d.avi"), "ffv1", W, H, pix_fmt="nope")


#: encoder -> (container, the options p01 gives it, its own statistics files)
TWO_PASS = {
    "libx264": ("mp4", "preset=ultrafast", ("",)),
    "libx265": ("mp4", "x265-params=log-level=error\\:pass={p}\\:stats={s}", ("", ".cutree")),
    "libvpx-vp9": ("webm", "quality=good:speed={speed}:row-mt=1", ("",)),
    "libaom-av1": ("mkv", "cpu-used=8:usage=realtime", ("",)),
}


@pytest.mark.parametrize("encoder", sorted(TWO_PASS))
def test_two_pass_writer_equals_jax(tmp_path, encoder):
    """A two-pass encode through each package's writer, as p01 runs it
    (pass 1 to a temporary, pass 2 reading the statistics): the same
    statistics files (x264's and x265's own, libvpx/libaom's collected
    stats_out), the same elementary stream (IVF for VP9/AV1, whose WebM/
    Matroska containers carry a random segment UID; the whole file for
    MP4), and the port's file decodes through the JAX reader."""
    ext, opts, suffixes = TWO_PASS[encoder]
    planes = seeded_planes("yuv420p", 12)
    out = {}
    for tag, cls in (("t", TWriter), ("j", JWriter)):
        stats = str(tmp_path / f"stats_{tag}")
        for p in (1, 2):
            path = str(tmp_path / f"{tag}.{ext}") + (f".pass1.tmp.{ext}" if p == 1 else "")
            o = opts.format(p=p, s=stats, speed=4 if p == 1 else 1)
            with cls(path, encoder, W, H, "yuv420p", (24, 1), bitrate_kbps=150, threads=1,
                     opts=o, pass_num=p, stats_path=stats) as w:
                for frame in planes:
                    w.write(*frame)
            if p == 1:
                os.unlink(path)
        out[tag] = (str(tmp_path / f"{tag}.{ext}"), stats)
    for suffix in suffixes:
        with open(out["t"][1] + suffix, "rb") as a, open(out["j"][1] + suffix, "rb") as b:
            got, want = a.read(), b.read()
        assert got and got == want, suffix
    if ext == "mp4":
        with open(out["t"][0], "rb") as a, open(out["j"][0], "rb") as b:
            assert a.read() == b.read()
    else:
        tml.extract_ivf(out["t"][0], str(tmp_path / "t.ivf"))
        jml.extract_ivf(out["j"][0], str(tmp_path / "j.ivf"))
        assert (tmp_path / "t.ivf").read_bytes() == (tmp_path / "j.ivf").read_bytes()
    with JReader(out["t"][0]) as r:
        stacks, _ = r.read_all()
    assert stacks[0].shape == (12, H, W)


#: fixture -> the extraction p02 runs on it (a bitstream filter, or IVF)
EXTRACTS = {"h264_aac.mp4": "h264_mp4toannexb", "hevc.mkv": "hevc_mp4toannexb",
            "vp9.webm": "ivf"}


@pytest.mark.parametrize("name", sorted(EXTRACTS))
def test_extractions_equal_jax(tmp_path, name):
    """extract_annexb / extract_ivf write the JAX boundary's bytes (the
    filtered Annex-B stream, the IVF file) from each fixture."""
    path = os.path.join(fx.ASSETS, name)
    how = EXTRACTS[name]
    t, j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    if how == "ivf":
        tml.extract_ivf(path, t)
        jml.extract_ivf(path, j)
    else:
        tml.extract_annexb(path, how, t)
        jml.extract_annexb(path, how, j)
    with open(t, "rb") as a, open(j, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and len(got) > 1000
    assert got[:4] == (b"DKIF" if how == "ivf" else b"\x00\x00\x00\x01")


def test_extraction_refuses_a_missing_filter_by_name(tmp_path):
    with pytest.raises(tml.MediaError, match="no bitstream filter no_such_bsf"):
        tml.extract_annexb(os.path.join(fx.ASSETS, "h264_aac.mp4"), "no_such_bsf",
                           str(tmp_path / "x.h264"))
    with pytest.raises(tml.MediaError, match="open_input"):
        tml.extract_ivf(str(tmp_path / "missing.webm"), str(tmp_path / "x.ivf"))


def test_async_writer_encodes_tensors_and_recycles_blocks(tmp_path):
    """engine/prefetch.AsyncWriter (JAX :254-376) over the port's writer:
    tensors are fetched on its thread, whole chunks go through
    write_batch, and recycled pool blocks return to the pool only after
    their chunk is encoded."""
    import torch

    pool = tbufpool.BufferPool()
    planes = seeded_planes("yuv420p", 10)
    path = str(tmp_path / "aw.avi")
    with tpfe.AsyncWriter(TWriter(path, "ffv1", W, H, "yuv420p", (24, 1)), pool=pool) as aw:
        for lo in (0, 5):
            block = pool.acquire((5, H, W), np.uint8)
            block[:] = np.stack([p[0] for p in planes[lo:lo + 5]])
            chroma = [torch.from_numpy(np.stack([p[k] for p in planes[lo:lo + 5]]))
                      for k in (1, 2)]
            aw.put([block, *chroma], recycle=[block])
    stats = pool.stats()
    # the second block is a recycled first one when the worker was ahead
    assert stats["outstanding"] == 0 and stats["hits"] + stats["misses"] == 2
    assert stats["free_blocks"] == stats["misses"]
    assert aw.busy_s > 0
    with JReader(path) as r:
        stacks, _ = r.read_all()
    for k in range(3):
        np.testing.assert_array_equal(stacks[k], np.stack([p[k] for p in planes]))


def test_async_writer_reraises_worker_errors(tmp_path):
    class Broken:
        def write_batch(self, *planes):
            raise tml.MediaError("encode failed")

        def close(self):
            pass

    aw = tpfe.AsyncWriter(Broken())
    aw.put([np.zeros((1, 2, 2), np.uint8)])
    with pytest.raises(tml.MediaError, match="encode failed"):
        aw.close()


def test_iter_plane_chunks_equals_jax(written):
    from processing_chain_tpu.engine import prefetch as jpfe

    path = written["ffv1_422p10.mkv"]
    with TReader(path) as t, JReader(path) as j:
        got = [[np.array(p) for p in c] for c in tpfe.iter_plane_chunks(t, 4)]
        want = [[np.array(p) for p in c] for c in jpfe.iter_plane_chunks(j, 4)]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
