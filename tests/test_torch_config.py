"""Port parity: the database domain model (processing_chain_tpu_torch/
config: TestConfig, the domain objects, the ID grammar) against the JAX
package's, on the CPU, with StaticProber.

Every case of tests/test_config_model.py runs here once through each
package, on the same YAML in the same folder (the JAX package first): the
case's own checks hold for both, and both give an equal outcome — the
same description of every parsed object (tests/_torch_db.describe), or
the same error class and message."""

import csv
import glob
import os
import shutil

import pytest
import yaml

from tests import _torch_db as db
from tests.fixtures import SRC_INFO_1080, write_long_db, write_short_db


def _load(pkg, yaml_path, jprober, **kwargs):
    return pkg.TestConfig(yaml_path, prober=db.prober(pkg, jprober), **kwargs)


def _edit(yaml_path, fn):
    with open(yaml_path) as f:
        data = yaml.safe_load(f)
    fn(data)
    with open(yaml_path, "w") as f:
        yaml.safe_dump(data, f)


def _raises(pkg, match, fn):
    """The message of the `pkg.ConfigError` that `fn` raises."""
    with pytest.raises(pkg.ConfigError, match=match) as exc:
        fn()
    assert type(exc.value) is pkg.ConfigError
    return str(exc.value)


# --------------------------------------------------------------- the cases


def short_db_parses(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    tc = _load(pkg, yaml_path, prober)
    assert tc.is_short() and not tc.is_long()
    assert tc.database_id == "P2SXM00"
    assert set(tc.pvses) == {"P2SXM00_SRC000_HRC000", "P2SXM00_SRC000_HRC001"}
    assert len(tc.segments) == 2
    seg = sorted(tc.segments)[0]
    assert seg.filename == "P2SXM00_SRC000_Q0_VC01_0000_0-8.mp4"
    assert seg.target_pix_fmt == "yuv420p"
    assert seg.start_time == 0 and seg.duration == 8
    return tc


def segment_dedup_across_pvses(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)

    def add_hrc(data):
        data["hrcList"]["HRC002"] = {"videoCodingId": "VC01", "eventList": [["Q0", 8]]}
        data["pvsList"].append("P2SXM00_SRC000_HRC002")

    _edit(yaml_path, add_hrc)
    tc = _load(pkg, yaml_path, prober)
    assert len(tc.pvses) == 3
    assert len(tc.segments) == 2
    return tc


def long_db_planner_truncation_and_stall(pkg, tmp_path):
    yaml_path, prober = write_long_db(tmp_path, src_duration=12.0)
    tc = _load(pkg, yaml_path, prober)
    pvs = tc.pvses["P2LTR00_SRC001_HRC000"]
    assert [(s.start_time, s.duration) for s in pvs.segments] == [(0, 5), (5, 5), (10, 2.0)]
    assert pvs.segments[2].filename.endswith("_0002_10-12.mp4")
    assert pvs.has_buffering() and not pvs.has_framefreeze()
    assert pvs.get_buff_events_media_time() == [[10, 2.5]]
    assert pvs.get_buff_events_wallclock_time() == [[10, 2.5]]
    assert pvs.hrc.get_long_hrc_duration() == 17.5
    return tc


def buff_events_wallclock_vs_media(pkg, tmp_path):
    yaml_path, prober = write_long_db(tmp_path)
    _edit(yaml_path, lambda d: d["hrcList"]["HRC000"].update(eventList=[
        ["Q0", 5], ["stall", 2.0], ["Q0", 5], ["stall", 1.5], ["Q1", 5]]))
    tc = _load(pkg, yaml_path, prober)
    hrc = tc.hrcs["HRC000"]
    assert hrc.get_buff_events_media_time() == [[5, 2.0], [10, 1.5]]
    assert hrc.get_buff_events_wallclock_time() == [[5, 2.0], [12, 1.5]]
    return tc


def freeze_events_sorted_durations(pkg, tmp_path):
    yaml_path, prober = write_long_db(tmp_path)
    _edit(yaml_path, lambda d: d["hrcList"]["HRC000"].update(eventList=[
        ["Q0", 5], ["freeze", 3.0], ["Q0", 5], ["freeze", 1.5]]))
    tc = _load(pkg, yaml_path, prober)
    hrc = tc.hrcs["HRC000"]
    assert hrc.has_framefreeze()
    assert hrc.get_buff_events_media_time() == [1.5, 3.0]
    return tc


def event_divisibility_error(pkg, tmp_path):
    yaml_path, prober = write_long_db(tmp_path)
    _edit(yaml_path, lambda d: d["hrcList"]["HRC000"].update(eventList=[["Q0", 7]]))
    return _raises(pkg, "does not match", lambda: _load(pkg, yaml_path, prober))


def short_db_multi_segment_rejected(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    _edit(yaml_path, lambda d: d["hrcList"]["HRC000"].update(
        eventList=[["Q0", 16]], segmentDuration=8))
    return _raises(pkg, "one segment", lambda: _load(pkg, yaml_path, prober))


def upscale_guard(pkg, tmp_path):
    yaml_path, _ = write_short_db(tmp_path)
    prober = {"SRC000.avi": dict(SRC_INFO_1080, width=960, height=540)}
    return _raises(pkg, "upscaled", lambda: _load(pkg, yaml_path, prober))


def pix_fmt_harmonization(pkg, tmp_path):
    out = {}
    for src_fmt, expected in [("yuv444p", "yuv422p"), ("yuv422p", "yuv422p"),
                              ("rgb24", "yuv422p"), ("yuv420p", "yuv420p"),
                              ("yuv420p10le", "yuv420p10le"), ("yuv444p10le", "yuv422p10le")]:
        yaml_path, _ = write_short_db(tmp_path / src_fmt)
        tc = _load(pkg, yaml_path, {"SRC000.avi": dict(SRC_INFO_1080, pix_fmt=src_fmt)})
        seg = next(iter(tc.segments))
        assert seg.target_pix_fmt == expected, src_fmt
        out[src_fmt] = tc
    return out


def filters(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    a = _load(pkg, yaml_path, prober, filter_hrcs="HRC000")
    assert set(a.pvses) == {"P2SXM00_SRC000_HRC000"}
    b = _load(pkg, yaml_path, prober, filter_pvses="P2SXM00_SRC000_HRC001")
    assert set(b.pvses) == {"P2SXM00_SRC000_HRC001"}
    return [a, b]


def bad_ids_rejected(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    _edit(yaml_path, lambda d: d["qualityLevelList"].__setitem__(
        "X0", d["qualityLevelList"].pop("Q0")))
    return _raises(pkg, "syntax", lambda: _load(pkg, yaml_path, prober))


def syntax_version_gate(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    _edit(yaml_path, lambda d: d.update(syntaxVersion=5))
    return _raises(pkg, "syntaxVersion", lambda: _load(pkg, yaml_path, prober))


def complexity_ladder(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)

    def ladder(data):
        data["qualityLevelList"]["Q0"]["videoBitrate"] = "400/800"
        data["qualityLevelList"]["Q1"]["videoBitrate"] = "1500/3000"

    _edit(yaml_path, ladder)
    cdir = tmp_path / "complexityAnalysis"
    cdir.mkdir(exist_ok=True)
    (cdir / "complexity_classification.csv").write_text(
        "file,complexity,complexity_class\nSRC000.avi,5.0,3\n")
    high = _load(pkg, yaml_path, prober, complexity_csv_dir=str(cdir))
    assert high.is_complex()
    assert sorted(s.target_video_bitrate for s in high.segments) == [800.0, 3000.0]
    (cdir / "complexity_classification.csv").write_text(
        "file,complexity,complexity_class\nSRC000.avi,1.0,0\n")
    low = _load(pkg, yaml_path, prober, complexity_csv_dir=str(cdir))
    assert sorted(s.target_video_bitrate for s in low.segments) == [400.0, 1500.0]
    return [high, low]


def cpvs_paths_and_formats(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    tc = _load(pkg, yaml_path, prober)
    pvs = tc.pvses["P2SXM00_SRC000_HRC000"]
    assert pvs.get_cpvs_file_path("pc").endswith("P2SXM00_SRC000_HRC000_PC.avi")
    assert pvs.get_cpvs_file_path("mobile").endswith("P2SXM00_SRC000_HRC000_MO.mp4")
    assert pvs.get_cpvs_file_path("pc", rawvideo=True).endswith("_PC.mkv")
    assert pvs.get_vcodec_and_pix_fmt_for_cpvs() == ("rawvideo", "uyvy422")
    assert pvs.get_avpvs_file_path().endswith("P2SXM00_SRC000_HRC000.avi")
    return tc


def database_layout_created(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    db_dir = os.path.dirname(yaml_path)
    for sub in ("videoSegments", "avpvs", "cpvs", "logs", "buffEventFiles",
                "qualityChangeEventFiles", "videoFrameInformation", "audioFrameInformation",
                "sideInformation"):
        shutil.rmtree(os.path.join(db_dir, sub), ignore_errors=True)
    tc = _load(pkg, yaml_path, prober)
    made = sorted(n for n in os.listdir(db_dir) if os.path.isdir(os.path.join(db_dir, n)))
    assert made == sorted(["srcVid", "videoSegments", "avpvs", "cpvs", "logs", "buffEventFiles",
                           "qualityChangeEventFiles", "videoFrameInformation",
                           "audioFrameInformation", "sideInformation"])
    return [tc, made]


def mixed_src_duration_rejected(pkg, tmp_path):
    yaml_path, prober = write_long_db(tmp_path)
    _edit(yaml_path, lambda d: d["hrcList"]["HRC000"].update(
        eventList=[["Q0", 10], ["Q1", "src_duration"]]))
    return _raises(pkg, "src_duration", lambda: _load(pkg, yaml_path, prober))


def shipped_complexity_fixtures_drive_ladder(pkg, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cdir = os.path.join(repo, "util", "complexityAnalysis")
    rows = list(csv.DictReader(open(os.path.join(cdir, "complexity_classification.csv"))))
    hard = next(r["file"] for r in rows if int(r["complexity_class"]) > 1)
    easy = next(r["file"] for r in rows if int(r["complexity_class"]) <= 1)
    out = []
    for fixture_name, want in ((hard, [800.0, 3000.0]), (easy, [400.0, 1500.0])):
        yaml_path, _ = write_short_db(tmp_path / fixture_name[:6])

        def ladder(data, fixture_name=fixture_name):
            data["qualityLevelList"]["Q0"]["videoBitrate"] = "400/800"
            data["qualityLevelList"]["Q1"]["videoBitrate"] = "1500/3000"
            data["srcList"]["SRC000"] = fixture_name

        _edit(yaml_path, ladder)
        src_dir = os.path.join(os.path.dirname(yaml_path), "srcVid")
        open(os.path.join(src_dir, fixture_name), "wb").close()
        # the default complexity folder is the repo's, as for the JAX package
        tc = _load(pkg, yaml_path, {fixture_name: dict(SRC_INFO_1080)})
        assert tc.is_complex()
        assert sorted(s.target_video_bitrate for s in tc.segments) == want
        out.append(tc)
    return out


def enc_options_flag_syntax_translation(pkg, tmp_path):
    f = pkg.enc_options_to_opts
    assert f("-tune zerolatency -bf 0") == "tune=zerolatency:bf=0"
    assert f("-qcomp -0.5") == "qcomp=-0.5"
    assert f("-fastfirstpass") == "fastfirstpass=1"
    assert f("tune=film:bf=2") == "tune=film:bf=2"
    out = []
    for bad, match in (("-b:v 500k", "stream-specifier"), ("-tune zerolatency stray",
                                                             "cannot parse")):
        with pytest.raises(ValueError, match=match) as exc:
            f(bad)
        out.append(str(exc.value))
    return out


def enc_options_escapes_colon_values(pkg, tmp_path):
    got = pkg.enc_options_to_opts("-x264opts keyint=48:min-keyint=48")
    assert got == "x264opts=keyint=48\\:min-keyint=48"
    return got


def defaults_override_remaps_paths(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    db_dir = os.path.dirname(yaml_path)
    alt_avpvs = tmp_path / "alt_avpvs"
    alt_avpvs.mkdir(exist_ok=True)
    empty_srcs = tmp_path / "srcs_a"
    empty_srcs.mkdir(exist_ok=True)
    real_srcs = os.path.join(db_dir, "srcVid")
    defaults = tmp_path / "processingchain_defaults.yaml"
    defaults.write_text(yaml.safe_dump({"avpvs": str(alt_avpvs),
                                        "srcVid": [str(empty_srcs), real_srcs]}))
    tc = _load(pkg, yaml_path, prober, defaults_file=str(defaults))
    assert tc.path_mapping["avpvs"] == str(alt_avpvs)
    assert tc.srcs["SRC000"].file_path == os.path.join(real_srcs, "SRC000.avi")
    assert next(iter(tc.pvses.values())).get_avpvs_file_path().startswith(str(alt_avpvs))
    return tc


def defaults_override_rejects_missing_path(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    defaults = tmp_path / "processingchain_defaults.yaml"
    defaults.write_text("avpvs: /nonexistent/path\n")
    return _raises(pkg, "does not exist",
                   lambda: _load(pkg, yaml_path, prober, defaults_file=str(defaults)))


def codec_encoder_mismatch_rejected(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    _edit(yaml_path, lambda d: d["qualityLevelList"]["Q0"].update(videoCodec="vp9"))
    return _raises(pkg, "different codecs", lambda: _load(pkg, yaml_path, prober))


def unknown_filter_matches_nothing(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    tc = _load(pkg, yaml_path, prober, filter_pvses="P2SXM00_TYPO_XX")
    assert len(tc.pvses) == 0
    assert len(tc.get_required_segments()) == 0
    return tc


def real_corpus_yaml(pkg, tmp_path):
    """Every published example YAML vendored under tests/fixtures_corpus/
    (none is vendored today: both packages then parse nothing)."""
    corpus_dir = os.path.join(os.path.dirname(__file__), "fixtures_corpus")
    out = []
    for path in sorted(glob.glob(os.path.join(corpus_dir, "**", "*.yaml"), recursive=True)):
        raw = yaml.safe_load(open(path))
        db_id = raw["databaseId"]
        db_dir = tmp_path / db_id
        (db_dir / "srcVid").mkdir(parents=True, exist_ok=True)
        shutil.copy(path, db_dir / f"{db_id}.yaml")
        table = {}
        for entry in raw.get("srcList", {}).values():
            fname = entry["srcFile"] if isinstance(entry, dict) else entry
            (db_dir / "srcVid" / fname).touch()
            table[fname] = dict(width=1920, height=1080, pix_fmt="yuv420p",
                                r_frame_rate="60/1", video_duration=600.0,
                                avg_frame_rate="60/1")
        tc = _load(pkg, str(db_dir / f"{db_id}.yaml"), table)
        assert len(tc.pvses) == len(raw["pvsList"])
        assert tc.get_required_segments()
        out.append(tc)
    return out


def database_id_must_match_yaml_filename(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    _edit(yaml_path, lambda d: d.update(databaseId="P2SXM42"))
    return _raises(pkg, "do not match", lambda: _load(pkg, yaml_path, prober))


def yaml_must_live_in_matching_folder(pkg, tmp_path):
    yaml_path, prober = write_short_db(tmp_path)
    wrong = tmp_path / "not-the-db"
    (wrong / "srcVid").mkdir(parents=True, exist_ok=True)
    moved = wrong / os.path.basename(yaml_path)
    shutil.copy(yaml_path, moved)
    for f in os.listdir(os.path.dirname(yaml_path) + "/srcVid"):
        shutil.copy(os.path.join(os.path.dirname(yaml_path), "srcVid", f),
                    wrong / "srcVid" / f)
    return _raises(pkg, "rename your database folder", lambda: _load(pkg, str(moved), prober))


CASES = [short_db_parses, segment_dedup_across_pvses, long_db_planner_truncation_and_stall,
         buff_events_wallclock_vs_media, freeze_events_sorted_durations,
         event_divisibility_error, short_db_multi_segment_rejected, upscale_guard,
         pix_fmt_harmonization, filters, bad_ids_rejected, syntax_version_gate,
         complexity_ladder, cpvs_paths_and_formats, database_layout_created,
         mixed_src_duration_rejected, shipped_complexity_fixtures_drive_ladder,
         enc_options_flag_syntax_translation, enc_options_escapes_colon_values,
         defaults_override_remaps_paths, defaults_override_rejects_missing_path,
         codec_encoder_mismatch_rejected, unknown_filter_matches_nothing, real_corpus_yaml,
         database_id_must_match_yaml_filename, yaml_must_live_in_matching_folder]


def test_every_config_model_case_is_mirrored():
    import tests.test_config_model as original

    names = sorted(n[len("test_"):] for n in dir(original) if n.startswith("test_"))
    assert sorted(c.__name__ for c in CASES) == names


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_config_model_case_equal_in_both_packages(case, tmp_path):
    ref = db.outcome(case, db.JAX, tmp_path)
    ours = db.outcome(case, db.TORCH, tmp_path)
    assert ref[0] == "ok", ref  # the case's own checks hold for the JAX package
    assert ours == ref


def test_no_prober_raises_media_error(tmp_path):
    """Without a prober both packages probe the SRC through their libav
    boundary: this database's SRC is an empty placeholder, so the parse
    succeeds and a MediaError (never an ImportError) is deferred to what
    touches the SRC, classified `poison`; the segment accessors read
    segment files that do not exist and raise MediaError naming the
    open."""
    from processing_chain_tpu.io.medialib import MediaError as JMediaError
    from processing_chain_tpu_torch.io.medialib import MediaError

    yaml_path, _ = write_short_db(tmp_path)
    for pkg, err in ((db.JAX, JMediaError), (db.TORCH, MediaError)):
        src = pkg.TestConfig(yaml_path).srcs["SRC000"]
        assert isinstance(src.probe_error, err)
        with pytest.raises(err, match="unprobeable") as exc:
            src.stream_info
        assert exc.value.kind == "poison"
    tc = _load(db.TORCH, yaml_path, write_short_db(tmp_path)[1])
    seg = next(iter(tc.segments))
    for fn in (seg.get_video_frame_info, seg.get_audio_frame_info, seg.get_segment_info):
        with pytest.raises(MediaError, match="open_input"):
            fn()


def test_unprobeable_src_defers_as_poison(tmp_path):
    """A prober's MediaError defers to the units that touch the SRC, as in
    the JAX package: the parse succeeds, `stream_info` raises `poison`."""
    from processing_chain_tpu_torch.io.medialib import MediaError

    class Refusing:
        def src_info(self, path, sidecar=None):
            raise MediaError(f"cannot decode {os.path.basename(path)}")

        def duration(self, path, sidecar=None):
            raise AssertionError("an unprobeable SRC is never asked its duration")

    yaml_path, _ = write_short_db(tmp_path)
    tc = db.TORCH.TestConfig(yaml_path, prober=Refusing())
    src = tc.srcs["SRC000"]
    assert isinstance(src.probe_error, MediaError)
    assert {s.target_pix_fmt for s in tc.segments} == {"yuv420p"}
    with pytest.raises(MediaError, match="unprobeable") as exc:
        src.stream_info
    assert exc.value.kind == "poison"
