"""Port parity: the segment planner (processing_chain_tpu_torch/config/
test_config.TestConfig._create_required_segments) against the JAX
package's, on the CPU, with StaticProber.

The three properties of tests/test_planner_properties.py, each checked on
the port's plan and held equal to the JAX package's on every example; then
a seeded sweep of random databases (tests/_torch_db.random_database),
every fifth one broken in one place: an equal description of every
parsed object (segment sets by filename, duration, quality level and
index; every Pvs attribute), or the same error class and message."""

import textwrap

import pytest
from hypothesis import given, settings, strategies as st

from tests import _torch_db as db

SRC_INFO = {"width": 1920, "height": 1080, "pix_fmt": "yuv420p", "r_frame_rate": "24/1",
            "video_codec": "ffv1"}
_QLS = textwrap.dedent("""\
    qualityLevelList:
      Q0: {index: 0, videoCodec: h264, videoBitrate: 500, width: 960, height: 540, fps: 24, audioCodec: aac, audioBitrate: 128}
      Q1: {index: 1, videoCodec: h264, videoBitrate: 2000, width: 1920, height: 1080, fps: 24, audioCodec: aac, audioBitrate: 128}
    codingList:
      VC01: {type: video, encoder: libx264, passes: 1, iFrameInterval: 2}
      AC01: {type: audio, encoder: aac}
    srcList:
      SRC000: SRC000.avi
    """)  # noqa: E501
_PP = ("postProcessingList:\n  - {type: pc, displayWidth: 1920, displayHeight: 1080, "
       "codingWidth: 1920, codingHeight: 1080}\n")


def _write(tmp_path, seg_dur, hrc_events, db_id="P2LTR00") -> str:
    """A long database of one SRC and one HRC per event list."""
    db_dir = tmp_path / db_id
    (db_dir / "srcVid").mkdir(parents=True, exist_ok=True)
    (db_dir / "srcVid" / "SRC000.avi").write_bytes(b"")
    hrcs, pvs = [], []
    for k, events in enumerate(hrc_events):
        lines = "\n".join(f"      - [{q}, {d}]" for q, d in events)
        hrcs.append(f"  HRC{k:03d}:\n    videoCodingId: VC01\n    audioCodingId: AC01\n"
                    f"    eventList:\n{lines}")
        pvs.append(f"  - {db_id}_SRC000_HRC{k:03d}")
    text = (f"databaseId: {db_id}\nsyntaxVersion: 6\ntype: long\nsegmentDuration: {seg_dur}\n"
            + _QLS + "hrcList:\n" + "\n".join(hrcs) + "\npvsList:\n" + "\n".join(pvs) + "\n"
            + _PP)
    path = db_dir / f"{db_id}.yaml"
    path.write_text(text)
    return str(path)


def _both(yaml_path, src_duration):
    table = {"SRC000.avi": {**SRC_INFO, "video_duration": float(src_duration)}}
    ref, ours = db.load_both(yaml_path, table)
    assert ours == ref
    tc = db.TORCH.TestConfig(yaml_path, prober=db.prober(db.TORCH, table))
    return ref, tc


@settings(max_examples=30, deadline=None)
@given(
    seg_dur=st.integers(1, 5),
    event_plan=st.lists(st.tuples(st.integers(0, 1), st.integers(1, 3)), min_size=1, max_size=4),
    src_ratio=st.floats(0.3, 1.7),
)
def test_planner_tiles_and_truncates(tmp_path_factory, seg_dur, event_plan, src_ratio):
    tmp_path = tmp_path_factory.mktemp("prop")
    total_events = seg_dur * sum(n for _, n in event_plan)
    src_duration = max(0.5, round(total_events * src_ratio, 2))
    path = _write(tmp_path, seg_dur, [[(f"Q{q}", n * seg_dur) for q, n in event_plan]])
    ref, tc = _both(path, src_duration)
    assert ref[0] == "ok"
    (pvs,) = tc.pvses.values()
    segs = pvs.segments
    played = min(float(total_events), src_duration)
    assert segs
    t = 0.0
    for s in segs:
        assert s.start_time == pytest.approx(t, abs=1e-9)
        assert s.duration > 0
        t += s.duration
    assert t == pytest.approx(played, abs=1e-6)
    for s in segs[:-1]:
        assert s.duration == pytest.approx(seg_dur)
    assert segs[-1].duration <= seg_dur + 1e-9
    assert [s.index for s in segs] == list(range(len(segs)))


@settings(max_examples=15, deadline=None)
@given(
    seg_dur=st.integers(1, 4),
    event_plan=st.lists(st.tuples(st.integers(0, 1), st.integers(1, 2)), min_size=1, max_size=3),
)
def test_planner_dedups_identical_plans(tmp_path_factory, seg_dur, event_plan):
    tmp_path = tmp_path_factory.mktemp("prop")
    total = seg_dur * sum(n for _, n in event_plan)
    events = [(f"Q{q}", n * seg_dur) for q, n in event_plan]
    ref, tc = _both(_write(tmp_path, seg_dur, [events, events]), float(total))
    assert ref[0] == "ok"
    pvs_a, pvs_b = tc.pvses.values()
    assert len(pvs_a.segments) == len(pvs_b.segments)
    assert len(tc.get_required_segments()) == len(pvs_a.segments)
    assert {s.filename for s in tc.get_required_segments()} == \
        {s.filename for s in pvs_a.segments}


@settings(max_examples=15, deadline=None)
@given(seg_dur=st.integers(2, 5), extra=st.integers(1, 10))
def test_planner_rejects_nondivisible_durations(tmp_path_factory, seg_dur, extra):
    if extra % seg_dur == 0:
        extra += 1
    tmp_path = tmp_path_factory.mktemp("prop")
    ref, ours = db.load_both(_write(tmp_path, seg_dur, [[("Q0", extra)]]),
                             {"SRC000.avi": {**SRC_INFO, "video_duration": 60.0}})
    assert ref[:2] == ("error", "ConfigError") and "does not match" in ref[2]
    assert ours == ref


SWEEP = 48


@pytest.mark.parametrize("seed", range(SWEEP))
def test_random_database_equal_in_both_packages(seed, tmp_path):
    fault = db.FAULTS[(seed // 5) % len(db.FAULTS)] if seed % 5 == 4 else None
    db_id = f"P2SXM{seed:02d}" if seed % 2 else f"P2LTR{seed:02d}"
    data, table = db.random_database(seed, db_id, fault)
    path = db.write_database(tmp_path, data, table)
    ref, ours = db.load_both(path, table, complexity_csv_dir=db.complexity_dir(tmp_path))
    assert ours == ref
    if fault is None:
        assert ref[0] == "ok", ref
        assert ref[1]["segments"] and ref[1]["pvses"]
    else:
        assert ref[:2] == ("error", "ConfigError"), (fault, ref)
