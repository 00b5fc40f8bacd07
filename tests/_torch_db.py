"""Shared helpers of the database-model parity tests (test_torch_config,
test_torch_planner, test_torch_plans): the two packages' config entry
points side by side, a plain-data description of a parsed database that
both packages' objects reduce to, and a seeded random database generator.

Both packages are run on the same YAML file in the same folder, one after
the other, so every path they derive is comparable as it is."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import yaml

import processing_chain_tpu.config as jconfig
import processing_chain_tpu_torch.config as tconfig
from processing_chain_tpu.models import segments as jseg
from processing_chain_tpu_torch.models import segments as tseg

JAX = SimpleNamespace(
    name="jax", config=jconfig, TestConfig=jconfig.TestConfig, ConfigError=jconfig.ConfigError,
    StaticProber=jconfig.StaticProber, enc_options_to_opts=jseg.enc_options_to_opts)
TORCH = SimpleNamespace(
    name="torch", config=tconfig, TestConfig=tconfig.TestConfig, ConfigError=tconfig.ConfigError,
    StaticProber=tconfig.StaticProber, enc_options_to_opts=tseg.enc_options_to_opts)
PACKAGES = (JAX, TORCH)


def prober(pkg, other) -> object:
    """`pkg`'s StaticProber over the table of `other` (a StaticProber of
    either package, or a plain {file: info} table)."""
    if isinstance(other, dict):
        return pkg.StaticProber(other)
    return pkg.StaticProber(other.table, other.default)


_ID_ATTRS = ("pvs_id", "hrc_id", "src_id", "coding_id", "ql_id")


def ref(x):
    """A value with every domain object replaced by its identity, so that
    the two packages' object graphs compare as data."""
    name = type(x).__name__
    for attr in _ID_ATTRS:
        if hasattr(x, attr) and name in ("Pvs", "Hrc", "Src", "Coding", "YoutubeCoding",
                                         "QualityLevel"):
            return (name, getattr(x, attr))
    if name == "Segment":
        return ("Segment", x.filename, x.index)
    if name == "Event":
        return ("Event", x.event_type, ref(x.quality_level), x.duration)
    if name == "TestConfig":
        return ("TestConfig", x.database_id)
    if name == "PostProcessing":
        return ("PostProcessing", x.processing_type)
    if isinstance(x, BaseException):
        return ("error", type(x).__name__, str(x))
    if isinstance(x, dict):
        return {k: ref(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [ref(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((ref(v) for v in x), key=repr)
    return x


def attrs(obj, skip=("test_config", "prober")) -> dict:
    return {k: ref(v) for k, v in vars(obj).items() if k not in skip}


def call(fn, *args, **kwargs):
    """("ok", value) or ("error", class name, message)."""
    try:
        return ("ok", ref(fn(*args, **kwargs)))
    except Exception as exc:  # noqa: BLE001 - the outcome is what is compared
        return ("error", type(exc).__name__, str(exc))


def describe_pvs(pvs) -> dict:
    out = attrs(pvs)
    for name in ("has_buffering", "has_framefreeze", "get_buff_events_media_time",
                 "get_buff_events_wallclock_time", "get_avpvs_wo_buffer_file_path",
                 "get_tmp_wo_audio_path", "get_avpvs_file_path", "get_avpvs_file_list",
                 "get_preview_file_path", "get_logfile_path", "get_pix_fmt_for_avpvs",
                 "is_online"):
        out[name] = call(getattr(pvs, name))
    for ctx in ("pc", "mobile", "tablet"):
        out[f"cpvs_{ctx}"] = call(pvs.get_cpvs_file_path, ctx)
    out["cpvs_pc_raw"] = call(pvs.get_cpvs_file_path, "pc", rawvideo=True)
    out["cpvs_format"] = call(pvs.get_vcodec_and_pix_fmt_for_cpvs)
    out["cpvs_format_raw"] = call(pvs.get_vcodec_and_pix_fmt_for_cpvs, rawvideo=True)
    return out


def describe(tc) -> dict:
    """Everything a parsed database holds, as plain data."""
    hrcs = {}
    for hid, h in tc.hrcs.items():
        d = attrs(h)
        d["events"] = [attrs(e) for e in h.event_list]
        d["max_res"] = call(h.get_max_res)
        d["long_duration"] = call(h.get_long_hrc_duration)
        hrcs[hid] = d
    srcs = {}
    for sid, s in tc.srcs.items():
        d = attrs(s)
        d["fps"] = call(s.get_fps)
        d["ten_bit"] = call(s.uses_10_bit)
        srcs[sid] = d
    segs = []
    for s in sorted(tc.segments, key=lambda s: (s.filename, s.index)):
        d = attrs(s)
        d["logfile"] = s.get_logfile_path()
        d["ten_bit"] = s.uses_10_bit()
        segs.append(d)
    return {
        "tc": attrs(tc, skip=("prober", "quality_levels", "codings", "srcs", "hrcs",
                              "pvses", "segments", "post_processings")),
        "short": tc.is_short(), "complex": tc.is_complex(),
        "pvs_ids": list(tc.get_pvs_ids()),
        "quality_levels": {k: attrs(v) for k, v in tc.quality_levels.items()},
        "codings": {k: attrs(v) for k, v in tc.codings.items()},
        "srcs": srcs, "hrcs": hrcs,
        "pvses": {k: describe_pvs(v) for k, v in tc.pvses.items()},
        "post_processings": [attrs(p) for p in tc.post_processings],
        "segments": segs,
    }


def plain(x):
    """`describe` every TestConfig inside a case's result."""
    if type(x).__name__ == "TestConfig":
        return describe(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def outcome(fn, *args, **kwargs):
    """("ok", plain result) or ("error", class name, message)."""
    try:
        return ("ok", plain(fn(*args, **kwargs)))
    except Exception as exc:  # noqa: BLE001 - the outcome is what is compared
        return ("error", type(exc).__name__, str(exc))


def load_both(yaml_path: str, table, **kwargs):
    """(JAX outcome, port outcome) of TestConfig on one YAML file."""
    return tuple(outcome(lambda p=pkg: p.TestConfig(yaml_path, prober=prober(p, table), **kwargs))
                 for pkg in PACKAGES)


# ---------------------------------------------------------------------------
# a seeded random database
# ---------------------------------------------------------------------------

_PIX_FMTS = ("yuv420p", "yuv420p", "yuv422p", "yuv444p", "yuv420p10le", "yuv422p10le", "rgb24")
_SRC_GEOS = ((3840, 2160), (1920, 1080), (1280, 720), (960, 540))
_SRC_FPS = ("60/1", "30/1", "25/1", "24/1", "50/1", "30000/1001")
_LADDER = ((320, 180), (640, 360), (960, 540), (1280, 720), (1920, 1080), (2560, 1440),
           (3840, 2160))
_CODECS = (("h264", "libx264"), ("h265", "libx265"), ("vp9", "libvpx-vp9"),
           ("av1", "libaom-av1"), ("h264", "h264_nvenc"), ("h265", "hevc_nvenc"))
#: one broken invariant each (`random_database`'s `fault`)
FAULTS = ("upscale", "divisibility", "unknown_ql", "codec_mismatch", "bad_event",
          "short_multi", "odd_width", "mixed_src_duration", "syntax", "unknown_src")


def random_database(seed: int, db_id: str, fault: str | None = None) -> tuple[dict, dict]:
    """(YAML mapping, {SRC file: probe info}) of a random database that
    passes every check, or, with `fault`, one that breaks exactly one.
    Each info dict also holds the SRC's complexity class, which
    `write_database` writes into a complexity CSV."""
    rng = np.random.default_rng(seed)
    kind = "short" if db_id[2] == "S" else "long"
    seg_dur = int(rng.choice([2, 4, 5])) if kind == "long" else None
    n_src = int(rng.integers(1, 4))
    duration = float(rng.choice([8.0, 10.0, 12.0, 20.0, 30.0]))
    srcs, table = {}, {}
    for k in range(n_src):
        w, h = _SRC_GEOS[int(rng.integers(len(_SRC_GEOS)))]
        fname = f"SRC{k:03d}.{rng.choice(['avi', 'mkv', 'mp4'])}"
        srcs[f"SRC{k:03d}"] = fname
        table[fname] = {"width": w, "height": h,
                        "pix_fmt": str(rng.choice(_PIX_FMTS)),
                        "r_frame_rate": str(rng.choice(_SRC_FPS)),
                        # the long planner truncates against it, the short
                        # one does not read it
                        "video_duration": duration + float(rng.choice([-3.5, 0.0, 0.0, 2.0])),
                        "video_codec": "ffv1",
                        "complexity_class": int(rng.integers(0, 4))}
    n_codec = int(rng.integers(1, 4))
    codings, families = {}, []
    for k in range(n_codec):
        codec, encoder = _CODECS[int(rng.integers(len(_CODECS)))]
        c = {"type": "video", "encoder": encoder, "iFrameInterval": int(rng.integers(1, 5))}
        rc = int(rng.integers(4))
        if rc == 0:
            c["passes"] = int(rng.integers(1, 3))
        elif rc == 1:
            c["crf"] = True
        elif rc == 2:
            c["qp"] = True
        if rng.random() < 0.3:
            c["bframes"] = int(rng.integers(0, 4))
        if rng.random() < 0.3:
            c["preset"] = str(rng.choice(["veryfast", "medium", "slow"]))
        if rng.random() < 0.3:
            c["maxrateFactor"] = 1.5
            c["bufsizeFactor"] = 2.0
        if rng.random() < 0.2:
            c["scenecut"] = False
        if rng.random() < 0.2:
            c["enc_options"] = "-tune zerolatency"
        codings[f"VC{k + 1:02d}"] = c
        families.append(codec)
    if kind == "long":
        codings["AC01"] = {"type": "audio", "encoder": "aac"}
    qls = {}
    n_ql = int(rng.integers(2, 6))
    ql_coding = {}  # each quality level takes one coding's codec family
    for k in range(n_ql):
        w, h = _LADDER[int(rng.integers(len(_LADDER)))]
        vc = f"VC{int(rng.integers(n_codec)) + 1:02d}"
        ql_coding[f"Q{k}"] = vc
        fps = str(rng.choice(["24", "30", "60", "original", "1/2"]))
        q = qls[f"Q{k}"] = {"index": k, "videoCodec": families[int(vc[2:]) - 1],
                            "width": w, "height": h,
                            "fps": int(fps) if fps.isdigit() else fps}
        bitrate = int(rng.choice([300, 800, 1500, 4000, 12000]))
        q["videoBitrate"] = f"{bitrate}/{2 * bitrate}" if rng.random() < 0.3 else bitrate
        q["videoCrf"] = int(rng.integers(18, 40))
        q["videoQp"] = int(rng.integers(18, 40))
        if kind == "long":
            q["audioCodec"] = "aac"
            q["audioBitrate"] = 128
    hrcs = {}
    n_hrc = int(rng.integers(2, 6))
    for k in range(n_hrc):
        vc = f"VC{int(rng.integers(n_codec)) + 1:02d}"
        levels = [q for q, c in ql_coding.items() if c == vc]
        if not levels:
            vc = ql_coding["Q0"]
            levels = [q for q, c in ql_coding.items() if c == vc]
        hrc = {"videoCodingId": vc}
        if kind == "long":
            hrc["audioCodingId"] = "AC01"
            events = []
            for _ in range(int(rng.integers(1, 4))):
                events.append([str(rng.choice(levels)), seg_dur * int(rng.integers(1, 4))])
                if rng.random() < 0.3:
                    events.append(["stall", float(rng.choice([0.5, 1.0, 2.5]))])
            if rng.random() < 0.15:
                events.insert(1, ["freeze", float(rng.choice([0.4, 1.5]))])
            if rng.random() < 0.2:
                hrc["segmentDuration"] = 1
        else:
            events = [[str(rng.choice(levels)), int(rng.choice([8, 10]))]]
            if rng.random() < 0.4:
                events.insert(0 if rng.random() < 0.5 else 1,
                              [str(rng.choice(["stall", "freeze"])),
                               float(rng.choice([0.5, 1.0, 2.0]))])
                if events[0][0] in ("stall", "freeze"):
                    hrc["segmentDuration"] = events[1][1]
        hrc["eventList"] = events
        hrcs[f"HRC{k:03d}"] = hrc
    pvs = []
    for sid, fname in srcs.items():
        for hid, hrc in hrcs.items():
            widest = max(qls[e[0]]["width"] for e in hrc["eventList"] if e[0][0] == "Q")
            if widest <= table[fname]["width"] and rng.random() < 0.8:
                pvs.append(f"{db_id}_{sid}_{hid}")
    if not pvs:  # the first SRC with its narrowest HRC
        sid, fname = next(iter(srcs.items()))
        hid = min(hrcs, key=lambda h: max(qls[e[0]]["width"] for e in hrcs[h]["eventList"]
                                           if e[0][0] == "Q"))
        table[fname]["width"] = max(table[fname]["width"], 3840)
        table[fname]["height"] = max(table[fname]["height"], 2160)
        pvs.append(f"{db_id}_{sid}_{hid}")
    pps = [{"type": "pc", "displayWidth": 1920, "displayHeight": 1080,
            "codingWidth": 1920, "codingHeight": 1080}]
    if rng.random() < 0.5:
        pps.append({"type": str(rng.choice(["mobile", "tablet"])), "displayWidth": 1280,
                    "displayHeight": 720, "codingWidth": 1280, "codingHeight": 720,
                    "displayFrameRate": 30})
    data = {"databaseId": db_id, "syntaxVersion": 6, "type": kind,
            "qualityLevelList": qls, "codingList": codings, "srcList": srcs,
            "hrcList": hrcs, "pvsList": pvs, "postProcessingList": pps}
    if seg_dur is not None:
        data["segmentDuration"] = seg_dur
    if fault is not None:
        _inject(data, table, fault, rng)
    return data, table


def _inject(data: dict, table: dict, fault: str, rng) -> None:
    first_pvs = data["pvsList"][0]
    sid, hid = first_pvs.split("_")[1:3]
    hrc = data["hrcList"][hid]
    q_event = next(e for e in hrc["eventList"] if e[0][0] == "Q")
    if fault == "upscale":
        table[data["srcList"][sid]]["width"] = data["qualityLevelList"][q_event[0]]["width"] - 2
    elif fault == "divisibility":
        hrc["segmentDuration"] = 3
        q_event[1] = 7
    elif fault == "unknown_ql":
        q_event[0] = "Q99"
    elif fault == "codec_mismatch":
        data["qualityLevelList"][q_event[0]]["videoCodec"] = "mpeg2"
    elif fault == "bad_event":
        hrc["eventList"].append(["rebuffer", 1.0])
    elif fault == "short_multi":
        data["type"] = "short"
        data.pop("segmentDuration", None)
        hrc["segmentDuration"] = 2
        q_event[1] = 8
    elif fault == "odd_width":
        data["qualityLevelList"][q_event[0]]["width"] += 1
    elif fault == "mixed_src_duration":
        hrc.pop("segmentDuration", None)
        hrc["eventList"] = [[q_event[0], 4], [q_event[0], "src_duration"]]
    elif fault == "syntax":
        data["syntaxVersion"] = 5
    elif fault == "unknown_src":
        data["pvsList"].append(f"{data['databaseId']}_SRC999_{hid}")


def write_database(root, data: dict, table: dict) -> str:
    """The database folder of `data` under `root`, with an empty file for
    each SRC and, in `complexity_dir(root)`, the complexity CSV of the
    SRCs that carry a class; returns the YAML path."""
    db_dir = os.path.join(str(root), data["databaseId"])
    os.makedirs(os.path.join(db_dir, "srcVid"), exist_ok=True)
    for fname in table:
        open(os.path.join(db_dir, "srcVid", fname), "wb").close()
    rows = [f"{f},1.0,{i['complexity_class']}" for f, i in table.items()
            if "complexity_class" in i]
    if rows:
        os.makedirs(complexity_dir(root), exist_ok=True)
        with open(os.path.join(complexity_dir(root), "complexity_classification.csv"),
                  "w") as f:
            f.write("file,complexity,complexity_class\n" + "\n".join(rows) + "\n")
    path = os.path.join(db_dir, data["databaseId"] + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return path


def complexity_dir(root) -> str:
    return os.path.join(str(root), "complexityAnalysis")
