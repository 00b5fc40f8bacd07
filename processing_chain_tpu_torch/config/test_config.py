"""TestConfig: load a database YAML into the domain object graph (copy of
processing_chain_tpu/config/test_config.py).

Parity target: reference lib/test_config.py:982-1573 (TestConfig). The YAML
dialect is the public contract with existing databases: databaseId,
syntaxVersion (>= 6), type short|long, segmentDuration, qualityLevelList,
codingList, srcList, hrcList, pvsList, postProcessingList — plus the
database folder layout and the processingchain_defaults.yaml override file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import yaml

from ..utils.log import get_logger
from . import ids
from .domain import (
    ONLINE_CODERS,
    Coding,
    Event,
    Hrc,
    PostProcessing,
    Pvs,
    QualityLevel,
    Segment,
    Src,
    YoutubeCoding,
)
from .errors import ConfigError
from .probe_api import SrcProber, default_prober

REQUIRED_YAML_SYNTAX_VERSION = 6

#: database subfolders, the filesystem contract (reference :1095-1107)
_LAYOUT = (
    "avpvs",
    "cpvs",
    "videoSegments",
    "buffEventFiles",
    "qualityChangeEventFiles",
    "audioFrameInformation",
    "videoFrameInformation",
    "sideInformation",
    "logs",
)


class TestConfig:
    """A parsed test database: quality_levels / codings / srcs / hrcs /
    pvses dicts, post_processings list, and the derived `segments` set."""

    __test__ = False  # not a pytest class despite the name

    REGEX_DATABASE_ID = ids.REGEX_DATABASE_ID
    REGEX_QL_ID = ids.REGEX_QL_ID
    REGEX_CODING_ID = ids.REGEX_CODING_ID
    REGEX_SRC_ID = ids.REGEX_SRC_ID
    REGEX_HRC_ID = ids.REGEX_HRC_ID
    REGEX_PVS_ID = ids.REGEX_PVS_ID
    REGEX_CPVS_ID = ids.REGEX_CPVS_ID
    ONLINE_CODERS = ONLINE_CODERS

    def __init__(
        self,
        yaml_filename: str,
        filter_srcs: Optional[str] = None,
        filter_hrcs: Optional[str] = None,
        filter_pvses: Optional[str] = None,
        prober: Optional[SrcProber] = None,
        defaults_file: Optional[str] = None,
        complexity_csv_dir: Optional[str] = None,
    ) -> None:
        # abspath first: a bare relative filename run from inside the
        # database folder (`-c DB.yaml`) would otherwise see an empty
        # dirname and fail the folder-name gate (the reference has the
        # same flaw at :1080-1083; fixed here, outputs unaffected)
        yaml_filename = os.path.abspath(yaml_filename)
        self.yaml_file = yaml_filename
        self.filter_srcs = filter_srcs.split("|") if filter_srcs else []
        self.filter_hrcs = filter_hrcs.split("|") if filter_hrcs else []
        self.filter_pvses = filter_pvses.split("|") if filter_pvses else []
        self.prober = prober if prober is not None else default_prober()
        self.database_dir = os.path.dirname(yaml_filename)
        self.complex_bitrates = False
        # complexity CSVs live in util/complexityAnalysis at the repo root
        # (reference :1086, :1251-1253); overridable for tests
        self._complexity_dir = complexity_csv_dir or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "util",
            "complexityAnalysis",
        )
        self._defaults_file = defaults_file

        self._check_names()
        with open(self.yaml_file) as f_in:
            self.data = yaml.safe_load(f_in)
        self._load_paths()
        self._parse_data_from_yaml()
        if self.complex_bitrates:
            self._parse_complexity()
        self._create_required_segments()

    # ------------------------------------------------------------------ names

    def _check_names(self) -> None:
        """Filename/ID gate (reference :1063-1087)."""
        if not os.path.exists(self.yaml_file):
            raise ConfigError(f"YAML file {self.yaml_file} does not exist")
        self.yaml_basename = os.path.splitext(os.path.basename(self.yaml_file))[0]
        ids.validate("Database", self.yaml_basename, ids.REGEX_DATABASE_ID)
        self.db_dirname = os.path.basename(os.path.dirname(self.yaml_file))
        if (
            "P2STR00" not in self.yaml_basename
            and "P2LTR00" not in self.yaml_basename
            and self.yaml_basename != self.db_dirname
        ):
            raise ConfigError(
                "Database folder must have the same name as the YAML config "
                f"file; rename your database folder to {self.yaml_basename!r}"
            )
        if os.path.isfile(
            os.path.join(self._complexity_dir, "complexity_classification.csv")
        ):
            self.complex_bitrates = True

    # ------------------------------------------------------------------ paths

    def _load_paths(self) -> None:
        """Database folder layout + overrides (reference :1089-1160)."""
        log = get_logger()
        d = self.database_dir
        self.path_mapping: dict[str, Any] = {
            "srcVid": os.path.abspath(os.path.join(d, "../srcVid")),
            "srcVidLocal": os.path.join(d, "srcVid"),
            **{key: os.path.join(d, key) for key in _LAYOUT},
        }
        if ".." in self.path_mapping["avpvs"]:
            self.path_mapping["avpvs"] = str(
                (Path.cwd() / self.path_mapping["avpvs"]).resolve()
            )

        if not os.path.isdir(self.path_mapping["srcVid"]):
            log.warning(
                "Joint 'srcVid' folder %s does not exist; falling back to the "
                "'srcVid' folder inside %s",
                self.path_mapping["srcVid"],
                d,
            )
            self.path_mapping["srcVid"] = os.path.join(d, "srcVid")

        override_file = self._defaults_file
        if override_file is None:
            override_file = os.path.join(
                os.path.dirname(
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                ),
                "processingchain_defaults.yaml",
            )
        if os.path.isfile(override_file):
            with open(override_file) as f:
                overrides = yaml.safe_load(f)
            for key, path in (overrides or {}).items():
                if key not in self.path_mapping:
                    log.warning("%s is not a valid path identifier, ignoring", key)
                    continue
                paths = path if isinstance(path, list) else [path]
                for p in paths:
                    if not os.path.isdir(p):
                        raise ConfigError(
                            f"path {p}, as specified in {override_file}, does not exist"
                        )
                    if key != "srcVid" and not os.access(p, os.W_OK):
                        raise ConfigError(
                            f"path {p}, as specified in {override_file}, "
                            "is not writable"
                        )
                self.path_mapping[key] = path

        for key, path in self.path_mapping.items():
            if key != "srcVid" and not isinstance(path, list) and not os.path.isdir(path):
                log.debug("path %s does not exist; creating empty folder", path)
                os.makedirs(path, exist_ok=True)

    # ------------------------------------------------------------------ parse

    def _parse_data_from_yaml(self) -> None:
        """Build the object graph (reference :1259-1457)."""
        log = get_logger()
        self.database_id = self.data["databaseId"]

        if "syntaxVersion" in self.data:
            if self.data["syntaxVersion"] < REQUIRED_YAML_SYNTAX_VERSION:
                raise ConfigError(
                    "YAML syntaxVersion is outdated; required: "
                    f"{REQUIRED_YAML_SYNTAX_VERSION}"
                )
        else:
            log.warning("YAML file does not specify 'syntaxVersion'")

        ids.validate("Database", self.database_id, ids.REGEX_DATABASE_ID)
        if self.yaml_basename != self.database_id:
            raise ConfigError("Database ID and YAML filename do not match")

        self.type = self.data["type"]
        if self.type not in ("short", "long"):
            raise ConfigError("Database type must be 'short' or 'long'")

        if "segmentDuration" in self.data:
            self.default_segment_duration = self.data["segmentDuration"]
        elif self.type == "long":
            raise ConfigError(
                "A default segment duration must be defined for long tests "
                "using the 'segmentDuration' key (overridable per HRC)"
            )
        else:
            self.default_segment_duration = None

        self.quality_levels: dict[str, QualityLevel] = {}
        self.codings: dict[str, Any] = {}
        self.srcs: dict[str, Src] = {}
        self.hrcs: dict[str, Hrc] = {}
        self.pvses: dict[str, Pvs] = {}
        self.post_processings: list[PostProcessing] = []

        for ql_id, qdata in self.data["qualityLevelList"].items():
            ids.validate("Quality Level", ql_id, ids.REGEX_QL_ID)
            self.quality_levels[ql_id] = QualityLevel(ql_id, self, qdata)

        for coding_id, cdata in self.data["codingList"].items():
            ids.validate("Coding", coding_id, ids.REGEX_CODING_ID)
            self.codings[coding_id] = Coding(coding_id, self, cdata)
        if self.data["codingList"]:
            self.codings["youtube"] = YoutubeCoding("youtube", self)

        for src_id, sdata in self.data["srcList"].items():
            ids.validate("SRC", src_id, ids.REGEX_SRC_ID)
            if self.filter_srcs and src_id not in self.filter_srcs:
                log.info("skipping SRC %s", src_id)
                continue
            self.srcs[src_id] = Src(src_id, self, sdata)

        for hrc_id, hdata in self.data["hrcList"].items():
            ids.validate("HRC", hrc_id, ids.REGEX_HRC_ID)
            if self.filter_hrcs and hrc_id not in self.filter_hrcs:
                log.info("skipping HRC %s", hrc_id)
                continue
            self.hrcs[hrc_id] = self._parse_hrc(hrc_id, hdata)

        for pvs_id in self.data["pvsList"]:
            ids.validate("PVS", pvs_id, ids.REGEX_PVS_ID)
            if self.filter_pvses and pvs_id not in self.filter_pvses:
                log.info("skipping PVS %s", pvs_id)
                continue
            src_id = ids.src_id_of_pvs(pvs_id)
            hrc_id = ids.hrc_id_of_pvs(pvs_id)
            if (self.filter_srcs and src_id not in self.filter_srcs) or (
                self.filter_hrcs and hrc_id not in self.filter_hrcs
            ):
                log.info("skipping PVS %s (skipped SRC/HRC)", pvs_id)
                continue
            if src_id not in self.srcs:
                raise ConfigError(
                    f"PVS {pvs_id} specifies SRC {src_id} but it is not in srcList"
                )
            if hrc_id not in self.hrcs:
                raise ConfigError(
                    f"PVS {pvs_id} specifies HRC {hrc_id} but it is not in hrcList"
                )
            src, hrc = self.srcs[src_id], self.hrcs[hrc_id]
            src.locate_and_get_info()
            pvs = Pvs(pvs_id, self, src, hrc)
            self.pvses[pvs_id] = pvs
            src.pvses.add(pvs)
            hrc.pvses.add(pvs)

        for pdata in self.data["postProcessingList"]:
            self.post_processings.append(PostProcessing(self, pdata))
        if len(self.post_processings) > 1:
            log.warning("More than one post processing is not really supported!")

    def _parse_hrc(self, hrc_id: str, data: dict) -> Hrc:
        """One hrcList entry → Hrc (reference :1333-1408)."""
        def _coding(field: str):
            try:
                coding_id = data[field]
            except KeyError as exc:
                raise ConfigError(
                    f"HRC {hrc_id} is missing {field}"
                ) from exc
            try:
                return self.codings[coding_id]
            except KeyError as exc:
                # clean error where the reference crashes with a raw KeyError
                raise ConfigError(
                    f"HRC {hrc_id} references unknown coding {coding_id!r}"
                ) from exc

        video_coding = _coding("videoCodingId")
        audio_coding = _coding("audioCodingId") if self.type == "long" else None

        if "segmentDuration" in data:
            if "src_duration" in [e[1] for e in data["eventList"]]:
                raise ConfigError(
                    f"Cannot specify both segmentDuration and src_duration as "
                    f"event length in HRC {hrc_id}"
                )
            hrc_segment_duration = data["segmentDuration"]
        else:
            hrc_segment_duration = self.default_segment_duration

        event_list: list[Event] = []
        quality_level_list: list[Any] = []
        for event_data in data["eventList"]:
            if len(event_data) != 2:
                raise ConfigError(
                    f"Event data must consist of two elements: {event_data}"
                )
            if "youtube" in data["videoCodingId"]:
                hrc_type = "youtube"
                event_type = "youtube"
                quality_level: Any = event_data[0]  # YouTube itag
            else:
                hrc_type = "normal"
                name = str(event_data[0])
                if "Q" in name:
                    event_type = "quality_level"
                    try:
                        quality_level = self.quality_levels[name]
                    except KeyError as exc:
                        raise ConfigError(
                            f"HRC {hrc_id} event references unknown "
                            f"quality level {name!r}"
                        ) from exc
                elif "stall" in name:
                    event_type, quality_level = "stall", None
                elif "freeze" in name:
                    event_type, quality_level = "freeze", None
                else:
                    raise ConfigError(
                        f"Wrong event type {event_data[0]!r}: must be a quality "
                        "level ID, 'stall', or 'freeze'"
                    )
            event_duration = event_data[1]
            if event_duration == "src_duration":
                hrc_segment_duration = "src_duration"
            event_list.append(Event(event_type, quality_level, event_duration))
            quality_level_list.append(quality_level)

        if hrc_segment_duration == "src_duration" and any(
            e.event_type == "quality_level" and e.duration != "src_duration"
            for e in event_list
        ):
            raise ConfigError(
                f"HRC {hrc_id} mixes numeric event durations with "
                "src_duration segmenting; use src_duration for all events or "
                "set an explicit segmentDuration"
            )
        hrc = Hrc(
            hrc_id, self, hrc_type, video_coding, audio_coding, event_list,
            hrc_segment_duration,
        )
        for e in event_list:
            e.hrc = hrc
        for q in set(quality_level_list):
            hrc.quality_levels.add(q)
        for q in {q for q in quality_level_list if isinstance(q, QualityLevel)}:
            q.hrcs.add(hrc)
        return hrc

    # ------------------------------------------------------------- complexity

    def _parse_complexity(self) -> None:
        """Load the complexity CSVs into {src filename: class} (reference
        :1250-1257)."""
        import csv

        complexity: dict[str, int] = {}
        for name in (
            "complexity_classification.csv",
            "complexity_classification_validation.csv",
        ):
            path = os.path.join(self._complexity_dir, name)
            if not os.path.isfile(path):
                continue
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    complexity[row["file"]] = int(row["complexity_class"])
        self.complexity_dict = complexity

    # ---------------------------------------------------------------- planner

    def _create_required_segments(self) -> None:
        """The segment planner (reference :1162-1248): expand each PVS's event
        list into the deduplicated set of segments to encode, with
        divisibility checks, last-segment truncation against SRC length, and
        the short-database single-segment rule."""
        log = get_logger()
        self.segments: set[Segment] = set()

        for pvs in self.pvses.values():
            src_length: Optional[float] = None
            if not pvs.src.is_youtube:
                # an unprobeable SRC (deferred poison, config/domain.py
                # Src.stream_info) skips the advisory duration check —
                # its units fail classified at execution instead of
                # failing the whole parse here
                if pvs.hrc.event_list[0].duration != "src_duration" \
                        and pvs.src.probe_error is None:
                    src_length = float(pvs.src.get_duration())
                    total = sum(
                        e.duration
                        for e in pvs.hrc.event_list
                        if e.event_type == "quality_level"
                    )
                    if src_length < total:
                        log.warning(
                            "%s has a length of only %s, but events in %s sum "
                            "up to %s. Last event(s) will be cut.",
                            pvs.src, src_length, pvs, total,
                        )
                    elif src_length > total:
                        log.warning(
                            "%s is longer than the events specified in %s; "
                            "trimming will occur.",
                            pvs.src, pvs,
                        )
            else:
                log.warning(
                    "Cannot check duration of YouTube videos; make sure events "
                    "in %s sum up to the right duration.",
                    pvs,
                )

            t: float = 0
            seg_index = 0
            for event in pvs.hrc.event_list:
                if event.event_type != "quality_level":
                    continue
                if event.duration == "src_duration":
                    n_segments = 1
                else:
                    if pvs.hrc.segment_duration == "src_duration":
                        raise ConfigError(
                            f"HRC {pvs.hrc.hrc_id} mixes a numeric event "
                            f"duration ({event.duration}) with src_duration "
                            "segmenting; use src_duration for all events or "
                            "set an explicit segmentDuration"
                        )
                    if event.duration % pvs.hrc.segment_duration != 0:
                        raise ConfigError(
                            f"event duration {event.duration} does not match "
                            f"segment duration {pvs.hrc.segment_duration} in "
                            f"{pvs.hrc.hrc_id}"
                        )
                    n_segments = event.duration / pvs.hrc.segment_duration
                if self.type == "short" and n_segments > 1:
                    raise ConfigError(
                        f"Short databases only allow one segment, HRC "
                        f"{pvs.hrc} does not comply."
                    )

                for _ in range(int(n_segments)):
                    if pvs.hrc.segment_duration != "src_duration":
                        seg_duration = pvs.hrc.segment_duration
                        if src_length is not None and t + seg_duration > src_length:
                            seg_duration = src_length - t
                    else:
                        seg_duration = pvs.src.get_duration()
                    if seg_duration <= 0:
                        log.warning(
                            "Got a segment with duration <= 0 in PVS %s, skipping",
                            pvs,
                        )
                        continue
                    segment = Segment(
                        index=seg_index,
                        src=pvs.src,
                        quality_level=event.quality_level,
                        video_coding=pvs.hrc.video_coding,
                        audio_coding=pvs.hrc.audio_coding,
                        start_time=t,
                        duration=seg_duration,
                    )
                    t += seg_duration
                    seg_index += 1
                    pvs.segments.append(segment)
                    pvs.src.segments.add(segment)
                    pvs.hrc.segments.add(segment)
                    self.segments.add(segment)

    # ---------------------------------------------------------------- helpers

    def is_complex(self) -> bool:
        return self.complex_bitrates

    def is_short(self) -> bool:
        return self.type == "short"

    def is_long(self) -> bool:
        return self.type == "long"

    def get_pvs_ids(self):
        return self.pvses.keys()

    def get_required_segments(self) -> set[Segment]:
        return self.segments

    def get_bitrate(self, hrc: str) -> list:
        """Per-chunk bitrates for an HRC id (plotter helper, reference
        :1471-1482); with complexity ladders, the low rung."""
        q_levels = [e[0] for e in self.data["hrcList"][hrc]["eventList"]]
        if self.complex_bitrates:
            return [
                str(self.data["qualityLevelList"][q]["videoBitrate"]).split("/")[0]
                for q in q_levels
            ]
        return [self.data["qualityLevelList"][q]["videoBitrate"] for q in q_levels]

    def get_height(self, hrc: str) -> list:
        q_levels = [e[0] for e in self.data["hrcList"][hrc]["eventList"]]
        return [self.data["qualityLevelList"][q]["height"] for q in q_levels]

    # path accessors (reference :1502-1573)
    def get_src_vid_path(self):
        return self.path_mapping["srcVid"]

    def get_src_vid_local_path(self) -> str:
        return self.path_mapping["srcVidLocal"]

    def get_avpvs_path(self) -> str:
        return self.path_mapping["avpvs"]

    def get_cpvs_path(self) -> str:
        return self.path_mapping["cpvs"]

    def get_video_segments_path(self) -> str:
        return self.path_mapping["videoSegments"]

    def get_buff_event_files_path(self) -> str:
        return self.path_mapping["buffEventFiles"]

    def get_quality_change_event_files_path(self) -> str:
        return self.path_mapping["qualityChangeEventFiles"]

    def get_audio_frame_information_path(self) -> str:
        return self.path_mapping["audioFrameInformation"]

    def get_video_frame_information_path(self) -> str:
        return self.path_mapping["videoFrameInformation"]

    def get_side_information_path(self) -> str:
        return self.path_mapping["sideInformation"]

    def get_logs_path(self) -> str:
        return self.path_mapping["logs"]

    def __repr__(self) -> str:
        return repr(self.data)
