"""Domain object graph of a P.NATS Phase 2 test database (copy of
processing_chain_tpu/config/domain.py).

Parity targets (semantics, not code): reference lib/test_config.py —
QualityLevel :911-944, Coding :748-899, Event :602-641, Src :644-745,
Hrc :230-372, Segment :375-599, Pvs :52-227, PostProcessing :947-979.

Deliberate fixes over the reference (documented in SURVEY.md quirks list):
  * freeze-event durations are converted to float like stall events
    (reference test_config.py:620-621 keeps the raw YAML value);
  * all invariant violations raise ConfigError instead of sys.exit(1).

SRC probing goes through the injected prober (config/probe_api), the
libav one (io/probe.LibavProber) by default; the `Segment` frame and
segment info accessors read the port's io/probe.
"""

from __future__ import annotations

import os
import re
from fractions import Fraction
from typing import TYPE_CHECKING, Any, Optional

from ..utils.log import get_logger
from . import ids
from .errors import ConfigError

if TYPE_CHECKING:  # pragma: no cover
    from .test_config import TestConfig

ONLINE_CODERS = ["youtube", "bitmovin", "vimeo"]

#: encoders acceptable for each quality-level codec (reference :255-263)
_CODEC_ENCODERS = {
    "h264": {"libx264", "h264_nvenc"},
    "h265": {"libx265", "hevc_nvenc"},
    "vp9": {"libvpx-vp9"},
    "av1": {"libaom-av1"},
}


class QualityLevel:
    """One rung of the bitrate/resolution ladder (reference :911-944)."""

    def __init__(self, ql_id: str, test_config: "TestConfig", data: dict) -> None:
        self.ql_id = ql_id
        self.test_config = test_config
        self.index = data["index"]
        self.video_codec = data["videoCodec"]
        self.video_bitrate = data.get("videoBitrate")
        self.width = int(data["width"])
        self.height = int(data["height"])
        self.fps = data["fps"]

        if self.width % 2 or self.height % 2:
            raise ConfigError(
                f"width and height in QualityLevel {ql_id} must be divisible by 2"
            )

        self.audio_codec = data.get("audioCodec")
        self.audio_bitrate = data.get("audioBitrate")
        self.video_crf = int(data["videoCrf"]) if "videoCrf" in data else None
        self.video_qp = int(data["videoQp"]) if "videoQp" in data else None

        self.hrcs: set[Hrc] = set()

    def __repr__(self) -> str:
        return f"<QualityLevel {self.ql_id}, Index {self.index}>"


class Coding:
    """Encoder configuration shared by HRCs (reference :748-899)."""

    def __init__(self, coding_id: str, test_config: "TestConfig", data: dict) -> None:
        log = get_logger()
        self.coding_id = coding_id
        self.test_config = test_config
        self.coding_type = data["type"]

        self.is_online: Optional[bool] = None
        self.crf = None
        self.qp = None
        self.passes: Optional[int] = None
        self.cpu_used = data.get("cpuUsed", 6)
        self.forced_pix_fmt = data.get("pixFmt")

        if self.coding_type == "audio":
            self.encoder = data["encoder"]
            return
        if self.coding_type != "video":
            raise ConfigError(
                f"Wrong coding type {self.coding_type!r} in coding {coding_id}: "
                "must be 'audio' or 'video'"
            )

        self.encoder = data["encoder"]
        self.is_online = self.encoder.casefold() in ONLINE_CODERS

        if self.encoder.casefold() in ("youtube", "vimeo"):
            self.protocol = data["protocol"]
            return

        self.max_gop = data.get("maxGop")
        self.min_gop = data.get("minGop")
        if self.encoder.casefold() != "bitmovin":
            if "passes" in data:
                self.passes = int(data["passes"])
                if self.passes not in (1, 2):
                    raise ConfigError(
                        f"only 1-pass or 2-pass encoding allowed in coding {coding_id}"
                    )
            elif "crf" in data:
                self.crf = data["crf"]
            elif "qp" in data:
                self.qp = data["qp"]
            else:
                log.warning(
                    "number of passes not specified in coding %s, assuming 2", coding_id
                )
                self.passes = 2

        # rate-control / GOP knobs with reference defaults (:806-821)
        self.speed = data.get("speed", 1)
        self.quality = data.get("quality", "good")
        self.scenecut = bool(data.get("scenecut", True))
        self.iframe_interval = (
            int(data["iFrameInterval"]) if "iFrameInterval" in data else None
        )
        self.bframes: Optional[int] = None
        self.preset = data.get("preset")
        self.minrate_factor = _opt_float(data, "minrateFactor")
        self.maxrate_factor = _opt_float(data, "maxrateFactor")
        self.bufsize_factor = _opt_float(data, "bufsizeFactor")
        # absolute minrate/maxrate/bufsize: parsed for dialect parity but
        # consumed by NOTHING — faithful to the reference, which parses
        # them (test_config.py:873-880) and never reads them anywhere
        # (lib/ffmpeg.py uses only the *Factor variants, :135-140)
        self.minrate = _opt_float(data, "minrate")
        self.maxrate = _opt_float(data, "maxrate")
        self.bufsize = _opt_float(data, "bufsize")
        self.enc_options = data.get("enc_options")

        if "profile" in data:
            log.warning("Setting profile in %s is not supported anymore.", coding_id)
        if self.iframe_interval is None and not self.is_online:
            log.warning(
                "Constant iFrame-Interval not set in coding %s, not recommended!",
                coding_id,
            )
        if "bframes" in data:
            if self.encoder == "libvpx-vp9":
                log.warning(
                    "VP9 does not have B-frames, ignoring setting in coding %s",
                    coding_id,
                )
            else:
                self.bframes = int(data["bframes"])
                if self.bframes < 0:
                    raise ConfigError("bframes must be >= 0")
        if self.speed not in (0, 1, 2, 3, 4):
            raise ConfigError("speed must be between 0 and 4")
        if self.quality not in ("good", "best"):
            raise ConfigError("quality must be 'good' or 'best'")
        if self.encoder != "libvpx-vp9" and (
            bool(self.maxrate_factor) ^ bool(self.bufsize_factor)
        ):
            raise ConfigError(
                f"if either maxrateFactor or bufsizeFactor is set, both must be "
                f"specified in coding {coding_id}"
            )

    def __repr__(self) -> str:
        return f"<Coding {self.coding_id}>"


def _opt_float(data: dict, key: str) -> Optional[float]:
    return float(data[key]) if key in data else None


class YoutubeCoding:
    """Dummy coding slot for the online path (reference :902-908)."""

    def __init__(self, coding_id: str, test_config: "TestConfig") -> None:
        self.coding_id = coding_id
        self.test_config = test_config
        self.coding_type = "video"
        self.encoder = "youtube"
        self.is_online = True
        self.forced_pix_fmt = None

    def __repr__(self) -> str:
        return f"<Coding {self.coding_id}>"


class Event:
    """One playout event in an HRC's event list (reference :602-641)."""

    def __init__(self, event_type: str, quality_level: Any, duration: Any) -> None:
        self.event_type = event_type
        self.quality_level = quality_level
        self.hrc: Optional[Hrc] = None

        self.uses_src_duration = duration == "src_duration"
        if self.uses_src_duration:
            self.duration: Any = "src_duration"
        elif event_type in ("stall", "freeze"):
            # stall/freeze events may have fractional durations
            self.duration = float(duration)
        else:
            if not float(duration).is_integer():
                raise ConfigError(
                    "All non-stalling events must have an integer duration, "
                    f"got {duration!r}"
                )
            self.duration = int(duration)

    def set_duration(self, duration: Any) -> None:
        try:
            self.duration = float(duration)
        except (TypeError, ValueError) as exc:
            raise ConfigError(
                f"Tried to set duration of Event {self} to {duration!r}"
            ) from exc

    def __repr__(self) -> str:
        return f"<Event {self.event_type}, {self.quality_level}, {self.duration}s>"


class Src:
    """A source video (reference :644-745)."""

    def __init__(self, src_id: str, test_config: "TestConfig", data: Any) -> None:
        self.src_id = src_id
        self.test_config = test_config
        self.pvses: set[Pvs] = set()
        self.segments: set[Segment] = set()
        self.duration: Optional[float] = None
        self._stream_info: Optional[dict] = None
        #: deferred probe failure (docs/ROBUSTNESS.md): a SRC whose
        #: bytes the decoder rejects must not fail the WHOLE config
        #: parse — it fails the units that touch it, when they touch it
        self.probe_error: Optional[BaseException] = None
        #: stat signature (size, mtime_ns) of the bytes the deferred
        #: verdict was issued against: a REPLACED upload (the re-arm
        #: workflow) must earn a fresh probe on a long-lived parse, not
        #: inherit the old bytes' conviction
        self._probe_stat: Optional[tuple] = None

        if isinstance(data, str):
            self.filename = data
            self.is_youtube = False
            self.youtube_url = None
        else:
            self.filename = data["srcFile"]
            self.youtube_url = data["youtubeUrl"]
            self.is_youtube = True

        src_path = test_config.get_src_vid_path()
        local_path = test_config.get_src_vid_local_path()
        if isinstance(src_path, list):
            # multi-folder SRC search (reference :663-674)
            folder = next(
                (p for p in src_path if os.path.exists(os.path.join(p, self.filename))),
                src_path[-1],
            )
        else:
            folder = src_path
        self.file_path = os.path.join(folder, self.filename)
        # the probe sidecar lives next to the SRC when writable, else in the
        # database-local srcVid folder (reference :669-684)
        if _is_writable_dir(folder):
            self.info_path = os.path.join(folder, self.filename + ".yaml")
        elif _is_writable_dir(local_path):
            self.info_path = os.path.join(local_path, self.filename + ".yaml")
        else:
            raise ConfigError(
                "Not possible to write info.yaml for SRC, all directories read-only"
            )

    def locate_src_file(self) -> None:
        """Resolve file_path, falling back to the database-local srcVid folder
        (reference :708-721)."""
        if not os.path.exists(self.file_path):
            local = os.path.join(
                self.test_config.get_src_vid_local_path(), self.filename
            )
            if not os.path.exists(local):
                raise ConfigError(
                    f"SRC {self.filename} does not exist in "
                    f"{self.test_config.get_src_vid_local_path()} nor "
                    f"{self.test_config.get_src_vid_path()}"
                )
            get_logger().debug("SRC %s found in local srcVid folder", self.filename)
            self.file_path = local

    def _stat_sig(self) -> Optional[tuple]:
        try:
            st = os.stat(self.file_path)
            return (st.st_size, st.st_mtime_ns)
        except OSError:
            return None

    def locate_and_get_info(self) -> None:
        from ..io.medialib import MediaError

        if self._stream_info is not None:
            return  # one probe per Src, even across its PVSes
        if self.probe_error is not None and \
                self._stat_sig() == self._probe_stat:
            return  # same bytes, same deferred verdict
        healing = self.probe_error is not None
        self.locate_src_file()
        try:
            self._stream_info = self.test_config.prober.src_info(
                self.file_path, self.info_path
            )
            self.probe_error = None
            if healing:
                # the repaired bytes may disagree with the yuv420p
                # stand-in the parse minted for the unprobeable SRC
                # (Segment._set_pix_fmt): re-derive from the live probe
                # so plans minted after the heal carry honest knobs
                for seg in self.segments:
                    seg._set_pix_fmt()
        except MediaError as exc:
            # DEFERRED: a hostile/corrupt SRC must poison only the
            # units that reference it, not 400 every request against
            # the database (serve) or kill a whole batch run at parse.
            # Consumers hit the classified re-raise in `stream_info`.
            self.probe_error = exc
            self._probe_stat = self._stat_sig()
            get_logger().warning(
                "SRC %s is unprobeable (%s) — deferring the failure to "
                "the units that touch it", self.filename,
                str(exc)[:200],
            )

    @property
    def stream_info(self) -> dict:
        """The probed video-stream info. For an unprobeable SRC this
        raises the deferred verdict — classified `poison` (the decoder
        rejected the BYTES; retrying them is futile, serve quarantines
        the content digest) with the path forensics every media error
        carries (docs/ROBUSTNESS.md)."""
        if self._stream_info is None and self.probe_error is not None:
            from ..io.medialib import MediaError

            if self._stat_sig() != self._probe_stat:
                # the bytes changed since the verdict (repaired upload
                # on a long-lived cached parse): re-probe before
                # re-raising a conviction about bytes that are gone. A
                # re-probe that fails in a NEW way (file deleted, …)
                # falls through to the deferred-verdict raise below.
                try:
                    self.locate_and_get_info()
                except Exception:  # noqa: BLE001 - heal is best-effort
                    pass
            if self._stream_info is not None:
                return self._stream_info
            raise MediaError(
                f"SRC {self.file_path} is unprobeable: "
                f"{str(self.probe_error)[:500]}",
                kind="poison",
            ) from self.probe_error
        if self._stream_info is None:
            from ..io.medialib import MediaError

            raise MediaError(
                f"SRC {self.file_path} was never probed "
                "(locate_and_get_info not called)"
            )
        return self._stream_info

    @stream_info.setter
    def stream_info(self, value: Optional[dict]) -> None:
        self._stream_info = value

    def uses_10_bit(self) -> bool:
        pix_fmt = self.stream_info["pix_fmt"]
        return "10" in pix_fmt and pix_fmt != "yuv410p"

    def get_duration(self) -> float:
        if self.duration is None:
            if self.probe_error is not None:
                self.stream_info  # raises the deferred classified verdict
            self.duration = float(
                self.test_config.prober.duration(self.file_path, self.info_path)
            )
        return self.duration

    def get_fps(self) -> float:
        return float(Fraction(str(self.stream_info["r_frame_rate"])))

    def get_src_file_path(self) -> str:
        return self.file_path

    def get_src_file_name(self) -> str:
        return self.filename

    def exists(self) -> bool:
        return os.path.isfile(self.file_path)

    def __repr__(self) -> str:
        return f"<{self.src_id}, File: {self.filename}>"


def _is_writable_dir(path: str) -> bool:
    """Reference test_config.py:43-49 probes with a TemporaryFile; os.access
    is equivalent for our purposes and does not touch the directory."""
    return os.path.isdir(path) and os.access(path, os.W_OK)


class Hrc:
    """A hypothetical reference circuit: codec + event list (reference :230-372)."""

    def __init__(
        self,
        hrc_id: str,
        test_config: "TestConfig",
        hrc_type: str,
        video_coding: Any,
        audio_coding: Any,
        event_list: list[Event],
        segment_duration: Any,
    ) -> None:
        self.hrc_id = hrc_id
        self.test_config = test_config
        self.hrc_type = hrc_type
        self.video_coding = video_coding
        self.audio_coding = audio_coding
        self.event_list = event_list

        for event in event_list:
            if event.event_type in ("stall", "freeze", "youtube"):
                continue
            codec = event.quality_level.video_codec
            encoder = video_coding.encoder
            allowed = _CODEC_ENCODERS.get(codec)
            if allowed is None:
                raise ConfigError(
                    f"Unknown video codec {codec!r} in HRC {hrc_id}"
                )
            if encoder not in allowed and encoder.casefold() not in ONLINE_CODERS:
                raise ConfigError(
                    f"In HRC {hrc_id}, quality level {event.quality_level} and "
                    f"video coding {video_coding} specify different codecs"
                )

        # segment duration resolution (reference :271-285)
        if segment_duration == "src_duration":
            self.segment_duration: Any = "src_duration"
        elif segment_duration is not None:
            self.segment_duration = int(segment_duration)
        else:
            first = event_list[0]
            if first.event_type in ("stall", "freeze"):
                raise ConfigError(
                    f"HRC {hrc_id}: cannot take segment duration from first event "
                    "because it is a stalling/freezing event; specify a default "
                    "segmentDuration for the test"
                )
            self.segment_duration = first.duration

        self.pvses: set[Pvs] = set()
        self.quality_levels: set[QualityLevel] = set()
        self.segments: set[Segment] = set()

        self.buffer_events: list = (
            self.get_buff_events_media_time() if self.has_buffering() else []
        )

    def has_buffering(self) -> bool:
        return any(e.event_type in ("stall", "freeze") for e in self.event_list)

    has_stalling = has_buffering

    def has_framefreeze(self) -> bool:
        return any(e.event_type == "freeze" for e in self.event_list)

    def get_buff_events_media_time(self) -> list:
        """Buff events for .buff files in media time (reference :312-333):
        freezes → sorted list of durations; stalls → [media_time, duration]
        pairs where media time advances only through non-stall events."""
        if self.has_framefreeze():
            return sorted(
                e.duration for e in self.event_list if e.event_type == "freeze"
            )
        events = []
        if self.has_buffering():
            media_t: float = 0
            for e in self.event_list:
                if e.event_type == "stall":
                    events.append([media_t, e.duration])
                else:
                    media_t += e.duration
        return events

    def get_buff_events_wallclock_time(self) -> list:
        """Stall events as [wallclock_time, duration]: wallclock advances
        through every event including the stalls (reference :338-350)."""
        events = []
        if self.has_buffering():
            wall_t: float = 0
            for e in self.event_list:
                if e.event_type == "stall":
                    events.append([wall_t, e.duration])
                wall_t += e.duration
        return events

    def get_long_hrc_duration(self) -> float:
        return sum(float(e.duration) for e in self.event_list)

    def get_max_res(self) -> tuple[int, int]:
        widths = [0] + [
            e.quality_level.width
            for e in self.event_list
            if e.event_type not in ("stall", "freeze")
        ]
        heights = [0] + [
            e.quality_level.height
            for e in self.event_list
            if e.event_type not in ("stall", "freeze")
        ]
        return max(widths), max(heights)

    def __repr__(self) -> str:
        return f"<{self.hrc_id}>"


class Segment:
    """One encodeable unit: SRC × quality level × time range (reference :375-599).

    Filename grammar (the cache key of the whole chain, reference :482-512):
    <db>_<src>_<ql>_<coding>_<seq04>_<start>-<end>.<ext>
    """

    def __init__(
        self,
        index: int,
        src: Src,
        quality_level: QualityLevel,
        video_coding: Any,
        audio_coding: Any,
        start_time: float,
        duration: float,
    ) -> None:
        self.index = index
        self.src = src
        self.test_config = src.test_config
        self.quality_level = quality_level
        self.video_coding = video_coding
        self.audio_coding = audio_coding
        self.start_time = start_time
        self.duration = duration
        self.end_time = start_time + duration

        self.video_frame_info = None
        self.audio_frame_info = None
        self.segment_info = None

        self.target_pix_fmt: Optional[str] = None
        self.target_video_bitrate = None
        self._set_pix_fmt()
        if self.quality_level.video_bitrate:
            self._set_target_video_bitrate()

        self.filename = self.get_filename()
        self.file_path = os.path.join(
            self.test_config.get_video_segments_path(), self.filename
        )
        self.tmp_path = os.path.join(
            self.test_config.get_avpvs_path(), "tmp_" + self.filename + ".avi"
        )

    def _set_pix_fmt(self) -> None:
        """Harmonize the SRC pixel format to the encode target
        (reference :447-480): 444/422/rgb → yuv422p, 420 → yuv420p,
        '10le' suffix for 10-bit SRCs, forced overrides last."""
        if self.src.is_youtube:
            self.target_pix_fmt = "yuv420p"
            return
        if self.src.probe_error is not None:
            # unprobeable SRC (deferred poison, Src.stream_info): a
            # deterministic stand-in — this segment never encodes; its
            # units fail classified the moment a stage touches the
            # bytes, and the plan needs SOME total pixel format so the
            # serve front door can enqueue them (docs/ROBUSTNESS.md)
            self.target_pix_fmt = "yuv420p"
            return
        src_pix_fmt = self.src.stream_info["pix_fmt"]
        if "444" in src_pix_fmt or "422" in src_pix_fmt or "rgb" in src_pix_fmt:
            self.target_pix_fmt = "yuv422p"
        elif "420" in src_pix_fmt:
            self.target_pix_fmt = "yuv420p"
        else:
            raise ConfigError(f"Unknown SRC pixel format: {src_pix_fmt!r}")
        if self.src.uses_10_bit():
            self.target_pix_fmt += "10le"
        if (
            self.quality_level.video_codec == "h264"
            and self.video_coding.encoder.casefold() == "bitmovin"
        ):
            self.target_pix_fmt = "yuv420p"
        if self.video_coding.forced_pix_fmt:
            self.target_pix_fmt = self.video_coding.forced_pix_fmt

    def _set_target_video_bitrate(self) -> None:
        """Complexity-ladder bitrate choice (reference :426-445): with the
        complexity CSV present, a 'low/high' videoBitrate pair selects by the
        SRC's complexity class (class > 1 → high)."""
        if self.test_config.is_complex():
            rungs = sorted(
                float(b) for b in str(self.quality_level.video_bitrate).split("/")
            )
            if len(rungs) > 1:
                level = self.test_config.complexity_dict[self.src.get_src_file_name()]
                self.target_video_bitrate = rungs[1] if level > 1 else rungs[0]
            else:
                self.target_video_bitrate = rungs[0]
        else:
            self.target_video_bitrate = self.quality_level.video_bitrate

    def uses_10_bit(self) -> Optional[bool]:
        if not self.target_pix_fmt:
            return None
        return "10" in self.target_pix_fmt and self.target_pix_fmt != "yuv410p"

    def get_filename(self) -> str:
        codec = self.quality_level.video_codec
        encoder = self.video_coding.encoder
        if codec in ("h264", "h265"):
            self.ext = "mp4"
        elif encoder == "youtube" and codec == "vp9":
            self.ext = "webm"
        elif encoder.casefold() == "bitmovin" and codec == "vp9":
            self.ext = "mkv"
        elif codec in ("vp9", "av1"):
            self.ext = "mp4"
        else:
            raise ConfigError(
                f"Wrong video codec for quality level {self.quality_level}"
            )
        return (
            "_".join(
                [
                    self.test_config.database_id,
                    self.src.src_id,
                    self.quality_level.ql_id,
                    self.video_coding.coding_id,
                    format(self.index, "04"),
                    f"{int(self.start_time)}-{int(self.end_time)}",
                ]
            )
            + "."
            + self.ext
        )

    def get_segment_file_path(self) -> str:
        return self.file_path

    def get_tmp_path(self) -> str:
        return self.tmp_path

    def get_logfile_name(self) -> str:
        return os.path.splitext(self.filename)[0] + ".log"

    def get_logfile_path(self) -> str:
        return os.path.join(self.test_config.get_logs_path(), self.get_logfile_name())

    def get_hash(self) -> str:
        return _sha1(self.file_path)

    def get_logfile_hash(self) -> str:
        return _sha1(self.get_logfile_path())

    def get_segment_duration(self) -> float:
        return self.duration

    def exists(self) -> bool:
        return os.path.isfile(self.file_path)

    def get_video_frame_info(self):
        if self.video_frame_info is None:
            from ..io import probe

            self.video_frame_info = probe.get_video_frame_info(self.file_path)
        return self.video_frame_info

    def get_audio_frame_info(self):
        if self.audio_frame_info is None:
            from ..io import probe

            self.audio_frame_info = probe.get_audio_frame_info(self.file_path)
        return self.audio_frame_info

    def get_segment_info(self):
        if self.segment_info is None:
            from ..io import probe

            self.segment_info = probe.get_segment_info(
                self.file_path, target_video_bitrate=self.target_video_bitrate
            )
        return self.segment_info

    def _key(self) -> tuple:
        # `index` is part of identity: it is in the FILENAME, so two
        # content-equal segments with different indexes are distinct
        # artifacts (each referenced by its own HRC's plan). The
        # reference dedups by full command string — filename included —
        # so its cross-HRC dedup also merges only equal-index segments.
        # (Found by a randomized planner sweep: two HRCs with different
        # segmentDuration histories both truncating against SRC end
        # produce the same (src, ql, coding, start, duration) at
        # DIFFERENT indexes; deduping them left one HRC's segment file
        # never encoded.)
        return (
            self.src,
            self.quality_level,
            self.video_coding,
            self.audio_coding,
            self.index,
            self.start_time,
            self.duration,
        )

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Segment) and self._key() == other._key()

    def __lt__(self, other: "Segment") -> bool:
        return (
            self.src.src_id,
            self.start_time,
            self.quality_level.ql_id,
            self.duration,
        ) < (other.src.src_id, other.start_time, other.quality_level.ql_id, other.duration)

    def __repr__(self) -> str:
        return (
            f"<Segment {self.index:04d} of {self.src.src_id}, "
            f"{self.start_time}-{self.end_time}, {self.quality_level.ql_id}>"
        )


def _sha1(path: str) -> str:
    import hashlib

    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Pvs:
    """A processed video sequence: SRC × HRC (reference :52-227)."""

    def __init__(
        self, pvs_id: str, test_config: "TestConfig", src: Src, hrc: Hrc
    ) -> None:
        self.pvs_id = pvs_id
        self.test_config = test_config
        self.src = src
        self.hrc = hrc
        self.segments: list[Segment] = []

        # the upscale gate needs probed geometry; an unprobeable SRC
        # (deferred poison, see Src.stream_info) skips it — the units
        # fail classified when a stage touches the bytes instead of
        # failing the whole parse here
        if not src.is_youtube and src.probe_error is None:
            max_width, _ = hrc.get_max_res()
            src_width = src.stream_info["width"]
            if src_width < max_width:
                raise ConfigError(
                    f"PVS {pvs_id} uses {hrc.hrc_id}, which specifies a quality "
                    f"level with maximum width {max_width}, but {src} is only "
                    f"{src_width} wide and would have to be upscaled."
                )

    def is_online(self) -> bool:
        return any(s.video_coding.is_online for s in self.segments)

    def has_buffering(self) -> bool:
        return self.hrc.has_buffering()

    has_stalling = has_buffering

    def has_framefreeze(self) -> bool:
        return self.hrc.has_framefreeze()

    def get_buff_events_media_time(self):
        return self.hrc.get_buff_events_media_time()

    def get_buff_events_wallclock_time(self):
        return self.hrc.get_buff_events_wallclock_time()

    # --- artifact paths (reference :77-146) ---

    def get_avpvs_wo_buffer_file_path(self) -> str:
        return os.path.join(
            self.test_config.get_avpvs_path(), self.pvs_id + "_concat_wo_buffer.avi"
        )

    def get_tmp_wo_audio_path(self) -> str:
        return os.path.join(
            self.test_config.get_avpvs_path(), self.pvs_id + "_concat_wo_audio.avi"
        )

    def get_avpvs_file_path(self) -> str:
        return os.path.join(self.test_config.get_avpvs_path(), self.pvs_id + ".avi")

    def get_avpvs_file_list(self) -> str:
        return os.path.join(
            self.test_config.get_avpvs_path(), self.pvs_id + "_tmp_filelist.txt"
        )

    def get_cpvs_file_path(self, context: str = "pc", rawvideo: bool = False) -> str:
        if context == "pc":
            ext = ".mkv" if rawvideo else ".avi"
        else:
            ext = ".mp4"
        cpvs_name = self.pvs_id + "_" + context[0:2].upper() + ext
        if not re.match(ids.REGEX_CPVS_ID, cpvs_name):
            raise ConfigError(f"CPVS ID {cpvs_name} does not match regex")
        return os.path.join(self.test_config.get_cpvs_path(), cpvs_name)

    def get_preview_file_path(self) -> str:
        return os.path.join(
            self.test_config.get_cpvs_path(), self.pvs_id + "_preview.mov"
        )

    def get_logfile_name(self) -> str:
        return self.pvs_id + ".log"

    def get_logfile_path(self) -> str:
        return os.path.join(self.test_config.get_logs_path(), self.get_logfile_name())

    # --- pixel-format plumbing (reference :172-227) ---

    def get_pix_fmt_for_avpvs(self) -> str:
        fmts = {seg.target_pix_fmt for seg in self.segments}
        if len(fmts) > 1:
            raise ConfigError(
                f"Segments for PVS {self} use different target pixel formats"
            )
        return next(iter(fmts))

    _CPVS_FORMAT_MAP = {
        "yuv420p": ("rawvideo", "uyvy422"),
        "yuv422p": ("rawvideo", "uyvy422"),
        "yuv420p10le": ("v210", "yuv422p10le"),
        "yuv422p10le": ("v210", "yuv422p10le"),
    }

    def get_vcodec_and_pix_fmt_for_cpvs(self, rawvideo: bool = False) -> tuple[str, str]:
        avpvs_format = self.get_pix_fmt_for_avpvs()
        if rawvideo:
            return ("rawvideo", avpvs_format)
        if avpvs_format not in self._CPVS_FORMAT_MAP:
            raise ConfigError(
                f"Cannot use input pixel format {avpvs_format!r} for CPVS {self}"
            )
        return self._CPVS_FORMAT_MAP[avpvs_format]

    def __repr__(self) -> str:
        return f"<PVS {self.pvs_id}>"


class PostProcessing:
    """A viewing-context render target for CPVS (reference :947-979)."""

    TYPES = ("pc", "tablet", "mobile", "hd-pc-home", "uhd-pc-home")

    def __init__(self, test_config: "TestConfig", data: dict) -> None:
        self.test_config = test_config
        self.processing_type = data["type"]
        if self.processing_type not in self.TYPES:
            raise ConfigError(
                f"Wrong post processing type {self.processing_type!r}, must be "
                f"one of {self.TYPES}"
            )
        try:
            self.display_width = int(data["displayWidth"])
            self.display_height = int(data["displayHeight"])
            self.coding_width = int(data["codingWidth"])
            self.coding_height = int(data["codingHeight"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ConfigError(f"Missing or wrong data in post processing: {exc}") from exc

        if self.display_width != self.coding_width:
            raise ConfigError("Post processing must have same coding and display width")
        if self.processing_type == "pc" and (
            self.display_height != self.coding_height
            or self.display_width != self.coding_width
        ):
            raise ConfigError(
                "PC post processing must have same coding and display width/height"
            )
        self.display_frame_rate = data.get("displayFrameRate", 60)

    def __repr__(self) -> str:
        return f"<PostProcessing {self.processing_type.upper()}>"
