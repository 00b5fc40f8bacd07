"""Design plots for database YAML configs (copy of
processing_chain_tpu/tools/plots.py). A host tool: it reads YAML and
draws with matplotlib, imported only when a plot is drawn.

Parity targets:
  * `plot_long` — reference util/plot_config_long.py:145-296: one row per
    HRC, a rectangle per segment colored by frame height, grey bars for
    stall events, plus design-rule warnings (first chunk ≥ 5 s, last chunk
    ≥ 10 s for long videos, chunk durations divisible by the segment
    duration).
  * `plot_short` — reference util/plot_config_short.py:62-154: frame-height
    vs bitrate scatter on sqrt/log-scaled axes, optionally one plot per
    codec (`-codec-wise`).

Both operate on the raw YAML (no SRC probing required) so they can be run on
a design file before any media exists; `plot_short` also accepts an already
parsed TestConfig. Warnings are returned as structured records (and logged)
instead of bare prints, so the checks are unit-testable.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, Optional, Sequence

import yaml

from ..utils.log import get_logger

#: frame-height bands and their colors (reference plot_config_long.py:106-121)
HEIGHT_BANDS = (240, 360, 480, 540, 720, 1080, 1440, 2160)
BAND_COLORS = (
    "#800000", "#e6194b", "#f58231", "#ffe119",
    "#a6d96a", "#3cb44b", "#4393c3", "#2166ac",
)

_PLOT_PARAM = {
    "stall_height": 0.03,
    "v_offset": 0.2,
    "v_height_max": 0.5,
    "v_res_max": 2160,
    "label_offset": 0.025,
}

_STALL_IDS = ("buffering", "stall", "freeze")


def height_color(height: float) -> str:
    """Color for a frame height: first band ≥ height."""
    for band, color in zip(HEIGHT_BANDS, BAND_COLORS):
        if band >= height:
            return color
    return BAND_COLORS[-1]


def event_list_duration(event_list: Sequence[Sequence[Any]]) -> float:
    return float(sum(e[1] for e in event_list))


def design_warnings(
    hrc_id: str,
    event_list: Sequence[Sequence[Any]],
    video_duration: float,
    segment_duration: float = 0.0,
) -> list[str]:
    """Design-rule checks on one HRC's event list (reference
    plot_config_long.py:164-215). Returns human-readable warning strings."""
    warnings: list[str] = []
    media = [e for e in event_list if e[0] not in _STALL_IDS and e[1] != 0]
    if not media:
        return warnings
    if float(media[0][1]) < 5.0:
        warnings.append(f"HRC {hrc_id}: first chunk duration < 5 seconds")
    last = float(media[-1][1])
    if (last < 10.0 and video_duration > 60) or last < 5.0:
        warnings.append(f"HRC {hrc_id}: last chunk duration < 10 seconds")
    if segment_duration > 0:
        for event_id, duration in media:
            if (float(duration) / segment_duration) % 1 >= 1e-4:
                warnings.append(
                    f"HRC {hrc_id}: chunk {event_id} duration {duration} is "
                    f"not a multiple of segment duration {segment_duration:g}"
                )
    return warnings


def _load_config_data(config: Any) -> dict:
    """Accept a YAML path, a dict, or a parsed TestConfig."""
    if isinstance(config, str):
        with open(config) as f:
            return yaml.safe_load(f)
    if isinstance(config, dict):
        return config
    return config.data  # TestConfig


def plot_long(config: Any, out_file: Optional[str] = None) -> list[str]:
    """Render the HRC timeline SVG; returns all design warnings."""
    import matplotlib

    matplotlib.use("svg")
    from matplotlib.patches import Rectangle
    import matplotlib.pyplot as plt

    data = _load_config_data(config)
    ql_list = data["qualityLevelList"]
    hrc_list = data["hrcList"]
    segment_dur = float(data.get("segmentDuration", 1))
    video_duration = min(event_list_duration(h["eventList"]) for h in hrc_list.values())

    log = get_logger()
    all_warnings: list[str] = []

    fig = plt.figure(figsize=(min(video_duration / 6, 35), max(2, len(hrc_list))))
    ax = fig.add_subplot(111)
    labels: list[str] = []
    max_duration = 0.0

    for i, hrc_id in enumerate(sorted(hrc_list.keys())):
        event_list = hrc_list[hrc_id]["eventList"]
        hrc_seg_dur = float(hrc_list[hrc_id].get("segmentDuration", segment_dur))
        max_duration = max(max_duration, event_list_duration(event_list))
        y_offset = len(hrc_list) - i - 1

        warnings = design_warnings(hrc_id, event_list, video_duration, hrc_seg_dur)
        for w in warnings:
            log.warning("%s", w)
        all_warnings.extend(warnings)

        t = 0.0
        for event_id, duration in event_list:
            duration = float(duration)
            if duration == 0:
                continue
            if event_id in _STALL_IDS:
                ax.add_patch(Rectangle(
                    (t, y_offset + _PLOT_PARAM["v_offset"]), duration,
                    _PLOT_PARAM["stall_height"], fc="grey",
                ))
                t += duration
                continue
            ql = ql_list[event_id]
            height = ql["height"] * _PLOT_PARAM["v_height_max"] / _PLOT_PARAM["v_res_max"]
            color = height_color(ql["height"])
            # full segment rects, then the remainder — t always advances by
            # exactly `duration` so stall bars and the duration line stay
            # aligned even for chunks not divisible by the segment duration
            remaining = duration
            while remaining > 1e-9:
                width = min(hrc_seg_dur, remaining)
                ax.add_patch(Rectangle(
                    (t, y_offset + _PLOT_PARAM["v_offset"]), width, height,
                    fc=color, ec="grey",
                ))
                t += width
                remaining -= width
        labels.append(hrc_id)

    ax.set_yticks(
        [len(hrc_list) - i - 1 + _PLOT_PARAM["v_offset"] for i in range(len(labels))]
    )
    ax.set_yticklabels(labels, fontsize="x-small")
    ax.set_xlabel("time in seconds")
    ax.set_ylim([-0.1, len(hrc_list) + 1])
    ax.set_xlim([0, max_duration * 1.05])
    ax.plot([video_duration, video_duration], ax.get_ylim(), "-k", alpha=0.3)
    title = data.get("databaseId", "")
    if isinstance(config, str):
        title += " : " + os.path.basename(config)
    ax.set_title(title)

    from matplotlib.patches import Patch

    ax.legend(
        handles=[Patch(color=height_color(h), label=str(h)) for h in HEIGHT_BANDS],
        fontsize="x-small",
    )

    if out_file is None:
        base = os.path.splitext(config)[0] if isinstance(config, str) else "config"
        out_file = base + ".svg"
    fig.savefig(out_file)
    plt.close(fig)
    log.info("wrote %s", out_file)
    return all_warnings


def _first_media_quality(data: dict, hrc_id: str) -> Optional[tuple[str, dict]]:
    """(quality-level id, quality-level dict) of the HRC's first media event."""
    for event_id, _dur in data["hrcList"][hrc_id]["eventList"]:
        if event_id not in _STALL_IDS:
            return event_id, data["qualityLevelList"][event_id]
    return None


def plot_short(
    config: Any, out_file: Optional[str] = None, codec_wise: bool = False
) -> list[str]:
    """Height-vs-bitrate design scatter; returns the written file paths."""
    import matplotlib

    matplotlib.use("svg")
    import matplotlib.pyplot as plt
    import numpy as np

    data = _load_config_data(config)
    log = get_logger()
    if out_file is not None:
        base = os.path.splitext(out_file)[0]
    elif isinstance(config, str):
        base = os.path.splitext(config)[0]
    else:
        base = "config"

    warned_levels: set = set()

    def first_bitrate(ql_id: str, ql: dict) -> Optional[float]:
        # CRF/QP-coded quality levels have no videoBitrate; the reference
        # hard-KeyErrors on them (test_config.py:1481 via plot_config_
        # short.py:94) — here they are skipped, warned once per level
        if "videoBitrate" not in ql:
            if ql_id not in warned_levels:
                warned_levels.add(ql_id)
                log.warning(
                    "quality level %s has no videoBitrate (CRF/QP-coded), "
                    "skipping in bitrate plot", ql_id,
                )
            return None
        return float(str(ql["videoBitrate"]).split("/")[0])

    written: list[str] = []
    if codec_wise:
        codecs = ("vp9", "h264", "h265")
        by_codec: dict[str, tuple[list, list]] = {c: ([], []) for c in codecs}
        for hrc_id in data["hrcList"]:
            found = _first_media_quality(data, hrc_id)
            if found is None:
                continue
            ql_id, ql = found
            codec = ql.get("videoCodec", "h264")
            if codec not in by_codec:
                log.warning("unexpected video codec %s, ignoring", codec)
                continue
            rate = first_bitrate(ql_id, ql)
            if rate is None:
                continue
            by_codec[codec][0].append(ql["height"])
            by_codec[codec][1].append(rate)
        for codec in codecs:
            heights, bitrates = by_codec[codec]
            fig = plt.figure(figsize=(10, 10))
            ax = fig.add_subplot(111)
            ax.set_xticks([120, 240, 360, 480, 720, 1080, 2160])
            ax.scatter(heights, bitrates)
            ax.set_xlabel("frame height")
            ax.set_ylabel("bitrate in kbit/s")
            ax.grid(True)
            ax.set_title(codec)
            path = f"{base}_datarate-resolution_plot_{codec}.svg"
            fig.savefig(path)
            plt.close(fig)
            written.append(path)
            log.info("wrote %s", path)
        return written

    # single scatter on sqrt(height) / log(bitrate) axes (reference :62-100)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111)
    x_t = np.array([120, 240, 360, 480, 720, 1080, 2160])
    y_t = np.array([10.0 ** i for i in range(2, 6)])
    ax.set_xticks(np.sqrt(x_t))
    ax.set_xticklabels(x_t)
    ax.set_yticks(np.log(y_t))
    ax.set_yticklabels([int(y) for y in y_t])
    ax.set_xlim([math.sqrt(x_t[0]), math.sqrt(x_t[-1])])
    ax.set_ylim([math.log(y_t[0]), math.log(y_t[-1])])
    for hrc_id in data["hrcList"]:
        found = _first_media_quality(data, hrc_id)
        if found is None:
            continue
        ql_id, ql = found
        rate = first_bitrate(ql_id, ql)
        if rate is None:
            continue
        ax.scatter([math.sqrt(ql["height"])], [math.log(rate)], color="red")
    ax.set_xlabel("frame height")
    ax.set_ylabel("bitrate in kbit/s")
    path = out_file or base + ".svg"
    fig.savefig(path)
    plt.close(fig)
    log.info("wrote %s", path)
    return [path]


def build_parser(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser("plots", description="Database design plots")
    p.add_argument("config", help="database YAML file")
    p.add_argument("--kind", choices=("long", "short"), default="long",
                   help="timeline (long) or bitrate/resolution scatter (short)")
    p.add_argument("--codec-wise", action="store_true",
                   help="short only: one scatter per codec")
    p.add_argument("-o", "--output", default=None, help="output SVG path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.kind == "long":
        plot_long(args.config, args.output)
    else:
        plot_short(args.config, args.output, codec_wise=args.codec_wise)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
