"""chain-profile: summarize one profile capture in the terminal (copy of
processing_chain_tpu/tools/chain_profile.py).

    python -m processing_chain_tpu_torch tools chain-profile DIR [--stamp S] [--list]

Reads the merged Chrome trace (profile_<ts>.trace.json) and the resource
timeseries (resources_<ts>.json) the profiler wrote, and renders:

  * per-lane busy seconds (host / decode / device / transfer / encode) —
    where the wall time went, by execution resource,
  * the top spans per lane by total time,
  * resource peaks (RSS, pool bytes, queue depths, device memory),
  * bottleneck verdicts per stage when the run also wrote its telemetry
    (`telemetry.write_outputs`: metrics + events under the same stamp).

The trace itself opens in chrome://tracing or https://ui.perfetto.dev, as
does the torch.profiler trace under device_<ts>/; this summary is the
part an operator reads over ssh.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Optional, Sequence

_TRACE_RE = re.compile(r"profile_(?P<stamp>.+)\.trace\.json$")


class ProfileError(ValueError):
    """No loadable profile artifacts in the directory."""


def list_stamps(directory: str) -> list[str]:
    """Capture stamps, oldest first by artifact mtime (stamps embed an
    unpadded pid/seq — lexicographic order lies, same as report.py)."""
    entries = []
    for path in glob.glob(os.path.join(directory, "profile_*.trace.json")):
        m = _TRACE_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            entries.append((os.path.getmtime(path), m.group("stamp")))
        except OSError:
            continue
    return [stamp for _, stamp in sorted(entries)]


def load_profile(directory: str, stamp: Optional[str] = None) -> dict:
    """{stamp, trace, resources?, metrics?, events_path?} for one capture."""
    if not os.path.isdir(directory):
        raise ProfileError(f"not a directory: {directory}")
    stamps = list_stamps(directory)
    if stamp is None:
        if not stamps:
            raise ProfileError(
                f"no profile_<ts>.trace.json in {directory} — was the run "
                "started with --profile?"
            )
        stamp = stamps[-1]
    elif stamp not in stamps:
        raise ProfileError(f"no profile_{stamp}.trace.json in {directory}")
    out: dict = {"stamp": stamp, "directory": directory}
    trace_path = os.path.join(directory, f"profile_{stamp}.trace.json")
    try:
        with open(trace_path) as f:
            out["trace"] = json.load(f)
    except (OSError, ValueError) as exc:
        # a torn write (SIGKILL mid-dump, full disk) gets the clean
        # error path, not a raw traceback
        raise ProfileError(f"cannot load {trace_path}: {exc}") from exc
    # sidecar artifacts are optional AND tolerated when torn — the trace
    # summary must still render (same stance as report.load_run)
    for key, fname in (("resources", f"resources_{stamp}.json"),
                       ("metrics", f"metrics_{stamp}.json")):
        path = os.path.join(directory, fname)
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    out[key] = json.load(f)
            except (OSError, ValueError):
                pass
    events_path = os.path.join(directory, f"events_{stamp}.jsonl")
    if os.path.isfile(events_path):
        out["events_path"] = events_path
    return out


def lane_summary(trace: dict) -> dict[str, dict]:
    """{lane: {busy_s, spans, top: [(name, total_s, count)]}} from the
    trace's complete ("X") events."""
    lanes: dict[str, dict] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "host")
        lane = lanes.setdefault(cat, {"busy_s": 0.0, "spans": 0, "by_name": {}})
        dur_s = float(ev.get("dur", 0)) / 1e6
        lane["busy_s"] += dur_s
        lane["spans"] += 1
        entry = lane["by_name"].setdefault(ev.get("name", "?"), [0.0, 0])
        entry[0] += dur_s
        entry[1] += 1
    for lane in lanes.values():
        lane["top"] = sorted(
            ((name, t, n) for name, (t, n) in lane["by_name"].items()),
            key=lambda item: -item[1],
        )[:8]
        del lane["by_name"]
    return lanes


def render(profile: dict) -> str:
    lines = [f"chain-profile {profile['stamp']}  ({profile['directory']})"]
    lanes = lane_summary(profile["trace"])
    if lanes:
        lines.append("")
        lines.append("lanes (busy seconds by execution resource):")
        order = ("host", "decode", "device", "transfer", "encode", "events")
        for lane in sorted(lanes, key=lambda c: (
            order.index(c) if c in order else len(order), c
        )):
            if lane == "events":
                continue
            info = lanes[lane]
            lines.append(
                f"  {lane:<9} {info['busy_s']:9.3f}s over {info['spans']} spans"
            )
            for name, total, count in info["top"][:4]:
                lines.append(f"      {name[:52]:<52} {total:8.3f}s  x{count}")
    else:
        lines.append("  (trace has no complete spans)")

    res = profile.get("resources")
    if res:
        from ..telemetry.profiling import format_resource_peaks, resource_peaks

        lines.append("")
        lines.append(
            f"resources ({res.get('n_samples', 0)} samples @ "
            f"{res.get('interval_s', '?')}s):"
        )
        lines.extend(
            f"  {l}" for l in format_resource_peaks(resource_peaks(res))
        )

    if profile.get("metrics") is not None:
        from ..telemetry.events import read_jsonl
        from ..telemetry.profiling import attribute_run

        events = (
            read_jsonl(profile["events_path"])
            if profile.get("events_path") else []
        )
        verdicts = attribute_run(profile["metrics"], events)
        if verdicts:
            lines.append("")
            lines.append("bottleneck verdicts:")
            for stage, v in verdicts.items():
                contributors = ", ".join(
                    f"{c['component']} {c['pct']}%" for c in v["contributors"]
                ) or "no measured contributors"
                note = "  (insufficient data)" if v.get("insufficient_data") else ""
                lines.append(f"  {stage}: {v['verdict']}{note} — {contributors}")
                if v.get("missing"):
                    lines.append(
                        f"      unmeasured components: {', '.join(v['missing'])}"
                    )
    else:
        lines.append("")
        lines.append(
            "(no metrics_<ts>.json under this stamp — run with "
            "`--telemetry DIR --profile DIR` for bottleneck verdicts)"
        )
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools chain-profile",
        description="Summarize a profile capture "
        "(merged trace + resources + verdicts)"
    )
    parser.add_argument("directory", help="the run's --profile DIR")
    parser.add_argument(
        "--stamp", default=None,
        help="specific capture stamp (default: latest in the directory)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list capture stamps and exit"
    )
    args = parser.parse_args(argv)
    if args.list:
        for stamp in list_stamps(args.directory):
            print(stamp)
        return 0
    try:
        profile = load_profile(args.directory, args.stamp)
    except ProfileError as exc:
        print(f"chain-profile: {exc}")
        return 1
    print(render(profile), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
