"""chain-top: a refreshing terminal view of a live chain run (copy of
processing_chain_tpu/tools/chain_top.py).

Polls either the live HTTP endpoint (telemetry/live.py; `tools
chain-serve` serves one) or the atomically-rewritten `--status-file` JSON
and renders per-stage
progress bars with ETA, the in-flight task table with beat ages, and
the chain counters — `top` for the processing chain.

    python -m processing_chain_tpu_torch tools chain-top http://host:8080
    python -m processing_chain_tpu_torch tools chain-top /path/status.json --once

A URL source appends /status itself, so passing the server root is
enough. `--once` renders a single frame and exits (CI smoke, scripts);
otherwise it refreshes every `--interval` seconds until Ctrl-C, and
keeps the last good frame (with a note) across transient fetch errors
mid-run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

_BAR_WIDTH = 28


class StatusSourceError(OSError):
    """Status fetch failed (endpoint down, file missing/torn)."""


def fetch_status(source: str, timeout_s: float = 3.0) -> dict:
    """Load the status document from a URL (…/status appended unless the
    path already names an endpoint) or a status-file path."""
    if source.startswith(("http://", "https://")):
        url = source if source.endswith("/status") else source.rstrip("/") + "/status"
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode())
        except (urllib.error.URLError, TimeoutError, ValueError) as exc:
            raise StatusSourceError(f"cannot fetch {url}: {exc}") from exc
    try:
        with open(source) as f:
            return json.load(f)
    except OSError as exc:
        raise StatusSourceError(f"cannot read status file {source}: {exc}") from exc
    except ValueError as exc:
        # os.replace-atomic writers make this unreachable mid-rewrite;
        # a partial copy (scp'd file) still deserves a clean error
        raise StatusSourceError(f"status file {source} is not JSON: {exc}") from exc


def _bar(progress: Optional[float]) -> str:
    if progress is None:
        return "[" + "?" * _BAR_WIDTH + "]"
    filled = int(round(progress * _BAR_WIDTH))
    return "[" + "#" * filled + "-" * (_BAR_WIDTH - filled) + "]"


def _fmt_eta(eta_s) -> str:
    if eta_s is None:
        return "eta --"
    eta_s = float(eta_s)
    if eta_s >= 3600:
        return f"eta {eta_s / 3600:.1f}h"
    if eta_s >= 60:
        return f"eta {eta_s / 60:.1f}m"
    return f"eta {eta_s:.0f}s"


def _fmt_age(age_s: float) -> str:
    age_s = float(age_s)
    if age_s >= 3600:
        return f"{age_s / 3600:.1f}h"
    if age_s >= 60:
        return f"{age_s / 60:.1f}m"
    return f"{age_s:.0f}s"


def render(status: dict, note: str = "") -> str:
    """One full frame (plain text, no cursor control — the loop clears)."""
    lines: list[str] = []
    run = status.get("run", {})
    head = f"chain-top — pid {status.get('pid', '?')}"
    if run.get("name"):
        head += f"  run {run['name']}"
    head += f"  up {_fmt_age(status.get('uptime_s', 0.0))}"
    if note:
        head += f"  [{note}]"
    lines.append(head)
    if run.get("argv"):
        lines.append("  argv: " + " ".join(str(a) for a in run["argv"]))
    lines.append("")

    stages = status.get("stages", {})
    current = status.get("current_stage")
    lines.append("stages:")
    if not stages:
        lines.append("  (none started yet)")
    for stage in sorted(stages):
        s = stages[stage]
        state = s.get("state", "?")
        marker = ">" if stage == current else " "
        done = int(s.get("jobs_done", 0))
        planned = s.get("jobs_planned")
        frac = s.get("progress")
        jobs = f"{done}/{int(planned)}" if planned is not None else f"{done}/?"
        tail = f"{_fmt_eta(s.get('eta_s'))}" if state == "running" else state
        lines.append(
            f" {marker}{stage}  {_bar(frac)} "
            f"{(frac or 0.0) * 100:5.1f}%  jobs {jobs:>9}  "
            f"wall {_fmt_age(s.get('wall_s', 0.0)):>6}  {tail}"
        )
    lines.append("")

    tasks = status.get("tasks", [])
    lines.append(f"in flight ({len(tasks)}):")
    if not tasks:
        lines.append("  (idle)")
    for t in tasks[:20]:
        flags = "STALLED " if t.get("stalled") else ""
        flags += "CANCELLED " if t.get("cancelled") else ""
        prog = t.get("progress")
        prog_txt = f"{prog * 100:5.1f}%" if prog is not None else "     -"
        lines.append(
            f"  {t.get('kind', '?'):<10} {str(t.get('label', '?'))[:46]:<46} "
            f"age {_fmt_age(t.get('age_s', 0.0)):>6}  "
            f"beat {_fmt_age(t.get('beat_age_s', 0.0)):>6}  "
            f"{prog_txt}  {_fmt_eta(t.get('eta_s'))}  {flags}".rstrip()
        )
    if len(tasks) > 20:
        lines.append(f"  … and {len(tasks) - 20} more")

    serve = status.get("serve", {})
    if serve:
        # replica identity first: in a multi-replica fleet this is how
        # an operator tells which daemon the frame describes
        parts = [
            f"replica {serve.get('replica', '?')}",
            f"epoch {serve.get('replica_epoch', '?')}",
            f"pid {serve.get('pid', status.get('pid', '?'))}",
        ]
        queue = serve.get("queue", {})
        if queue:
            parts.append("queue " + " ".join(
                f"{k}={v}" for k, v in sorted(queue.items())))
        reqs = serve.get("requests", {})
        if reqs:
            parts.append("requests " + " ".join(
                f"{k}={v}" for k, v in sorted(reqs.items())))
        lines.append("")
        lines.append("serve: " + "  ".join(parts))

    counters = status.get("counters", {})
    if counters:
        lines.append("")
        lines.append(
            "counters: "
            f"decoded {int(counters.get('frames_decoded', 0))} frames, "
            f"encoded {int(counters.get('frames_encoded', 0))} frames "
            f"({counters.get('bytes_encoded', 0) / 1e6:.1f} MB)"
        )
    resources = status.get("resources", {})
    if resources:
        rss = resources.get("rss_bytes") or 0
        parts = [f"rss {rss / 1e6:.0f} MB"]
        if resources.get("cpu_percent") is not None:
            parts.append(f"cpu {resources['cpu_percent']:.0f}%")
        parts.append(
            f"pool {resources.get('pool_outstanding_bytes', 0) / 1e6:.0f}"
            f"+{resources.get('pool_free_bytes', 0) / 1e6:.0f} MB"
        )
        if resources.get("open_fds") is not None:
            parts.append(f"fds {resources['open_fds']}")
        for queue, depth in sorted(resources.get("queues", {}).items()):
            parts.append(f"q:{queue} {depth}")
        dev = resources.get("device_memory", {})
        if dev.get("bytes_in_use") is not None:
            parts.append(f"hbm {dev['bytes_in_use'] / 1e6:.0f} MB")
        lines.append("resources: " + "  ".join(parts))
    recent = status.get("recent", [])
    failed = [r for r in recent if r.get("status") not in ("ok", "")]
    if failed:
        lines.append("")
        lines.append(f"recent failures ({len(failed)}):")
        for r in failed[:5]:
            lines.append(
                f"  {r.get('status')}: {r.get('kind')} {r.get('label')}"
            )
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools chain-top",
        description="Refreshing terminal view of a live chain run "
        "(/status endpoint or --status-file JSON)"
    )
    parser.add_argument(
        "source",
        help="status source: http://host:port (the run's /status server) "
        "or a --status-file path",
    )
    parser.add_argument(
        "-i", "--interval", default=2.0, type=float,
        help="refresh period in seconds",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (for scripts/CI)",
    )
    args = parser.parse_args(argv)

    if args.once:
        print(render(fetch_status(args.source)), end="")
        return 0

    last_frame = None
    try:
        while True:
            note = ""
            try:
                frame = render(fetch_status(args.source))
                last_frame = frame
            except StatusSourceError as exc:
                if last_frame is None:
                    raise  # never reached the source at all: fail loudly
                note = f"stale: {exc}"
                frame = last_frame.rstrip("\n") + f"\n[{note}]\n"
            sys.stdout.write("\033[2J\033[H" + frame)
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
