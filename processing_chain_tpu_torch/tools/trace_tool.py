"""`tools trace` — reconstruct one request's cross-replica timeline.

The serve fleet's span journal (serve/spans.py) records every
transition a request's units ever took, per replica, durably; this
tool stitches those journals back into the story of one request —
including steals from SIGKILLed replicas and the fenced settles of
zombies — entirely from durable state (no replica needs to be alive).

    python -m processing_chain_tpu_torch tools trace show REQ --root DIR
        [--chrome FILE] [--json]
    python -m processing_chain_tpu_torch tools trace ls --root DIR [-n 20]

`REQ` is a request id (`req-…`) or a trace id (`tr-…`, or a
client-supplied trace). `--chrome FILE` additionally writes the
timeline as Chrome-trace JSON (chrome://tracing / Perfetto), through
the same trace writer the profiler uses (`telemetry/profiling.
build_chrome_trace`) — replicas render as threads, claim→settle
intervals as spans. Exit status: 0 on a complete (gapless) trace,
1 when the request is unknown, 3 when the chain has gaps.

The port's copy of processing_chain_tpu/tools/trace_tool.py; the
journals of either package's replicas read the same.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from ..utils.fsio import atomic_write_text
from ..utils.log import get_logger

#: phases worth calling out loudly in the rendered timeline
_SHOUT = {"steal": "STOLEN", "fenced": "FENCED", "requeue": "REQUEUED",
          "quarantine": "QUARANTINED", "revert": "REVERTED"}


def _fmt_ts(ts: float, t0: float) -> str:
    return f"+{max(0.0, ts - t0):9.3f}s"


def render_trace(trace: dict) -> str:
    """Human-readable cross-replica timeline (one line per span)."""
    lines: list[str] = []
    head = f"trace {trace.get('trace') or '?'} — request " \
           f"{trace.get('request')}"
    if trace.get("tenant"):
        head += f"  tenant {trace['tenant']}/{trace.get('priority')}"
    head += f"  state {trace.get('state') or '?'}"
    if trace.get("latency_ms") is not None:
        head += f"  e2e {trace['latency_ms']:.1f} ms"
    lines.append(head)
    t0 = trace.get("t0") or 0.0
    if trace.get("created_at"):
        lines.append(
            "submitted " + time.strftime(
                "%Y-%m-%d %H:%M:%S", time.localtime(trace["created_at"]))
        )
    if trace.get("warm_units"):
        lines.append(f"warm units (store hit at submit, no queue "
                     f"traffic): {trace['warm_units']}")
    for job_id, chain in sorted(trace.get("jobs", {}).items()):
        record = trace.get("records", {}).get(job_id, {})
        unit = record.get("unit") or "?"
        lines.append("")
        lines.append(
            f"  job {job_id}  unit {unit}  final "
            f"{record.get('state', '?')} "
            f"(epoch {record.get('settledEpoch', record.get('epoch'))})"
        )
        for span in chain:
            phase = span.get("phase", "?")
            mark = _SHOUT.get(phase, phase)
            detail = []
            if phase == "steal":
                detail.append(f"from {span.get('from_replica')}")
            if phase == "fenced":
                detail.append(
                    f"op {span.get('op')} held e{span.get('held_epoch')} "
                    f"vs current e{span.get('epoch')}")
            if span.get("queue_wait_s") is not None:
                detail.append(f"waited {span['queue_wait_s'] * 1e3:.1f} ms")
            if span.get("exec_s") is not None:
                detail.append(f"ran {span['exec_s'] * 1e3:.1f} ms")
            if span.get("warm"):
                detail.append("warm")
            if span.get("backoff_s"):
                detail.append(f"backoff {span['backoff_s']}s")
            if span.get("error"):
                detail.append(f"error {str(span['error'])[:60]!r}")
            lines.append(
                f"    {_fmt_ts(span.get('ts', t0), t0)}  "
                f"{mark:<11} e{span.get('epoch', 0):<3} "
                f"{span.get('replica', '?')}"
                + ("  (" + ", ".join(detail) + ")" if detail else "")
            )
    lines.append("")
    if trace.get("complete"):
        lines.append("trace: COMPLETE — every terminal unit has a "
                     "gapless span chain")
    else:
        lines.append("trace: INCOMPLETE")
        for violation in trace.get("violations", []):
            lines.append(f"  ! {violation}")
    return "\n".join(lines) + "\n"


def _cmd_show(args) -> int:
    from ..telemetry import fleet

    log = get_logger()
    req_ids = fleet.resolve_request_ids(args.root, args.ref)
    if not req_ids:
        log.error("trace: no request or trace %r under %s "
                  "(retention may have pruned it)", args.ref, args.root)
        return 1
    if len(req_ids) > 1:
        # a gateway-supplied trace id shared by several POSTs: the
        # trace is ALL of them — render each, never an arbitrary one
        log.info("trace: %r names %d requests; rendering all",
                 args.ref, len(req_ids))
    rc = 0
    for i, req_id in enumerate(req_ids):
        trace = fleet.assemble_trace(args.root, req_id)
        if not trace["found"]:
            log.error("trace: request %r has no doc and no spans",
                      req_id)
            rc = max(rc, 1)
            continue
        if args.json:
            print(json.dumps(trace, sort_keys=True))
        else:
            if i:
                print()
            print(render_trace(trace), end="")
        if args.chrome:
            # one file per request when the ref is shared
            path = args.chrome if len(req_ids) == 1 else \
                f"{args.chrome}.{req_id}"
            atomic_write_text(path, json.dumps(fleet.chrome_trace(trace)))
            log.info("trace: Chrome trace written to %s (open in "
                     "chrome://tracing or ui.perfetto.dev)", path)
        if not trace["complete"]:
            rc = max(rc, 3)
    return rc


def _cmd_ls(args) -> int:
    req_dir = os.path.join(args.root, "requests")
    rows: list[tuple] = []
    try:
        names = os.listdir(req_dir)
    except OSError as exc:
        get_logger().error("trace: cannot list %s: %s", req_dir, exc)
        return 1
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(req_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        rows.append((
            doc.get("created_at", 0.0), doc.get("request", name[:-5]),
            doc.get("trace") or "-", doc.get("tenant", "?"),
            doc.get("priority", "?"), doc.get("state", "?"),
            len(doc.get("units", {})),
        ))
    rows.sort(reverse=True)
    for created, req, trace_id, tenant, priority, state, units in \
            rows[:args.n]:
        stamp = time.strftime("%H:%M:%S", time.localtime(created))
        print(f"{stamp}  {req:<16} {trace_id:<22} "
              f"{tenant}/{priority:<13} {state:<7} {units:>4} units")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools trace",
        description="cross-replica request tracing over the serve span "
                    "journal (docs/TELEMETRY.md)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    show = sub.add_parser("show", help="reconstruct one request's "
                                       "timeline")
    show.add_argument("ref", help="request id (req-…) or trace id")
    show.add_argument("--root", required=True, help="serve root")
    show.add_argument("--chrome", default=None,
                      help="also write Chrome-trace JSON here")
    show.add_argument("--json", action="store_true",
                      help="print the raw assembled trace as JSON")
    ls = sub.add_parser("ls", help="recent requests with trace ids")
    ls.add_argument("--root", required=True, help="serve root")
    ls.add_argument("-n", type=int, default=20)
    args = parser.parse_args(list(argv) if argv is not None else None)
    return _cmd_show(args) if args.cmd == "show" else _cmd_ls(args)


if __name__ == "__main__":
    raise SystemExit(main())
