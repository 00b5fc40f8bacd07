"""fleet-top: a refreshing terminal view of a chain-serve replica fleet.

`chain-top`'s fleet-shaped sibling: where chain-top watches ONE
process, fleet-top renders the merged view of every replica over one
serve root — who is alive (replica id, epoch, pid), the shared queue
and request truth from disk, span-journal traffic, and the SLO layer's
per-(tenant × priority) latency grades against the declared bands
(telemetry/catalog.SLO_BANDS).

    python -m processing_chain_tpu_torch tools fleet-top /srv/chain
    python -m processing_chain_tpu_torch tools fleet-top http://host:8790 --once

A directory source builds the view locally (telemetry/fleet.py —
works with every replica dead); a URL asks a live replica's /fleet
endpoint. `--once` renders one frame for scripts/CI.

The port's copy of processing_chain_tpu/tools/fleet_top.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from .chain_top import StatusSourceError, _fmt_age


def fetch_fleet(source: str, timeout_s: float = 5.0) -> dict:
    """The fleet document from a /fleet URL or built from a root dir."""
    if source.startswith(("http://", "https://")):
        url = source if source.endswith("/fleet") \
            else source.rstrip("/") + "/fleet"
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode())
        except (urllib.error.URLError, TimeoutError, ValueError) as exc:
            raise StatusSourceError(f"cannot fetch {url}: {exc}") from exc
    from ..telemetry import fleet

    return fleet.fleet_view(source)


def _fmt_cell(cell: dict) -> str:
    p50 = cell.get("p50")
    p99 = cell.get("p99")
    txt = f"n={cell.get('count', 0):<5} "
    txt += f"p50≤{p50 * 1e3:7.1f}ms " if p50 is not None else "p50      -  "
    txt += f"p99≤{p99 * 1e3:7.1f}ms " if p99 is not None else "p99      -  "
    ok = cell.get("ok")
    if ok is None:
        txt += "band -"
    else:
        within = cell.get("within_band")
        txt += f"band {cell.get('band_s')}s " \
               f"{within * 100:5.1f}% {'OK' if ok else 'BREACH'}"
    return txt


def render(view: dict, note: str = "") -> str:
    """One full frame (plain text; the loop clears the screen)."""
    lines: list[str] = []
    head = (f"fleet-top — {view.get('root', '?')}  "
            f"replicas {view.get('alive', 0)}/"
            f"{len(view.get('replicas', []))} alive")
    if note:
        head += f"  [{note}]"
    lines.append(head)
    lines.append("")
    lines.append("replicas:")
    if not view.get("replicas"):
        lines.append("  (none discovered — no serve-info files under "
                     "the root)")
    for rep in view.get("replicas", []):
        mark = "+" if rep.get("alive") else "x"
        ident = (f"{rep.get('replica', '?')} "
                 f"e{rep.get('replica_epoch', '?')} "
                 f"pid {rep.get('pid', '?')}")
        if rep.get("alive"):
            q = rep.get("queue", {})
            qtxt = " ".join(f"{k}={v}" for k, v in sorted(q.items())) \
                or "idle"
            extra = f"up {_fmt_age(rep.get('uptime_s', 0.0))}  {qtxt}"
            if rep.get("rss_bytes"):
                extra += f"  rss {rep['rss_bytes'] / 1e6:.0f} MB"
        else:
            extra = f"DEAD ({rep.get('error', '?')}, " \
                    f"info {rep.get('info_file')})"
            if rep.get("last_seen_s") is not None:
                extra += f"  last seen {_fmt_age(rep['last_seen_s'])} ago"
        lines.append(f" {mark} {ident:<44} {extra}")
    lines.append("")
    queue = view.get("queue", {})
    reqs = view.get("requests", {})
    lines.append(
        "shared root: queue "
        + (" ".join(f"{k}={v}" for k, v in sorted(queue.items()))
           or "(empty)")
        + "  requests "
        + (" ".join(f"{k}={v}" for k, v in sorted(reqs.items()))
           or "(none)")
    )
    span_stats = view.get("spans", {})
    if span_stats.get("total"):
        by_phase = span_stats.get("by_phase", {})
        tail_note = " (recent window)" if span_stats.get("sampled") else ""
        lines.append(
            f"spans: {span_stats['total']}{tail_note} "
            + " ".join(f"{k}={v}" for k, v in sorted(by_phase.items()))
        )
    heat = view.get("heat", {})
    if heat.get("total"):
        tail_note = " (recent window)" if heat.get("sampled") else ""
        lines.append(
            f"reads: {heat.get('reads', 0)}{tail_note} "
            f"full={heat.get('full', 0)} 304={heat.get('not_modified', 0)} "
            f"range={heat.get('range', 0)} "
            f"served={heat.get('bytes_served', 0) / 1e6:.1f}MB "
            f"evictions={heat.get('evictions', 0)} "
            f"regrets={heat.get('regrets', 0)}"
        )
    store_tiers = view.get("store_tiers", {})
    if store_tiers.get("tiers"):
        order = {"hot": 0, "warm": 1, "cold": 2}
        parts = []
        for name, t in sorted(store_tiers["tiers"].items(),
                              key=lambda kv: (order.get(kv[0], 9),
                                              kv[0])):
            parts.append(
                f"{name} hits={t.get('hits', 0)}"
                f"({t.get('hit_ratio', 0.0) * 100:.0f}%) "
                f"{t.get('bytes', 0) / 1e6:.1f}MB"
            )
        moves = sum(t.get("promotions", 0)
                    for t in store_tiers["tiers"].values())
        demotes = sum(t.get("demotions", 0)
                      for t in store_tiers["tiers"].values())
        lines.append(
            "tiers: " + "  ".join(parts)
            + f"  promotions={moves} demotions={demotes}"
        )
    stalls = view.get("stalls") or []
    if stalls:
        parts = []
        for s in stalls[:6]:
            stage = f"/{s['stage']}" if s.get("stage") else ""
            parts.append(
                f"{s.get('replica', '?')}:{s.get('task', '?')}{stage} "
                f"{s.get('incident', 'stalled')} "
                f"{_fmt_age(s.get('beat_age_s', 0.0))}"
            )
        more = f" (+{len(stalls) - 6})" if len(stalls) > 6 else ""
        lines.append("active stalls: " + "  ".join(parts) + more)
    alerts = (view.get("alerts") or {}).get("active") or []
    if alerts:
        parts = []
        for a in alerts[:6]:
            parts.append(
                f"{a.get('rule', '?')}[{a.get('severity', '?')}] "
                f"x{a.get('episodes', 1)}"
            )
        more = f" (+{len(alerts) - 6})" if len(alerts) > 6 else ""
        lines.append(f"ALERTS firing: {len(alerts)}  "
                     + "  ".join(parts) + more)
    scale = view.get("scale")
    if scale:
        reasons = ",".join(scale.get("reasons") or []) or "-"
        lines.append(
            f"scale signal: {scale.get('current', '?')}"
            f"→{scale.get('desired', '?')} replicas  "
            f"confidence {scale.get('confidence', 0.0):.2f}  "
            f"[{reasons}]"
        )
    mesh = view.get("mesh", {})
    if mesh.get("buckets"):
        parts = []
        for name, b in sorted(mesh["buckets"].items()):
            parts.append(
                f"{name} waves={b.get('waves', 0)} "
                f"waste={b.get('waste_fraction', 0.0) * 100:.1f}% "
                f"compiles={b.get('recompiles', 0)}"
            )
        lines.append("mesh: " + "  ".join(parts))
    fleet_cost = view.get("cost", {})
    if fleet_cost.get("tenants") or fleet_cost.get("rejected"):
        lines.append("")
        lines.append("cost (predicted vs observed seconds, "
                     "serve/cost.py):")
        for tenant, entry in sorted(fleet_cost.get("tenants",
                                                   {}).items()):
            lines.append(
                f"  {tenant or '(any)':<20} "
                f"predicted {entry.get('predicted_s', 0.0):9.1f}s  "
                f"observed {entry.get('observed_s', 0.0):9.1f}s"
            )
        err = fleet_cost.get("model_error")
        if err:
            lines.append(
                f"  model error: n={err['n']} "
                f"obs/pred p50≤{err['ratio_p50']} p95≤{err['ratio_p95']}"
            )
        rejected = fleet_cost.get("rejected", {})
        if rejected:
            lines.append(
                "  admission rejected: "
                + " ".join(f"{k}={v}" for k, v in sorted(rejected.items()))
            )
    slo = view.get("slo", {})
    lines.append("")
    lines.append("SLO (merged over live replicas; bands from "
                 "telemetry/catalog.py):")
    if not slo:
        lines.append("  (no phase observations yet)")
    for tenant in sorted(slo):
        for priority in sorted(slo[tenant]):
            lines.append(f"  {tenant}/{priority}:")
            for phase in ("queue_wait_s", "execution_s", "e2e_s"):
                cell = slo[tenant][priority].get(phase)
                if cell is None:
                    continue
                lines.append(f"    {phase:<13} {_fmt_cell(cell)}")
    read_slo = view.get("read_slo", {})
    if read_slo:
        lines.append("")
        lines.append("read SLO (artifact TTFB / full stream, per "
                     "tenant × size class):")
        for tenant in sorted(read_slo):
            for size_class in sorted(read_slo[tenant]):
                lines.append(f"  {tenant or '(any)'}/{size_class}:")
                for phase in ("read_ttfb_s", "read_s"):
                    cell = read_slo[tenant][size_class].get(phase)
                    if cell is None:
                        continue
                    lines.append(f"    {phase:<13} {_fmt_cell(cell)}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools fleet-top",
        description="merged terminal view of a chain-serve replica "
                    "fleet (docs/SERVE.md, docs/TELEMETRY.md)",
    )
    parser.add_argument(
        "source",
        help="serve root directory, or a replica URL (…/fleet appended)",
    )
    parser.add_argument("-i", "--interval", default=2.0, type=float,
                        help="refresh period in seconds")
    parser.add_argument("--once", action="store_true",
                        help="render one frame and exit (scripts/CI)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.once:
        print(render(fetch_fleet(args.source)), end="")
        return 0
    last_frame = None
    try:
        while True:
            note = ""
            try:
                frame = render(fetch_fleet(args.source))
                last_frame = frame
            except StatusSourceError as exc:
                if last_frame is None:
                    raise
                note = f"stale: {exc}"
                frame = last_frame.rstrip("\n") + f"\n[{note}]\n"
            sys.stdout.write("\033[2J\033[H" + frame)
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
