"""mesh-top: a refreshing terminal view of device-mesh wave occupancy
(copy of processing_chain_tpu/tools/mesh_top.py).

The operator face of the device-plane flight recorder
(parallel/meshobs.py): per geometry bucket, how many wave-steps have
dispatched, how their frame-slots split into valid work vs the three
padding kinds (tail repeat, exhausted lanes riding the wave, batch-axis
mesh padding), the running waste fraction, and the compile ledger
(first dispatches of each geometry's step + their seconds).

    python -m processing_chain_tpu_torch tools mesh-top http://host:8790
    python -m processing_chain_tpu_torch tools mesh-top RUN_DIR/meshobs_<stamp>
    python -m processing_chain_tpu_torch tools mesh-top SERVE_ROOT --once

A URL reads a live process's /status "mesh" section (in-memory
aggregates since process start); a directory reads the wave journal on
disk — works against a dead or remote-copied run, and additionally
shows the lane→wave schedule the journal preserves. A serve root is
accepted directly (its `meshobs/` journal dir is used). `--once`
renders one frame for scripts/CI.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

from .chain_top import StatusSourceError, fetch_status


def load_mesh(source: str) -> dict:
    """The per-bucket aggregate from a /status URL or a journal dir.
    Returns {"buckets": {...}, "totals"?, "schedule"?, "source": ...};
    raises StatusSourceError when the source has no mesh data."""
    if source.startswith(("http://", "https://")):
        status = fetch_status(source)
        mesh = status.get("mesh")
        if not mesh:
            raise StatusSourceError(
                f"{source}: no mesh section (no wave has dispatched in "
                "that process yet)"
            )
        return {"buckets": mesh.get("buckets", {}), "source": source,
                "journal": mesh.get("journal")}
    from ..parallel import meshobs

    root = source
    # a serve root is accepted directly: its meshobs/ dir is the journal
    if os.path.isdir(meshobs.mesh_dir(root)):
        root = meshobs.mesh_dir(root)
    agg = meshobs.aggregate(root)
    if not agg["buckets"]:
        raise StatusSourceError(f"no wave journal records under {root}")
    return {"buckets": agg["buckets"], "totals": agg["totals"],
            "schedule": agg["schedule"],
            "invariant_violations": agg["invariant_violations"],
            "source": root}


def _occupancy_bar(agg: dict, width: int = 24) -> str:
    """valid/pad split as a bar: '#' valid, 't' tail, 'x' exhausted,
    '.' mesh padding."""
    dispatched = agg.get("dispatched", 0)
    if not dispatched:
        return "[" + "?" * width + "]"
    cells = []
    for kind, mark in (("valid", "#"), ("pad_tail", "t"),
                       ("pad_exhausted", "x"), ("pad_mesh", ".")):
        cells.append([mark, agg.get(kind, 0) * width / dispatched])
    # largest-remainder rounding so the bar is always exactly `width`
    floors = [int(c[1]) for c in cells]
    rem = width - sum(floors)
    order = sorted(range(4), key=lambda i: -(cells[i][1] - floors[i]))
    for i in order[:rem]:
        floors[i] += 1
    return "[" + "".join(m * n for (m, _), n in zip(cells, floors)) + "]"


def render(view: dict, note: str = "") -> str:
    """One full frame (plain text; the loop clears the screen)."""
    lines: list[str] = []
    head = f"mesh-top — {view.get('source', '?')}"
    if note:
        head += f"  [{note}]"
    lines.append(head)
    violations = view.get("invariant_violations")
    if violations:
        lines.append(f"  !! {violations} wave record(s) broke "
                     "valid+pad==dispatched (wave-loop accounting bug)")
    lines.append("")
    lines.append("buckets (# valid, t tail-pad, x exhausted-lane, "
                 ". mesh-pad):")
    buckets = view.get("buckets", {})
    if not buckets:
        lines.append("  (no waves dispatched)")
    for name in sorted(buckets):
        agg = buckets[name]
        waste = agg.get("waste_fraction", 0.0)
        lines.append(
            f"  {name:<28} {_occupancy_bar(agg)} "
            f"waste {waste * 100:5.1f}%  waves {agg.get('waves', 0):>5}  "
            f"slots {agg.get('valid', 0)}+{agg.get('pad_tail', 0)}t"
            f"+{agg.get('pad_exhausted', 0)}x+{agg.get('pad_mesh', 0)}. "
            f" step {agg.get('step_s', 0.0):.2f}s"
        )
        if agg.get("recompiles"):
            lines.append(
                f"  {'':<28} compiles {agg['recompiles']} "
                f"({agg.get('compile_s', 0.0):.2f}s compile-inclusive)"
            )
    totals = view.get("totals")
    if totals and len(buckets) > 1:
        lines.append(
            f"  {'TOTAL':<28} {_occupancy_bar(totals)} "
            f"waste {totals.get('waste_fraction', 0.0) * 100:5.1f}%  "
            f"waves {totals.get('waves', 0):>5}  "
            f"compiles {totals.get('recompiles', 0)}"
        )
    schedule = view.get("schedule")
    if schedule:
        lines.append("")
        lines.append("lane→wave schedule (journal, block-0 records):")
        for name in sorted(schedule):
            for entry in schedule[name]:
                lanes = entry.get("lanes", [])
                shown = ", ".join(str(ln) for ln in lanes[:6])
                if len(lanes) > 6:
                    shown += f", … +{len(lanes) - 6}"
                lines.append(
                    f"  {name} wave {entry.get('wave', '?')}: {shown}")
    if view.get("journal"):
        lines.append("")
        lines.append(f"journal: {view['journal']}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools mesh-top",
        description="device-mesh wave occupancy / waste / compile-ledger "
                    "view (parallel/meshobs.py)",
    )
    parser.add_argument(
        "source",
        help="live /status URL, a meshobs journal directory, or a serve "
             "root containing one",
    )
    parser.add_argument("-i", "--interval", default=2.0, type=float,
                        help="refresh period in seconds")
    parser.add_argument("--once", action="store_true",
                        help="render one frame and exit (scripts/CI)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.once:
        print(render(load_mesh(args.source)), end="")
        return 0
    last_frame = None
    try:
        while True:
            note = ""
            try:
                frame = render(load_mesh(args.source))
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
