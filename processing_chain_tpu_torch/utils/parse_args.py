"""CLI flag surface — parity with reference lib/parse_args.py:25-137
(copy of processing_chain_tpu/utils/parse_args.py; the stages that parse
it are not ported yet, and the flags and their defaults stay the JAX
package's so that one command line drives either package).

All shared flags (-c -f -v -n -p -r --filter-src/hrc/pvs -sos -str
--skip-requirements --trace --telemetry) plus per-stage extras: -g/--set-gpu-loc on
p00/p01/p03/p04 (device index pinning the p03/p04 device work; accepted on
p01 for reference-CLI compatibility), p03 -s/--spinner-path
-z/--avpvs-src-fps -f60/--force-60-fps, p04 -e -a -ccrf.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

_DEFAULT_SPINNER = os.path.abspath(
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets",
        "spinner-128-white.png",
    )
)


def build_parser(name: str, script: Optional[int] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=name, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "-c", "--test-config", required=True,
        help="database YAML (lives at the top of the database folder; its "
        "folder layout is derived from this path)",
    )
    parser.add_argument(
        "-f", "--force", action="store_true",
        help="regenerate artifacts even when the output file already exists",
    )
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="log at DEBUG level"
    )
    parser.add_argument(
        "-n", "--dry-run", action="store_true",
        help="plan everything but execute nothing (prints each planned job)",
    )
    parser.add_argument(
        "--filter-src", help="restrict the run to these SRC ids; separate several with '|'"
    )
    parser.add_argument(
        "--filter-hrc", help="restrict the run to these HRC ids; separate several with '|'"
    )
    parser.add_argument(
        "--filter-pvs", help="restrict the run to these PVS ids; separate several with '|'"
    )
    parser.add_argument(
        "-p", "--parallelism", default=4, type=int,
        help="host-side worker count for the job pool",
    )
    parser.add_argument(
        "-r", "--remove-intermediate", action="store_true",
        help="delete intermediate artifacts once their consumers are written",
    )
    parser.add_argument(
        "-sos", "--skip-online-services", action="store_true",
        help="leave out segments whose coding runs on an online service",
    )
    parser.add_argument(
        "-str", "--scripts-to-run", default="1234",
        help='stage subset for the orchestrator: digits of the stages to run, '
        'in order ("34" = p03 then p04; "all" = everything)',
    )
    if script in (None, 1, 3, 4):
        # reference exposes -g on p01 (nvenc placement); here the device
        # work lives in p03/p04, so those and the p00 orchestrator
        # accept it too
        parser.add_argument(
            "-g", "--set-gpu-loc", default=-1, type=int,
            help="accelerator device index to pin device work to (-1 = auto)",
        )
    if script == 3:
        parser.add_argument(
            "-s", "--spinner-path", default=_DEFAULT_SPINNER,
            help="PNG composited (rotating) over stall frames",
        )
        parser.add_argument(
            "-z", "--avpvs-src-fps", action="store_true",
            help="render the AVPVS on the SRC frame-rate canvas instead of 60 fps",
        )
        parser.add_argument(
            "-f60", "--force-60-fps", action="store_true",
            help="pin the AVPVS frame rate at 60 fps regardless of the SRC",
        )
        parser.add_argument(
            "--ffv1-workers", default=None, type=int, metavar="N",
            help="frame-parallel FFV1 writeback contexts (0 = serial "
            "slice-threaded; default: PC_FFV1_WORKERS env, else one per "
            "spare core)",
        )
        parser.add_argument(
            "--avpvs-codec", default=None, choices=("ffv1", "rawvideo"),
            help="AVPVS intermediate codec (default: PC_AVPVS_CODEC env, "
            "else ffv1; rawvideo trades ~6x disk for near-memcpy "
            "writeback and is recorded in provenance)",
        )
    if script == 4:
        parser.add_argument(
            "-e", "--lightweight-preview", action="store_true",
            help="also write a small preview encode per CPVS",
        )
        parser.add_argument(
            "-a", "--rawvideo", action="store_true",
            help="PC context writes rawvideo in MKV instead of the default codec",
        )
        parser.add_argument(
            "-ccrf", "--nonraw-crf", default=17, type=int,
            help="quality (CRF) for the non-raw CPVS encodes",
        )
    parser.add_argument(
        "--skip-requirements", action="store_true",
        help="do not abort when the requirements/version check fails",
    )
    parser.add_argument(
        "--trace", nargs="?", const="", default=None, metavar="DIR",
        help="record per-op timing spans to the database logs/ folder; "
        "with DIR, also capture a torch.profiler device trace there",
    )
    parser.add_argument(
        "--telemetry", default=None, metavar="DIR",
        help="enable the metrics registry + structured event log and "
        "write metrics_<ts>.json, metrics_<ts>.prom, events_<ts>.jsonl "
        "and trace_<ts>.json into DIR (render with tools/run_report.py)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="performance-attribution capture (docs/TELEMETRY.md "
        "'Profiling & attribution'): sample RSS/CPU/pool/queue/device-"
        "memory resources and write a merged host+device Chrome trace "
        "(profile_<ts>.trace.json, view in chrome://tracing or Perfetto) "
        "plus resources_<ts>.json into DIR. Implies telemetry collection; "
        "pair with --telemetry DIR for bottleneck verdicts in run-report",
    )
    parser.add_argument(
        "--live-port", default=None, type=int, metavar="PORT",
        help="serve live observability on PORT while the run is in "
        "flight: /healthz, /metrics (Prometheus, live), /status (JSON "
        "progress/ETA/in-flight tasks; render with tools chain-top). "
        "0 binds an ephemeral port (logged). Implies telemetry "
        "collection (persisted only with --telemetry DIR)",
    )
    parser.add_argument(
        "--status-file", default=None, metavar="PATH",
        help="atomically rewrite PATH with the /status JSON every ~2s "
        "(headless twin of --live-port; render with tools chain-top)",
    )
    parser.add_argument(
        "--watchdog-soft", default=None, type=float, metavar="SECONDS",
        help="flag any in-flight task without progress for SECONDS: "
        "task_stalled event + all-thread stack dump in the event log "
        "(default 300 when live observability is on)",
    )
    parser.add_argument(
        "--watchdog-hard", default=None, type=float, metavar="SECONDS",
        help="opt-in hard limit: a task without progress for SECONDS is "
        "marked failed with forensics (task_hard_timeout event + stack "
        "dump) and cancelled instead of hanging forever (default: off)",
    )
    parser.add_argument(
        "--store", default=None, metavar="DIR",
        help="content-addressed artifact store root (docs/STORE.md): "
        "stale-vs-fresh becomes plan-hash equality, cached artifacts are "
        "integrity-verified and materialized instead of rebuilt "
        "(default: PC_STORE_DIR env, else no store)",
    )
    parser.add_argument(
        "--no-store", action="store_true",
        help="ignore --store and PC_STORE_DIR: plain skip-existing "
        "semantics for this run",
    )
    parser.add_argument(
        "--store-tiers", default=None, metavar="SPEC",
        help="hot/warm/cold placement for the artifact store "
        "(docs/STORE.md \"Tier hierarchy\"): e.g. "
        "'hot@64M,shared=/mnt/warm@2G,object=/mnt/cold' "
        "(default: PC_STORE_TIERS env, else a single-tier store)",
    )
    return parser


def parse_args(name: str, script: Optional[int] = None,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser(name, script).parse_args(argv)
