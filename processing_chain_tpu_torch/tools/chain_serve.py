"""`tools chain-serve` — run the always-on processing daemon (port of
processing_chain_tpu/tools/chain_serve.py).

    python -m processing_chain_tpu_torch tools chain-serve --root DIR
        [--port 8790] [--host 127.0.0.1]
        [--executor synthetic|wave] [--workers N] [--wave-width N]
        [--store DIR] [--store-budget BYTES] [--store-tiers SPEC]
        [--max-attempts N] [--tenant-weight NAME=W ...]
        [--replica-id NAME] [--lease-s S] [--poll-s S] [--info-file FILE]
        [--wave-budget-s S] [--admission-budget-s S] [--tenant-budget-s S]
        [--cost-calibrate] [--control-interval-s S]
        [--alert-window-scale F] [--device cuda:0] [--status-file FILE]

The daemon binds ONE HTTP server (observability + /v1 API), recovers
its durable queue from --root, and runs until SIGTERM/SIGINT.
`--root/serve-info.json` records {pid, port, url} the moment the server
is up: scripts that started the daemon with `--port 0` read the bound
port from there. `--status-file FILE` also rewrites the /status JSON to
FILE every 2 s (atomically) and once more at shutdown. The `wave`
executor runs on `--device` (default `cuda:0`) and refuses to start
where CUDA is absent; `--device cpu` runs its plain CPU route. The
control-plane flags are the reference's, each a no-op at its default.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional, Sequence

from ..utils.log import get_logger


def _parse_tenant_weights(pairs: list) -> dict:
    weights = {}
    for pair in pairs or ():
        name, _, value = pair.partition("=")
        if not name or not value:
            raise ValueError(
                f"--tenant-weight wants NAME=WEIGHT, got {pair!r}"
            )
        weights[name] = float(value)
    return weights


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools chain-serve",
        description="always-on processing service",
    )
    parser.add_argument("--root", required=True,
                        help="serve state root (queue/requests/artifacts/store)")
    parser.add_argument("--port", type=int, default=8790,
                        help="HTTP port; 0 binds an ephemeral one "
                             "(read it from serve-info.json)")
    parser.add_argument("--host", default=None,
                        help="bind host (default 127.0.0.1 / PC_LIVE_HOST)")
    parser.add_argument("--executor", default="synthetic",
                        choices=("synthetic", "wave"),
                        help="unit executor: synthetic | wave")
    parser.add_argument("--workers", type=int, default=2,
                        help="scheduler worker threads")
    parser.add_argument("--wave-width", type=int, default=4,
                        help="max units packed into one device wave")
    parser.add_argument("--store", default=None,
                        help="artifact store root (default ROOT/store)")
    parser.add_argument("--store-budget", default=None,
                        help="store size budget, bytes (suffixes K/M/G ok); "
                             "GC pressure evicts LRU past it")
    parser.add_argument("--store-tiers", default=None, metavar="SPEC",
                        help="tiered store placement, e.g. "
                             "'hot@64M,shared=/mnt/warm@2G,object=/mnt/cold'"
                             " (default PC_STORE_TIERS, else single-tier)")
    parser.add_argument("--max-attempts", type=int, default=2,
                        help="execution attempts per job before it fails")
    parser.add_argument("--tenant-weight", action="append", default=[],
                        metavar="NAME=W",
                        help="fair-share weight for a tenant (default 1)")
    parser.add_argument("--device", default="cuda:0",
                        help="device of the wave executor (default cuda:0; "
                             "'cpu' runs its plain CPU route)")
    parser.add_argument("--status-file", default=None,
                        help="also rewrite the /status JSON to this file")
    parser.add_argument("--replica-id", default=None,
                        help="stable name for this replica in a fleet "
                             "(default: host-pid-random)")
    parser.add_argument("--lease-s", type=float, default=15.0,
                        help="execution-lease duration; a replica that "
                             "stops renewing for this long loses its "
                             "claims to peers")
    parser.add_argument("--poll-s", type=float, default=1.0,
                        help="fleet maintenance tick: peer-record merge, "
                             "dead-lease stealing, remote completions")
    parser.add_argument("--info-file", default=None,
                        help="where to write {pid, port, url, replica} "
                             "(default ROOT/serve-info.json; give each "
                             "replica of a fleet its own)")
    parser.add_argument("--wave-budget-s", type=float, default=None,
                        help="cost-aware wave packing: fill waves to "
                             "this many PREDICTED seconds (serve/cost.py)"
                             " instead of stopping at --wave-width")
    parser.add_argument("--admission-budget-s", type=float, default=None,
                        help="refuse (429) any request whose cold units "
                             "predict more than this many seconds")
    parser.add_argument("--tenant-budget-s", type=float, default=None,
                        help="refuse (429, retryable) work that would "
                             "push a tenant's outstanding predicted "
                             "seconds past this budget")
    parser.add_argument("--cost-calibrate", action="store_true",
                        help="periodically refit the per-host cost-"
                             "prediction scale from the observed/"
                             "predicted ratio ring (serve/cost.py; "
                             "reported in /status and /fleet)")
    parser.add_argument("--control-interval-s", type=float, default=10.0,
                        help="SLO control loop cadence: alert-rule "
                             "grading + scale-signal re-grade on the "
                             "maintenance tick")
    parser.add_argument("--alert-window-scale", type=float, default=1.0,
                        help="uniformly compress every burn-rate window "
                             "and alert hold by this factor (soak "
                             "harnesses squeeze hours into seconds; "
                             "production leaves it at 1.0)")
    argv = list(argv) if argv is not None else sys.argv[1:]
    args = parser.parse_args(argv)

    from ..serve.service import ChainServeService
    from ..telemetry.live import StatusFileWriter, set_run_meta
    from .store_admin import _parse_bytes

    # /status's `run` section: which daemon this is and how it was started
    set_run_meta(name="chain-serve", argv=argv)

    budget = _parse_bytes(args.store_budget) if args.store_budget else None
    # plan-exempt: (names WHERE artifact bytes are placed, never what they contain)
    tiers = args.store_tiers or os.environ.get("PC_STORE_TIERS")

    service = ChainServeService(
        root=args.root,
        port=args.port,
        host=args.host,
        executor=args.executor,
        workers=args.workers,
        wave_width=args.wave_width,
        store_root=args.store,
        store_budget_bytes=budget,
        store_tiers=tiers,
        tenant_weights=_parse_tenant_weights(args.tenant_weight),
        max_attempts=args.max_attempts,
        replica=args.replica_id,
        lease_s=args.lease_s,
        poll_s=args.poll_s,
        info_path=args.info_file,
        wave_budget_s=args.wave_budget_s,
        admission_budget_s=args.admission_budget_s,
        tenant_budget_s=args.tenant_budget_s,
        cost_calibrate=args.cost_calibrate,
        control_interval_s=args.control_interval_s,
        alert_window_scale=args.alert_window_scale,
        device=args.device,
    )
    stop = threading.Event()

    def _on_signal(signum, frame) -> None:
        get_logger().info("chain-serve: signal %d — draining and stopping",
                          signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    def _on_drain_signal(signum, frame) -> None:
        # SIGUSR1 toggles drain: the operator's no-HTTP path to the
        # same state flip POST /v1/drain performs. A second SIGUSR1
        # resumes.
        if service.scheduler.draining:
            get_logger().info("chain-serve: SIGUSR1 — resuming")
            service.resume()
        else:
            get_logger().info("chain-serve: SIGUSR1 — draining "
                              "(again to resume)")
            service.drain()

    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _on_drain_signal)
    service.start()
    status_writer = None
    if args.status_file:
        status_writer = StatusFileWriter(args.status_file).start()
    try:
        while not stop.wait(0.5):
            pass
    finally:
        if status_writer is not None:
            status_writer.stop()
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
