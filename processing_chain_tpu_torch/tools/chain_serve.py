"""`tools chain-serve` — run the always-on processing daemon (port of
processing_chain_tpu/tools/chain_serve.py).

    python -m processing_chain_tpu_torch tools chain-serve --root DIR
        [--port 8790] [--host 127.0.0.1]
        [--executor synthetic|wave] [--workers N] [--wave-width N]
        [--store DIR] [--max-attempts N] [--tenant-weight NAME=W ...]
        [--device cuda:0]

The daemon binds ONE HTTP server (observability + /v1 API), recovers
its durable queue from --root, and runs until SIGTERM/SIGINT.
`--root/serve-info.json` records {pid, port, url} the moment the server
is up: scripts that started the daemon with `--port 0` read the bound
port from there. The `wave` executor runs on `--device` (default
`cuda:0`) and refuses to start where CUDA is absent; `--device cpu` runs
its plain CPU route.
"""

from __future__ import annotations

import argparse
import signal
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
    parser.add_argument("--max-attempts", type=int, default=2,
                        help="execution attempts per job before it fails")
    parser.add_argument("--tenant-weight", action="append", default=[],
                        metavar="NAME=W",
                        help="fair-share weight for a tenant (default 1)")
    parser.add_argument("--device", default="cuda:0",
                        help="device of the wave executor (default cuda:0; "
                             "'cpu' runs its plain CPU route)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    from ..serve.service import ChainServeService

    service = ChainServeService(
        root=args.root,
        port=args.port,
        host=args.host,
        executor=args.executor,
        workers=args.workers,
        wave_width=args.wave_width,
        store_root=args.store,
        tenant_weights=_parse_tenant_weights(args.tenant_weight),
        max_attempts=args.max_attempts,
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
    try:
        while not stop.wait(0.5):
            pass
    finally:
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
