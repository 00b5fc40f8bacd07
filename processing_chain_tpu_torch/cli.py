"""The stage command line of the port (counterpart of
processing_chain_tpu/cli.py:27-260 and `main` :393):

    python -m processing_chain_tpu_torch p00 -c DB/DB.yaml [-str 1234] …
    python -m processing_chain_tpu_torch p01 -c DB/DB.yaml [-sos] [-p N] …
    python -m processing_chain_tpu_torch p02 -c DB/DB.yaml …
    python -m processing_chain_tpu_torch p03 -c DB/DB.yaml [-f60] [-z] …
    python -m processing_chain_tpu_torch p04 -c DB/DB.yaml [-e] [-a] [-ccrf N] …

`p00` runs p01 → p02 → p03 → p04 (or the `-str` subset) in one process.
The flags are the JAX package's (utils/parse_args), so one command line
drives either package. A stage with device work (every one but p02, which
reads bitstreams on the host) runs on `cuda:0`, or on the card `-g N`
names; the CPU only when a caller of `main` passes `device="cpu"` (the
tests do). The observability flags behave as the reference's:
`--telemetry DIR` streams the events to `events_<stamp>.jsonl` as they
happen and writes `metrics_<stamp>.{json,prom}` and `trace_<stamp>.json`
at the end, `--profile DIR` the resources and the merged trace (plus the
torch.profiler device trace on the card), `--trace [DIR]` the timing
report into the database's `logs/` (and with DIR its own device trace,
which then owns the capture), `--live-port`/`--status-file`/
`--watchdog-*` the live status and the stall watchdog. ConfigError,
ChainError, MediaError, a missing device, an unbindable port and an
unwritable status path exit 1 with their message, as the reference's
sys.exit(1) sites do; a failure to persist what was observed never
replaces the run's own exit code.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence

from . import telemetry
from .config.errors import ConfigError
from .io.medialib import MediaError
from .utils import log as log_mod
from .utils import parse_args as pa
from .utils import tracing
from .utils.device import DeviceError, resolve_device, select_device
from .utils.runner import ChainError
from .utils.version import check_requirements


def setup_logger(verbose: bool = False):
    """The chain-wide "main" logger on stderr (reference utils/log.py)."""
    import logging

    logger = log_mod.get_logger()
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                                               "%H:%M:%S"))
        logger.addHandler(handler)
    logger.propagate = False
    return logger


#: the stages the port runs, by name: (script number, module name); p00's
#: number is None, the orchestrator's flag set
STAGES = {
    "p00": (None, "p00_process_all"),
    "p01": (1, "p01_generate_segments"),
    "p02": (2, "p02_generate_metadata"),
    "p03": (3, "p03_generate_avpvs"),
    "p04": (4, "p04_generate_cpvs"),
}


def _process_seconds() -> Optional[float]:
    """Seconds since this process started (/proc/self/stat's start time
    against /proc/uptime), or None where /proc does not tell."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return round(uptime - start / os.sysconf("SC_CLK_TCK"), 3)
    except (OSError, ValueError, IndexError):
        return None


def _write_telemetry(out_dir: str, status: str, wall_s: float,
                     stamp: Optional[str] = None) -> None:
    """Persist the run's metrics/events/trace under one stamp into
    `out_dir`. Best-effort: a persistence failure must never replace the
    run's own outcome."""
    telemetry.emit("run_end", status=status, duration_s=round(wall_s, 4))
    try:
        paths = telemetry.write_outputs(out_dir, stamp=stamp)
        tracing.get_tracer().write_report(out_dir, name=paths["stamp"])
        log_mod.get_logger().info(
            "telemetry: %s metrics_%s.{json,prom} + events + trace", out_dir, paths["stamp"])
    except Exception as exc:  # noqa: BLE001 - runs in _dispatch_stage's finally:
        # anything narrower would let a persistence error (unwritable dir,
        # a non-serializable emit() field) replace the propagating stage
        # exception
        log_mod.get_logger().warning("could not write telemetry to %s: %s", out_dir, exc)


def _start_observability(stage: str, args, argv: Sequence[str]):
    """The live surface the flags ask for: (run stamp, live server,
    status writer, watchdog), or None when a port or a status path
    cannot be opened (exit 1)."""
    log = log_mod.get_logger()
    telemetry_dir = args.telemetry
    live_port, status_file = args.live_port, args.status_file
    wd_soft, wd_hard = args.watchdog_soft, args.watchdog_hard
    run_stamp = None
    if (telemetry_dir is not None or live_port is not None or status_file is not None
            or wd_soft is not None or wd_hard is not None or args.profile is not None):
        # live observability IS telemetry, served instead of (or as well
        # as) persisted: /metrics renders the same registry, the
        # watchdog's forensics land in the same event log
        telemetry.enable()
        telemetry.attach_log_handler(log)
        if telemetry_dir:
            # stream events to disk as they happen under a stamp fixed
            # now: a run that crashes or is killed leaves its event
            # history for a partial run-report
            run_stamp = telemetry.unique_stamp()
            try:
                telemetry.EVENTS.open_stream(
                    os.path.join(telemetry_dir, f"events_{run_stamp}.jsonl"))
            except OSError as exc:
                log.warning("cannot stream events to %s: %s", telemetry_dir, exc)
            # the wave journal rides the same stamp so run-report can
            # join it (parallel/meshobs)
            from .parallel import meshobs

            meshobs.attach_journal(os.path.join(telemetry_dir, f"meshobs_{run_stamp}"))
        telemetry.emit("run_start", name=stage, argv=list(argv))
    live_server = status_writer = watchdog = None
    # the watchdog rides the live surface or its own flags, never bare
    # --telemetry: a long encode job beats only on completion, so a
    # default-on watchdog would flag healthy jobs on every routine run
    if live_port is not None or status_file is not None or wd_soft is not None \
            or wd_hard is not None:
        from .telemetry import live as live_mod
        from .telemetry import watchdog as watchdog_mod

        live_mod.set_run_meta(name=stage, argv=list(argv))
        try:
            if live_port is not None:
                live_server = live_mod.LiveServer(live_port).start()
                log.info("live status: %s/{healthz,metrics,status}", live_server.url)
            if status_file:
                status_writer = live_mod.StatusFileWriter(status_file).start()
        except OSError as exc:
            # an operator's mistake, not a stage failure: exit 1
            log.error("cannot start live observability: %s", exc)
            if live_server is not None:
                live_server.stop()
            return None
        watchdog = watchdog_mod.start_watchdog(
            soft_s=wd_soft if wd_soft is not None else watchdog_mod.DEFAULT_SOFT_S,
            hard_s=wd_hard)
    return run_stamp, live_server, status_writer, watchdog


def _dispatch_stage(stage: str, argv: Sequence[str], device=None) -> int:
    import importlib

    startup = {"to_main_s": _process_seconds()}
    t0 = time.perf_counter()
    args = pa.parse_args(stage, STAGES[stage][0], argv)
    log = setup_logger(args.verbose)
    host_only = STAGES[stage][0] == 2
    try:
        if host_only:
            dev = None
        elif device is not None:
            dev = resolve_device(device)
        else:
            dev = select_device(args.set_gpu_loc)
    except DeviceError as exc:
        log.error("%s: %s", stage, exc)
        return 1
    startup["device_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    if not args.skip_requirements and not check_requirements(
            need_device=dev is not None and dev.type == "cuda"):
        return 1
    startup["requirements_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    from .store import runtime as store_runtime

    module = importlib.import_module(f".stages.{STAGES[stage][1]}", __package__)
    store = store_runtime.configure_from_args(args)
    if store is not None:
        log.info("artifact store: %s", store.root)
    startup["stage_import_s"] = round(time.perf_counter() - t0, 3)
    # where a process's seconds go before the stage starts: the
    # interpreter and imports, the device pick, the requirements check
    # (libav located, bound and its layout round trips), the stage's
    # modules
    log.info("%s start-up: %s", stage, json.dumps(startup))
    log.info("%s on %s", stage, dev if dev is not None else "the host")
    live = _start_observability(stage, args, argv)
    if live is None:
        return 1
    run_stamp, live_server, status_writer, watchdog = live
    tracing_on = args.trace is not None
    profiler = tracing.DeviceProfiler(args.trace) if args.trace else None
    chain_profiler = None
    if args.profile is not None:
        # resource monitor + merged host/device timeline under the run
        # stamp, so run-report and `tools chain-profile` join them
        from .telemetry import profiling as profiling_mod

        if dev is not None and dev.type == "cuda":
            # the capture's "auto" reads an initialised CUDA: initialise
            # it on the stage's card before the capture starts
            import torch

            torch.cuda.init()
        if run_stamp is None:
            run_stamp = telemetry.unique_stamp()
        # torch.profiler is one session a process: `--trace DIR` owns the
        # device capture when it asks for one
        chain_profiler = profiling_mod.Profiler(
            args.profile, device_trace=False if args.trace else None).start(run_stamp)
        log.info("profiling to %s (stamp %s)", args.profile, run_stamp)
    test_config = None
    status = "ok"
    t0 = time.perf_counter()
    try:
        if profiler is not None:
            profiler.start()
        test_config = module.run(args, device=dev)
    except (ConfigError, ChainError, MediaError) as exc:
        status = "fail"
        log.error("%s", exc)
        return 1
    except BaseException:
        status = "fail"
        raise
    finally:
        if watchdog is not None:
            from .telemetry import watchdog as watchdog_mod

            watchdog_mod.stop_watchdog()
        if status_writer is not None:
            # one final snapshot records how the run ended
            status_writer.stop()
        if live_server is not None:
            live_server.stop()
        if profiler is not None:
            profiler.stop()
        if chain_profiler is not None:
            paths = chain_profiler.stop(run_stamp)
            if paths.get("trace"):
                log.info("profile: %s (+ %s)%s; `tools chain-profile %s` for the summary",
                         paths["trace"], paths.get("resources", ""),
                         f" + device trace {paths['device_trace_dir']}"
                         if paths.get("device_trace_dir") else "", args.profile)
        if store is not None:
            # persist the stat-keyed input digest cache (best-effort)
            store.digests.save()
        if args.telemetry:
            from .parallel import meshobs

            meshobs.detach_journal()
            _write_telemetry(args.telemetry, status, time.perf_counter() - t0, stamp=run_stamp)
        if tracing_on:
            tracer = tracing.get_tracer()
            tracer.log_summary()
            # a stage that failed before returning its config persists
            # next to the database anyway (the default logs/ layout)
            logs_dir = (test_config.get_logs_path() if test_config is not None else
                        os.path.join(os.path.dirname(os.path.abspath(args.test_config)), "logs"))
            try:
                log.info("timing report: %s", tracer.write_report(logs_dir))
            except OSError as exc:
                # never let report persistence replace the run's outcome
                log.warning("could not write timing report to %s: %s", logs_dir, exc)
    return 0


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """`p00 …` through `p04 …` runs the stage; `device` (a torch device or
    its name) overrides the card the flags select."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in STAGES:
        sys.stderr.write(f"usage: python -m processing_chain_tpu_torch {'|'.join(STAGES)} "
                         "-c DB.yaml …\n")
        return 2
    return _dispatch_stage(argv[0], argv[1:], device)


if __name__ == "__main__":
    sys.exit(main())
