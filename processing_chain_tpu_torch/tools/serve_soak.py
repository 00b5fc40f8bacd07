"""`tools serve-soak` — the dedup/fairness/latency proof harness.

Runs an in-process chain-serve service, fires N concurrent synthetic
clients whose SRC×HRC grids deliberately OVERLAP, waits for every
request to finish, then asserts the serving economics the design
promises (ROADMAP open item #2, docs/SERVE.md):

  * zero duplicate executions — `chain_jobs_planned_total{runner=serve}`
    must equal the number of UNIQUE plan hashes across all requests;
  * every request completes;
  * a warm re-run of the same grids answers in milliseconds
    (measured, reported, and gated against --warm-budget-ms).

`--executor wave` drives the device wave executor on `--device`
(default `cuda:0`: without CUDA the soak refuses to start; `--device
cpu` runs its plain CPU route). `--executor chain` (the reference's
full p01–p04 run over a rendered corpus) exits nonzero with the
executor's own message until the port's media layer lands.

`--pack-bench` instead benches the scheduler's packing POLICY:
cost-aware wave packing (balance predicted seconds, serve/cost.py) vs
count-based packing on an adversarially-ordered mixed-complexity queue,
reporting per-wave predicted-seconds spread and per-unit e2e tail for
both (the committed `COST_PACK_*.json` band).

The report also breaks the cold pass's latency into the SLO phases
the fleet layer grades (docs/TELEMETRY.md "Fleet observability"):
p50/p95/p99 of queue-wait (enqueue→claim) and execution (claim→settle)
from the span journal's exact timestamps, plus request end-to-end —
so a soak regression says WHICH phase moved, not just that warm p50
did.

Prints one JSON report line (the `SERVE_SOAK_*.json` artifact committed
with the PR) and exits nonzero on any violated invariant.

    python -m processing_chain_tpu_torch tools serve-soak
        [--clients 8] [--srcs 6] [--hrcs 4] [--overlap 0.5]
        [--executor synthetic|wave] [--device cuda:0] [--workers 4]
        [--wave-width 4] [--warm-budget-ms 1000] [--out FILE]
        [--root DIR] [--pack-bench] [--wave-budget-s S]

The port's copy of processing_chain_tpu/tools/serve_soak.py.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Optional, Sequence

from .. import telemetry as tm
from ..utils.fsio import atomic_write_text
from ..utils.log import get_logger


def _grid(client: int, n_srcs: int, n_hrcs: int, overlap: float) -> dict:
    """Client grids share a common core (the overlap fraction) and add a
    per-client disjoint tail — the 'million users requesting overlapping
    SRC×HRC grids' shape, miniaturized."""
    shared = max(1, int(n_srcs * overlap))
    srcs = [f"SRC{100 + i:03d}" for i in range(shared)]
    srcs += [f"SRC{500 + client * 16 + i:03d}"
             for i in range(n_srcs - shared)]
    hrcs = [f"HRC{100 + i:03d}" for i in range(n_hrcs)]
    return {"srcs": srcs, "hrcs": hrcs}


def _percentiles_ms(values: list) -> Optional[dict]:
    """{p50, p95, p99} in milliseconds (exact order statistics — the
    soak has every observation, no bucket estimate needed)."""
    from ..telemetry.fleet import percentile_exact

    if not values:
        return None
    return {"p50": round(percentile_exact(values, 0.50) * 1e3, 3),
            "p95": round(percentile_exact(values, 0.95) * 1e3, 3),
            "p99": round(percentile_exact(values, 0.99) * 1e3, 3),
            "n": len(values)}


def phase_latencies(root: str, e2e_s: list) -> dict:
    """Per-phase latency percentiles from the span journal (queue-wait
    and execution ride the claim/settle spans) + the caller's request
    end-to-end samples."""
    from ..serve import spans as serve_spans

    journal = serve_spans.read_journals(
        os.path.join(root, "queue", "spans"))
    queue_wait = [s["queue_wait_s"] for s in journal
                  if s.get("phase") == "claim"
                  and s.get("queue_wait_s") is not None]
    execution = [s["exec_s"] for s in journal
                 if s.get("phase") == "complete"
                 and s.get("exec_s") is not None and not s.get("warm")]
    return {
        "queue_wait_ms": _percentiles_ms(queue_wait),
        "execution_ms": _percentiles_ms(execution),
        "e2e_ms": _percentiles_ms(e2e_s),
    }


def _planned_serve_jobs() -> int:
    metric = tm.REGISTRY.snapshot().get("chain_jobs_planned_total")
    if not metric:
        return 0
    return int(sum(
        s.get("value", 0) for s in metric["series"]
        if s.get("labels", {}).get("runner") == "serve"
    ))


# ------------------------------------------------------- pack bench


def pack_bench(args) -> int:
    """Cost-aware vs count-based wave packing on an adversarially
    ordered mixed-complexity queue: a burst of light units followed by
    a burst of heavy ones (the order a bursty tenant actually
    produces). Count-based packing groups the heavies into a few
    monolithic all-heavy waves whose coarse granularity straggles the
    end of the drain; cost-aware packing splits them into ~budget-sized
    waves that spread across workers. Reports, per policy: per-wave
    predicted-seconds spread (CV + max) and per-unit e2e latency
    percentiles. Exit 1 unless cost-aware improves BOTH — the committed
    `COST_PACK_*.json` band."""
    from ..serve import cost as serve_cost
    from ..serve.api import Unit
    from ..serve.executors import SyntheticExecutor
    from ..serve.queue import DurableQueue
    from ..serve.scheduler import Scheduler
    from ..store import keys

    log = get_logger()
    tm.enable()
    root = args.root or tempfile.mkdtemp(prefix="chain-pack-bench-")
    heavy_ms, light_ms = 200, 10
    n_heavy, n_light = 12, 36
    executor = SyntheticExecutor()

    def predict(work_ms: int) -> float:
        return serve_cost.predict_unit_cost(executor, {
            "params": {"work_ms": work_ms, "size_bytes": 1024},
        })

    budget = args.wave_budget_s or (
        predict(heavy_ms) + 3 * predict(light_ms) + 0.005
    )
    report: dict = {
        "bench": "pack",
        "heavy_ms": heavy_ms, "light_ms": light_ms,
        "n_heavy": n_heavy, "n_light": n_light,
        "workers": args.workers, "wave_width": args.wave_width,
        "wave_budget_s": round(budget, 4),
        "modes": {},
    }
    failures: list[str] = []
    work = [light_ms] * n_light + [heavy_ms] * n_heavy
    for mode in ("count", "cost"):
        mroot = os.path.join(root, mode)
        queue = DurableQueue(os.path.join(mroot, "queue"))
        try:
            for i, work_ms in enumerate(work):
                unit = Unit(database="P2STR01", src=f"SRC{100 + i:03d}",
                            hrc="HRC100",
                            params={"geometry": [64, 36],
                                    "work_ms": work_ms,
                                    "size_bytes": 1024})
                plan = executor.plan(unit)
                record_unit = {
                    "database": unit.database, "src": unit.src,
                    "hrc": unit.hrc, "params": unit.params,
                    "pvs_id": unit.pvs_id,
                }
                queue.enqueue(
                    keys.plan_hash(plan), plan, record_unit, "acme",
                    "normal", f"req-{i}", f"u{i}.bin",
                    cost_s=serve_cost.predict_unit_cost(
                        executor, record_unit),
                )
            events_before = len(tm.EVENTS.records())
            sched = Scheduler(
                queue, executor, os.path.join(mroot, "artifacts"),
                workers=args.workers, wave_width=args.wave_width,
                wave_budget_s=budget if mode == "cost" else None,
            )
            t0 = time.perf_counter()
            sched.start()
            drained = sched.wait_idle(timeout=180.0)
            wall_s = time.perf_counter() - t0
            sched.stop()
            if not drained:
                failures.append(f"{mode}: queue never drained")
                continue
            wave_pred = [
                e.get("predicted_s", 0.0)
                for e in tm.EVENTS.records()[events_before:]
                if e.get("event") == "serve_wave"
            ]
            records = [queue.record(j) for j in _record_ids(queue)]
            e2e = [
                max(0.0, r.done_at - r.enqueued_at)
                for r in records
                if r is not None and r.state == "done" and r.done_at
            ]
            mean = sum(wave_pred) / max(1, len(wave_pred))
            var = sum((x - mean) ** 2 for x in wave_pred) \
                / max(1, len(wave_pred))
            from ..telemetry.fleet import percentile_exact

            results = {
                "waves": len(wave_pred),
                "wave_pred_mean_s": round(mean, 4),
                "wave_pred_max_s": round(max(wave_pred), 4)
                if wave_pred else None,
                "wave_pred_cv": round((var ** 0.5) / mean, 4)
                if mean else None,
                "units_done": len(e2e),
                "e2e_p50_s": round(percentile_exact(e2e, 0.50), 4)
                if e2e else None,
                "e2e_p95_s": round(percentile_exact(e2e, 0.95), 4)
                if e2e else None,
                "wall_s": round(wall_s, 3),
            }
            report["modes"][mode] = results
            if len(e2e) != len(work):
                failures.append(
                    f"{mode}: {len(e2e)}/{len(work)} units completed")
        finally:
            queue.close()
    count_m, cost_m = report["modes"].get("count"), \
        report["modes"].get("cost")
    if count_m and cost_m and None not in (
            count_m["e2e_p95_s"], cost_m["e2e_p95_s"],
            count_m["wave_pred_cv"], cost_m["wave_pred_cv"]):
        report["improvement"] = {
            "wave_pred_cv": round(
                count_m["wave_pred_cv"] / max(1e-9, cost_m["wave_pred_cv"]),
                3) if cost_m["wave_pred_cv"] else None,
            "e2e_p95": round(
                count_m["e2e_p95_s"] / max(1e-9, cost_m["e2e_p95_s"]), 3),
        }
        if cost_m["wave_pred_cv"] >= count_m["wave_pred_cv"]:
            failures.append(
                "cost-aware packing did not reduce per-wave "
                f"predicted-seconds spread (cv {cost_m['wave_pred_cv']} "
                f"vs {count_m['wave_pred_cv']})")
        if cost_m["e2e_p95_s"] >= count_m["e2e_p95_s"]:
            failures.append(
                "cost-aware packing did not improve the e2e tail "
                f"(p95 {cost_m['e2e_p95_s']}s vs "
                f"{count_m['e2e_p95_s']}s)")
    else:
        # a mode that completed nothing already appended its failure;
        # the comparison is meaningless without both sides' numbers
        failures.append("pack comparison skipped: a mode has no "
                        "completed units")
    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    if failures:
        for f in failures:
            log.error("pack-bench: %s", f)
        return 1
    log.info("pack-bench: OK — wave-spread cv %s -> %s, e2e p95 %ss -> %ss",
             count_m["wave_pred_cv"], cost_m["wave_pred_cv"],
             count_m["e2e_p95_s"], cost_m["e2e_p95_s"])
    return 0


def _record_ids(queue) -> list[str]:
    with queue._lock:
        return list(queue._jobs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tools serve-soak")
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--srcs", type=int, default=6)
    parser.add_argument("--hrcs", type=int, default=4)
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="fraction of each grid shared across clients")
    parser.add_argument("--executor", default="synthetic")
    parser.add_argument("--device", default="cuda:0",
                        help="device of the wave executor (default cuda:0; "
                             "'cpu' runs its plain CPU route)")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--wave-width", type=int, default=4)
    parser.add_argument("--warm-budget-ms", type=float, default=1000.0,
                        help="warm-hit request latency gate (per request)")
    parser.add_argument("--out", default=None,
                        help="also write the JSON report here")
    parser.add_argument("--root", default=None,
                        help="serve root (default: a fresh temp dir)")
    parser.add_argument("--wave-budget-s", type=float, default=None,
                        help="cost-aware packing budget (predicted "
                             "seconds per wave; serve/cost.py)")
    parser.add_argument("--calibrate-out", default=None, metavar="FILE",
                        help="after the soak, fit the per-host cost-"
                             "prediction scale from the ledger's "
                             "observed/predicted ratios and write the "
                             "fitted coefficients JSON to FILE "
                             "(serve/cost.py calibration)")
    parser.add_argument("--pack-bench", action="store_true",
                        help="bench cost-aware vs count-based wave "
                             "packing instead of running the soak")
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.pack_bench:
        return pack_bench(args)

    from ..serve.service import ChainServeService
    from ..utils.device import DeviceError

    log = get_logger()
    root = args.root or tempfile.mkdtemp(prefix="chain-serve-soak-")
    try:
        service = ChainServeService(
            root=root, port=0, executor=args.executor,
            workers=args.workers, wave_width=args.wave_width,
            wave_budget_s=args.wave_budget_s, device=args.device,
        ).start()
    except (ValueError, DeviceError) as exc:
        # an executor the port does not carry, or a device it cannot
        # open: refuse before any client runs
        log.error("serve-soak: %s", exc)
        return 1
    report: dict = {"clients": args.clients, "srcs": args.srcs,
                    "hrcs": args.hrcs, "overlap": args.overlap,
                    "executor": args.executor, "workers": args.workers,
                    "wave_width": args.wave_width, "root": root}
    failures: list[str] = []
    try:
        planned_before = _planned_serve_jobs()
        tenants = [f"tenant{i % 3}" for i in range(args.clients)]
        results: list[Optional[dict]] = [None] * args.clients
        geometry = [64, 36]

        def _body(i: int, priority: str) -> dict:
            return {
                "tenant": tenants[i],
                "priority": priority,
                "database": "P2STR01",
                **_grid(i, args.srcs, args.hrcs, args.overlap),
                "params": {"geometry": geometry, "size_bytes": 2048},
            }

        def _client(i: int) -> None:
            results[i] = service.submit(
                _body(i, ("interactive", "normal", "bulk")[i % 3])
            )

        t0 = time.perf_counter()
        threads = [threading.Thread(target=_client, args=(i,))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        req_ids = [r["request"] for r in results if r]
        states = {rid: service.wait_request(rid, timeout=120.0)
                  for rid in req_ids}
        cold_wall_s = time.perf_counter() - t0
        incomplete = sorted(r for r, s in states.items() if s != "done")
        if incomplete:
            failures.append(f"requests never completed: {incomplete}")

        # dedup invariant: executions == unique plans
        unique_plans = set()
        for rid in req_ids:
            doc = service.request_status(rid)
            unique_plans.update(u["plan"] for u in doc["units"].values())
        planned = _planned_serve_jobs() - planned_before
        report.update(
            requests=len(req_ids),
            units_total=sum(
                len(service.request_status(rid)["units"]) for rid in req_ids
            ),
            unique_plans=len(unique_plans),
            jobs_planned=planned,
            cold_wall_s=round(cold_wall_s, 3),
        )
        if planned != len(unique_plans):
            failures.append(
                f"duplicate executions: {planned} jobs planned for "
                f"{len(unique_plans)} unique plans"
            )

        # per-phase latency percentiles (queue-wait vs execution vs
        # end-to-end), from the span journal's exact timestamps
        e2e_s = []
        for rid in req_ids:
            doc = service.request_status(rid)
            if doc and doc.get("latency_ms") is not None:
                e2e_s.append(doc["latency_ms"] / 1e3)
        report["latency_phases"] = phase_latencies(root, e2e_s)
        if not report["latency_phases"]["queue_wait_ms"]:
            failures.append("span journal recorded no claim spans — "
                            "phase latency accounting is broken")

        # warm pass: same grids again — store hits, millisecond latency
        warm_latencies = []
        for i in range(args.clients):
            body = _body(i, "interactive")
            t1 = time.perf_counter()
            accepted = service.submit(body)
            state = service.wait_request(accepted["request"], timeout=30.0)
            warm_ms = (time.perf_counter() - t1) * 1e3
            warm_latencies.append(round(warm_ms, 3))
            if state != "done":
                failures.append(
                    f"warm request {accepted['request']} state {state}"
                )
            if not accepted.get("latency_ms"):
                failures.append(
                    f"warm request {accepted['request']} was not answered "
                    "at submit time (latency_ms missing)"
                )
        planned_after_warm = _planned_serve_jobs() - planned_before
        if planned_after_warm != planned:
            failures.append(
                f"warm pass executed {planned_after_warm - planned} job(s); "
                "expected 0"
            )
        warm_sorted = sorted(warm_latencies)
        report.update(
            warm_request_ms={
                "min": warm_sorted[0],
                "p50": warm_sorted[len(warm_sorted) // 2],
                "max": warm_sorted[-1],
            },
            warm_jobs_planned=planned_after_warm - planned,
        )
        if warm_sorted[-1] > args.warm_budget_ms:
            failures.append(
                f"warm request latency {warm_sorted[-1]:.1f} ms over the "
                f"{args.warm_budget_ms:.0f} ms budget"
            )
        if args.calibrate_out:
            # fit from whatever the soak observed (a soak is a
            # deliberate sample, so no minimum-ring gate) and report
            # the full auditable document next to the model error
            from ..serve import cost as serve_cost

            fitted = serve_cost.fit_scale(
                service.cost_ledger.ratios(), min_samples=1
            )
            cal_doc = {
                "fitted": fitted,
                "applied_base_scale": serve_cost.calibration_scale(),
                "model_error": service.cost_ledger.report()["model_error"],
                "host_cpu_count": os.cpu_count(),
            }
            atomic_write_text(
                args.calibrate_out,
                json.dumps(cal_doc, sort_keys=True) + "\n",
            )
            report["calibration"] = cal_doc
            if fitted is None:
                failures.append(
                    "--calibrate-out: no observed/predicted ratios to "
                    "fit from (did any unit execute?)"
                )
    finally:
        service.stop()
    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    if failures:
        for f in failures:
            log.error("serve-soak: %s", f)
        return 1
    log.info(
        "serve-soak: OK — %d requests, %d unique plans, %d executions, "
        "warm p50 %.1f ms",
        report["requests"], report["unique_plans"], report["jobs_planned"],
        report["warm_request_ms"]["p50"],
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
