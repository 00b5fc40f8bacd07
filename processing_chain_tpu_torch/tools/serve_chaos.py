"""`tools serve-chaos` — kill-the-replica proof for the serve fleet.

The multi-replica claims in docs/SERVE.md ("Running multiple
replicas") are statements about DEATH: leases fence ownership, peers
steal a dead replica's work, a zombie resumed after SIGSTOP cannot
settle what it lost, and none of it loses or duplicates work. This
harness makes those claims empirical: it spawns N REAL `chain-serve`
replica processes over ONE shared root (queue + store + requests),
drives an overlapping workload through them over HTTP, and — mid-wave —
SIGKILLs replicas (restarting each as a fresh generation), SIGSTOPs one
past its lease expiry (the zombie), and injects scripted execution
failures (the synthetic executor's `fail_times`/`poison` params:
transient disk-error stand-ins and permanent poison). Then it asserts
the invariants from disk, the store, and the survivors' /metrics:

  * every request reaches a terminal state (poisoned ones `failed`,
    everything else `done`) — no lost units;
  * every done unit's plan has exactly one verified artifact in the
    store (plan-hash identity keeps work exactly-once through any
    number of deaths);
  * every terminal queue record was settled under the epoch its owner
    actually held (`settledEpoch == epoch`) — an accepted fenced-zombie
    settle would break this — and no lease files survive;
  * with a zombie in the run: at least one lease was stolen
    (`chain_serve_lease_steals_total` over the survivors), proving the
    expiry/steal path actually fired;
  * quarantined records exist exactly for the poisoned plans;
  * warm-hit requests POSTed DURING the churn stay under the latency
    budget (default p50 < 50 ms) — replica death must not cost the
    warm path its milliseconds;
  * a voluntary drain/join cycle mid-churn (docs/SERVE.md "Draining a
    replica"): POST /v1/drain flips one replica to `draining` — its
    /healthz and serve-info must advertise it — and `{"resume": true}`
    returns it to rotation with /healthz back to `ok`;
  * with `--corrupt-corpus`: hostile-upload stand-ins (`poison_src`
    units) are convicted into the SRC-digest poison registry, queued
    siblings are swept without executing, a fresh request against a
    convicted digest parks at POST time, and the registry holds
    EXACTLY the injected digests (docs/ROBUSTNESS.md);
  * with `--throughput-floor N`: done-units/s measured over the whole
    churn window must stay at or above N (ROADMAP item 3: replica
    death and poison churn must not starve the settle path).

Prints one JSON report line (the `SERVE_CHAOS_*.json` artifact
committed with the PR) and exits nonzero on any violated invariant.
`--self-test` proves the harness can fail: it runs a small clean pass,
then tampers with the on-disk state (a stale settled epoch, a
resurrected 'active' request, a deleted store object) and demands the
checker report every seeded violation.

    python -m processing_chain_tpu_torch tools serve-chaos
        [--replicas 3] [--kills 2] [--stops 1] [--lease-s 1.5]
        [--clients 6] [--srcs 8] [--hrcs 5] [--overlap 0.5]
        [--work-ms 80] [--workers 2] [--wave-width 4]
        [--warm-probes 15] [--warm-budget-ms 50]
        [--no-inject] [--timeout-s 180] [--out FILE] [--root DIR]
        [--self-test]

The port's copy of processing_chain_tpu/tools/serve_chaos.py. Its
replicas are the port's `chain-serve` daemons with the synthetic
executor, which does no device work; the report adds each replica
generation's seconds from spawn to a healthy `/healthz`
(`replica_healthz_s`): each replica's interpreter imports the port's
serve modules (not torch) before it listens, and the harness waits 60 s
for it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from ..utils.fsio import atomic_write_json, atomic_write_text
from ..utils.log import get_logger

_SHARED_GEOMETRY = [64, 36]

#: /metrics counters summed over the surviving replicas for the report
_SCRAPED = (
    "chain_serve_lease_steals_total",
    "chain_serve_fenced_settles_total",
    "chain_serve_quarantined_total",
    "chain_serve_claim_reverts_total",
    "chain_serve_poisoned_total",
)

def _synthetic_digest(src: str, database: str = "P2STR01") -> str:
    """The SyntheticExecutor's SRC content digest for one corpus SRC —
    ONE source of truth (serve/executors.py src_digest), so the gate's
    registry expectations can never drift from the executor's identity."""
    from ..serve.executors import SyntheticExecutor

    return SyntheticExecutor().src_digest(
        {"database": database, "src": src})


#: the --corrupt-corpus workload: hostile-upload stand-ins (the
#: synthetic executor's `poison_src` param — every unit settles with
#: the `poison` kind, quarantining the SRC's synthetic content digest
#: fleet-wide, docs/ROBUSTNESS.md)
_CORRUPT_SRCS = ("SRC950", "SRC951")


# ------------------------------------------------------------ replicas


class _Replica:
    """One chain-serve daemon process of the fleet."""

    def __init__(self, index: int, generation: int, proc, info: dict,
                 log_path: str, healthz_s: float) -> None:
        self.index = index
        self.generation = generation
        self.proc = proc
        self.info = info
        self.log_path = log_path
        #: spawn to the first healthy /healthz answer
        self.healthz_s = healthz_s

    @property
    def url(self) -> str:
        return self.info["url"]

    def alive(self) -> bool:
        return self.proc.poll() is None


def _spawn_replica(root: str, index: int, generation: int,
                   args) -> _Replica:
    """Start one replica over the shared root and wait for /healthz."""
    info_path = os.path.join(root, f"replica-{index}-g{generation}.json")
    log_path = os.path.join(root, "logs",
                            f"replica-{index}-g{generation}.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    argv = [
        sys.executable, "-m", "processing_chain_tpu_torch", "tools",
        "chain-serve",
        "--root", root,
        "--port", "0",
        "--executor", "synthetic",
        "--workers", str(args.workers),
        "--wave-width", str(args.wave_width),
        "--max-attempts", str(args.max_attempts),
        "--lease-s", str(args.lease_s),
        "--poll-s", str(args.poll_s),
        "--replica-id", f"chaos-r{index}-g{generation}",
        "--info-file", info_path,
    ]
    t0 = time.monotonic()
    log_f = open(log_path, "ab")
    try:
        # chainlint: disable=subprocess-hygiene (chaos replicas are long-running daemons the harness must SIGKILL/SIGSTOP mid-execution; runner.shell runs a child to completion and cannot deliver mid-flight signals)
        proc = subprocess.Popen(
            argv, stdout=log_f, stderr=log_f,
        )
    finally:
        log_f.close()  # the child owns the fd now
    deadline = time.monotonic() + 60.0
    info: Optional[dict] = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica {index} g{generation} died on startup "
                f"(rc {proc.returncode}); log: {log_path}"
            )
        try:
            with open(info_path) as f:
                info = json.load(f)
            with urllib.request.urlopen(info["url"] + "/healthz",
                                        timeout=2.0):
                break
        except (OSError, ValueError, KeyError):
            time.sleep(0.1)
    else:
        proc.kill()
        raise RuntimeError(
            f"replica {index} g{generation} never became healthy; "
            f"log: {log_path}"
        )
    return _Replica(index, generation, proc, info, log_path,
                    round(time.monotonic() - t0, 3))


def _post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def _scrape_metrics(replicas: list) -> dict:
    """Sum the _SCRAPED counters over every live replica's /metrics.
    Dead generations took their counters with them — the sums are a
    floor, which is the direction the gates need (steals observed ≥
    threshold)."""
    totals = {name: 0.0 for name in _SCRAPED}
    for rep in replicas:
        if not rep.alive():
            continue
        try:
            with urllib.request.urlopen(rep.url + "/metrics",
                                        timeout=5.0) as resp:
                text = resp.read().decode()
        except OSError:
            continue
        for line in text.splitlines():
            for name in _SCRAPED:
                if line.startswith(name + " ") or \
                        line.startswith(name + "{"):
                    try:
                        totals[name] += float(line.rsplit(None, 1)[-1])
                    except ValueError:
                        pass
    return {name: int(v) for name, v in totals.items()}


# ------------------------------------------------------------ workload


def _grid(client: int, n_srcs: int, n_hrcs: int, overlap: float) -> dict:
    """Client grids share a common core (the overlap fraction) plus a
    per-client disjoint tail — the serve-soak shape, so the fleet sees
    real cross-request singleflight while it is being killed."""
    shared = max(1, int(n_srcs * overlap))
    srcs = [f"SRC{100 + i:03d}" for i in range(shared)]
    srcs += [f"SRC{500 + client * 16 + i:03d}"
             for i in range(n_srcs - shared)]
    hrcs = [f"HRC{100 + i:03d}" for i in range(n_hrcs)]
    return {"srcs": srcs, "hrcs": hrcs}


def _seed_body(args) -> dict:
    """The warm-probe grid: the shared core, completed BEFORE the chaos
    so mid-churn probes are store hits by construction."""
    shared = max(1, int(args.srcs * args.overlap))
    return {
        "tenant": "seed", "priority": "interactive",
        "database": "P2STR01",
        "srcs": [f"SRC{100 + i:03d}" for i in range(shared)],
        "hrcs": [f"HRC{100 + i:03d}" for i in range(args.hrcs)],
        "params": {"geometry": _SHARED_GEOMETRY,
                   "size_bytes": args.size_bytes},
    }


def _load_requests(root: str) -> dict:
    """Every request doc on disk — the harness's ground truth (it
    outlives any replica)."""
    docs = {}
    req_dir = os.path.join(root, "requests")
    try:
        names = os.listdir(req_dir)
    except OSError:
        return docs
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(req_dir, name)) as f:
                doc = json.load(f)
            docs[doc["request"]] = doc
        except (OSError, ValueError, KeyError):
            continue
    return docs


def _load_records(root: str) -> dict:
    records = {}
    jobs_dir = os.path.join(root, "queue", "jobs")
    try:
        names = os.listdir(jobs_dir)
    except OSError:
        return records
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(jobs_dir, name)) as f:
                doc = json.load(f)
            records[doc["job"]] = doc
        except (OSError, ValueError, KeyError):
            continue
    return records


# ----------------------------------------------------------- invariants


def check_invariants(root: str, poisoned: set,
                     expect_failed: Optional[set] = None) -> list[str]:
    """The chaos contract, checked from durable state only (no live
    replica required): requests terminal with the right disposition,
    exactly one verified artifact per done plan, every terminal record
    settled under the epoch its owner held, no surviving leases,
    quarantine exactly for the poisoned plans — and TRACE COMPLETENESS:
    every terminal record's span chain is gapless (serve/spans.py),
    even for work whose owner was SIGKILLed mid-wave."""
    from ..serve import spans as serve_spans
    from ..store.store import ArtifactStore, StoreCorruption

    violations: list[str] = []
    expect_failed = expect_failed if expect_failed is not None else poisoned
    docs = _load_requests(root)
    records = _load_records(root)
    store = ArtifactStore(os.path.join(root, "store"))
    if not docs:
        violations.append("no request docs found — the run produced nothing")

    for req_id, doc in sorted(docs.items()):
        state = doc.get("state")
        if state == "active":
            violations.append(f"request {req_id} never reached a terminal "
                              "state")
            continue
        should_fail = req_id in expect_failed
        if should_fail and state != "failed":
            violations.append(f"poisoned request {req_id} ended {state!r}, "
                              "expected failed")
        if not should_fail and state != "done":
            violations.append(f"request {req_id} ended {state!r} "
                              f"(error: {doc.get('error')})")
        if state != "done":
            continue
        for pvs_id, unit in doc.get("units", {}).items():
            plan = unit["plan"]
            manifest = store.lookup(plan)
            if manifest is None:
                violations.append(
                    f"lost unit: {req_id}/{pvs_id} is 'done' but plan "
                    f"{plan[:12]}… has no store artifact")
                continue
            try:
                store.verify_object(manifest.object)
            except StoreCorruption as exc:
                violations.append(
                    f"corrupt artifact for {req_id}/{pvs_id} "
                    f"({plan[:12]}…): {exc}")

    jobs_dir = os.path.join(root, "queue", "jobs")
    quarantined_plans = set()
    for job_id, rec in sorted(records.items()):
        state = rec.get("state")
        if state not in ("done", "failed", "quarantined"):
            violations.append(
                f"record {job_id} left non-terminal: {state!r}")
        settled = rec.get("settledEpoch")
        if state in ("done", "failed", "quarantined") and \
                settled is not None and settled != rec.get("epoch"):
            violations.append(
                f"record {job_id} settled under epoch {settled} but owns "
                f"epoch {rec.get('epoch')} — a fenced settle was ACCEPTED")
        if state == "quarantined":
            quarantined_plans.add(rec.get("planHash"))
            if rec.get("planHash") not in poisoned:
                violations.append(
                    f"record {job_id} quarantined but its plan was never "
                    "poisoned")
        if os.path.isfile(os.path.join(jobs_dir,
                                       job_id + ".json.inprogress")):
            violations.append(f"record {job_id} still carries a lease "
                              "after the run")
    for plan in poisoned - quarantined_plans:
        violations.append(f"poisoned plan {plan[:12]}… was never "
                          "quarantined")
    # trace completeness: the span journal must fully explain every
    # terminal record across all the deaths the schedule delivered
    violations.extend(serve_spans.verify_completeness(root,
                                                      records=records))
    return violations


# ------------------------------------------------------------ the run


def _percentile(values: list, frac: float) -> float:
    from ..telemetry.fleet import percentile_exact

    return percentile_exact(values, frac)


def run_chaos(args, root: str) -> dict:
    """Execute the chaos schedule; returns the report dict."""
    log = get_logger()
    replicas: list[_Replica] = []
    report: dict = {
        "replicas": args.replicas, "kills": args.kills,
        "stops": args.stops, "lease_s": args.lease_s,
        "clients": args.clients, "srcs": args.srcs, "hrcs": args.hrcs,
        "overlap": args.overlap, "work_ms": args.work_ms,
        "workers": args.workers, "wave_width": args.wave_width,
        "max_attempts": args.max_attempts, "inject": args.inject,
        "root": root,
    }
    failures: list[str] = []
    poisoned_plans: set = set()
    try:
        for i in range(args.replicas):
            replicas.append(_spawn_replica(root, i, 0, args))
        log.info("serve-chaos: %d replicas up", len(replicas))

        def live() -> list:
            return [r for r in replicas if r.alive()]

        # ---- seed the warm core (the mid-churn probes' grid) ----------
        seed = _post_json(replicas[0].url + "/v1/requests",
                          _seed_body(args))
        deadline = time.monotonic() + args.timeout_s
        while time.monotonic() < deadline:
            doc = _load_requests(root).get(seed["request"], {})
            if doc.get("state") == "done":
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("seed request never completed")

        # ---- the overlapping burst, round-robin over the fleet --------
        accepted: list = [None] * args.clients
        expect_failed: set = set()

        def _client(i: int) -> None:
            body = {
                "tenant": f"tenant{i % 3}",
                "priority": ("interactive", "normal", "bulk")[i % 3],
                "database": "P2STR01",
                **_grid(i, args.srcs, args.hrcs, args.overlap),
                "params": {"geometry": _SHARED_GEOMETRY,
                           "size_bytes": args.size_bytes,
                           "work_ms": args.work_ms},
            }
            url = replicas[i % len(replicas)].url
            accepted[i] = _post_json(url + "/v1/requests", body)

        threads = [threading.Thread(target=_client, args=(i,))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if args.inject:
            # transient injection: every unit fails once, then succeeds
            # (retry + backoff across whatever replicas survive)
            transient = _post_json(replicas[0].url + "/v1/requests", {
                "tenant": "faulty", "priority": "normal",
                "database": "P2STR01",
                "srcs": ["SRC900", "SRC901"], "hrcs": ["HRC100"],
                "params": {"geometry": [48, 28], "fail_times": 1,
                           "size_bytes": args.size_bytes},
            })
            # permanent poison: quarantined plans, failed request
            poison = _post_json(
                replicas[-1].url + "/v1/requests", {
                    "tenant": "toxic", "priority": "normal",
                    "database": "P2STR01",
                    "srcs": ["SRC910"], "hrcs": ["HRC100", "HRC101"],
                    "params": {"poison": True},
                })
            expect_failed.add(poison["request"])
            report["transient_request"] = transient["request"]
            report["poison_request"] = poison["request"]

        if args.corrupt_corpus:
            # the corrupt-upload workload (docs/ROBUSTNESS.md): two
            # hostile SRCs × two HRCs from one tenant, POSTed INTO the
            # churn — the first solo-wave conviction must quarantine
            # each SRC's content digest and sweep its queued siblings
            # without executing them
            corrupt = _post_json(replicas[0].url + "/v1/requests", {
                "tenant": "uploads", "priority": "normal",
                "database": "P2STR01",
                "srcs": list(_CORRUPT_SRCS),
                "hrcs": ["HRC100", "HRC101"],
                "params": {"poison_src": True, "geometry": [32, 18],
                           "size_bytes": args.size_bytes},
            })
            expect_failed.add(corrupt["request"])
            report["corrupt_request"] = corrupt["request"]

        # ---- throughput sampler: done units over the churn window ----
        thr_samples: list = []
        thr_stop = threading.Event()

        def _thr_sampler() -> None:
            while not thr_stop.is_set():
                done_now = sum(
                    1 for r in _load_records(root).values()
                    if r.get("state") == "done"
                )
                thr_samples.append((time.monotonic(), done_now))
                thr_stop.wait(0.25)

        thr_thread = threading.Thread(target=_thr_sampler, daemon=True)
        thr_thread.start()

        # ---- chaos schedule ------------------------------------------
        zombie: Optional[_Replica] = None
        resume_timer: Optional[threading.Timer] = None
        if args.stops > 0 and len(live()) > 1:
            time.sleep(args.stop_delay_s)
            zombie = live()[-1]
            zombie_pid = zombie.proc.pid
            os.kill(zombie_pid, signal.SIGSTOP)
            report["zombie"] = f"r{zombie.index}-g{zombie.generation}"
            log.info("serve-chaos: SIGSTOP replica %d (the zombie)",
                     zombie.index)

            def _resume() -> None:
                try:
                    os.kill(zombie_pid, signal.SIGCONT)
                    log.info("serve-chaos: SIGCONT the zombie")
                except OSError:
                    pass

            # resumed from a TIMER, not the main thread: a zombie
            # frozen inside a queue critical section holds the shared
            # flock, and a restarting replica then blocks in recovery
            # until the zombie continues — the resume must not wait on
            # anything that might wait on the zombie
            resume_timer = threading.Timer(args.stop_s, _resume)
            resume_timer.daemon = True
            resume_timer.start()

        kills_done = 0
        for k in range(args.kills):
            time.sleep(args.kill_delay_s)
            victims = [r for r in live() if r is not zombie]
            if not victims:
                break
            victim = victims[(k + 1) % len(victims)]
            victim.proc.kill()
            victim.proc.wait(timeout=30)
            kills_done += 1
            log.info("serve-chaos: SIGKILL replica %d g%d",
                     victim.index, victim.generation)
            time.sleep(args.restart_delay_s)
            replicas.append(
                _spawn_replica(root, victim.index,
                               victim.generation + 1, args))

        # ---- warm probes DURING the churn ----------------------------
        warm_ms: list = []
        probe_body = _seed_body(args)
        for _ in range(args.warm_probes):
            target = [r for r in live() if r is not zombie][0]
            t0 = time.perf_counter()
            probe = _post_json(target.url + "/v1/requests", probe_body,
                               timeout=10.0)
            warm_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            if probe.get("state") != "done" or \
                    not probe.get("latency_ms"):
                failures.append(
                    f"warm probe {probe.get('request')} was not answered "
                    f"at POST time (state {probe.get('state')})")
            time.sleep(0.05)

        # ---- drain/join cycle: one replica bows out and rejoins ------
        # (docs/SERVE.md "Draining a replica"): POST /v1/drain flips
        # the replica to draining — /healthz and serve-info advertise
        # it, the scheduler stops claiming, peers absorb the queue —
        # then {"resume": true} puts it back in rotation. Run INSIDE
        # the churn so the fleet proves it survives a voluntary exit
        # on top of the involuntary ones.
        candidates = [r for r in live() if r is not zombie]
        if len(candidates) >= 2:
            drained = candidates[-1]
            drain_info: dict = {"replica":
                                f"r{drained.index}-g{drained.generation}"}
            _post_json(drained.url + "/v1/drain", {}, timeout=10.0)
            with urllib.request.urlopen(drained.url + "/healthz",
                                        timeout=5.0) as resp:
                health = json.load(resp)
            drain_info["healthz_draining"] = health.get("status")
            if health.get("status") != "draining":
                failures.append(
                    f"drained replica's /healthz reports "
                    f"{health.get('status')!r}, expected 'draining'")
            info_path = os.path.join(
                root, f"replica-{drained.index}-"
                      f"g{drained.generation}.json")
            try:
                with open(info_path) as f:
                    drain_info["info_state"] = json.load(f).get("state")
            except (OSError, ValueError):
                drain_info["info_state"] = None
            if drain_info["info_state"] != "draining":
                failures.append(
                    "drained replica's serve-info never flipped to "
                    f"'draining' (saw {drain_info['info_state']!r})")
            # the fleet keeps settling while one member sits out
            time.sleep(max(0.5, args.poll_s))
            _post_json(drained.url + "/v1/drain", {"resume": True},
                       timeout=10.0)
            with urllib.request.urlopen(drained.url + "/healthz",
                                        timeout=5.0) as resp:
                health = json.load(resp)
            drain_info["healthz_resumed"] = health.get("status")
            if health.get("status") != "ok":
                failures.append(
                    f"resumed replica's /healthz reports "
                    f"{health.get('status')!r}, expected 'ok'")
            report["drain_cycle"] = drain_info

        # ---- fail-fast: a fresh tenant hits a poisoned digest --------
        if args.corrupt_corpus:
            # wait for the first conviction to land in the registry
            # (it needs a solo-wave verdict, which the jittered backoff
            # delivers), then a NEW plan (fresh HRC) against the same
            # SRC must park at enqueue — quarantined with zero
            # executions — instead of burning its own attempts budget
            digest0 = _synthetic_digest(_CORRUPT_SRCS[0])
            registry0 = os.path.join(root, "queue", "poison",
                                     digest0 + ".json")
            deadline = time.monotonic() + args.timeout_s
            while time.monotonic() < deadline and \
                    not os.path.isfile(registry0):
                time.sleep(0.2)
            if not os.path.isfile(registry0):
                failures.append(
                    f"corrupt-corpus: digest of {_CORRUPT_SRCS[0]} never "
                    "reached the poison registry")
            failfast = _post_json(
                [r for r in live() if r is not zombie][0].url
                + "/v1/requests", {
                    "tenant": "other", "priority": "normal",
                    "database": "P2STR01",
                    "srcs": [_CORRUPT_SRCS[0]], "hrcs": ["HRC103"],
                    "params": {"poison_src": True, "geometry": [32, 18],
                               "size_bytes": args.size_bytes},
                })
            expect_failed.add(failfast["request"])
            report["corrupt_failfast_request"] = failfast["request"]

        # ---- zombie resume: its settles must be fenced, not accepted -
        if resume_timer is not None:
            resume_timer.join()

        # ---- wait for every request to reach a terminal state --------
        deadline = time.monotonic() + args.timeout_s
        pending: list = []
        while time.monotonic() < deadline:
            docs = _load_requests(root)
            pending = [r for r, d in docs.items()
                       if d.get("state") == "active"]
            if not pending:
                records = _load_records(root)
                busy = [j for j, r in records.items()
                        if r.get("state") in ("queued", "running")]
                if not busy:
                    break
            time.sleep(0.25)
        else:
            failures.append(f"timeout: still unsettled after "
                            f"{args.timeout_s}s: requests {pending[:5]}")

        # ---- throughput floor during churn (ROADMAP item 3) ----------
        thr_stop.set()
        thr_thread.join(timeout=10.0)
        churn_units_per_s: Optional[float] = None
        if len(thr_samples) >= 2:
            (t_a, n_a), (t_b, n_b) = thr_samples[0], thr_samples[-1]
            if t_b > t_a:
                churn_units_per_s = round((n_b - n_a) / (t_b - t_a), 3)
        report["churn_throughput_units_per_s"] = churn_units_per_s
        if args.throughput_floor > 0:
            if churn_units_per_s is None:
                failures.append("throughput floor: too few samples to "
                                "measure churn throughput")
            elif churn_units_per_s < args.throughput_floor:
                failures.append(
                    f"churn throughput {churn_units_per_s:.2f} units/s "
                    f"under the {args.throughput_floor:g} units/s floor "
                    "— replica death/poison churn is starving the "
                    "settle path")

        # poisoned plan hashes, for the quarantine invariant
        docs = _load_requests(root)
        for req_id in expect_failed:
            for unit in docs.get(req_id, {}).get("units", {}).values():
                poisoned_plans.add(unit["plan"])

        # fleet view captured WHILE survivors are still serving — the
        # per-(tenant × priority) SLO histograms merged over the fleet
        # as they stood during/after the churn (FLEET_OBS artifact)
        try:
            from ..telemetry import fleet as fleet_mod

            fleet_doc = fleet_mod.fleet_view(root)
        except Exception as exc:  # noqa: BLE001 - the view must not sink the run
            fleet_doc = {"error": repr(exc)}
            failures.append(f"fleet view failed to build: {exc!r}")
        report["fleet"] = {
            "alive": fleet_doc.get("alive"),
            "replicas": len(fleet_doc.get("replicas", [])),
            "spans": fleet_doc.get("spans"),
            "slo_flows": sum(
                len(p) for t in fleet_doc.get("slo", {}).values()
                for p in t.values()
            ),
        }
        if args.fleet_out:
            atomic_write_json(args.fleet_out, fleet_doc)
        if not fleet_doc.get("slo"):
            failures.append("fleet view carries no SLO histograms — "
                            "the phase metrics never recorded")

        counters = _scrape_metrics(live())
        report["counters"] = counters
        report["replica_healthz_s"] = {
            f"r{r.index}-g{r.generation}": r.healthz_s for r in replicas}
        report["kills_done"] = kills_done
        report["warm_request_ms"] = {
            "probes": len(warm_ms),
            "min": min(warm_ms) if warm_ms else None,
            "p50": _percentile(warm_ms, 0.50) if warm_ms else None,
            "p90": _percentile(warm_ms, 0.90) if warm_ms else None,
            "max": max(warm_ms) if warm_ms else None,
        }
        units_total = sum(len(d.get("units", {})) for d in docs.values())
        unique_plans = {u["plan"] for d in docs.values()
                        for u in d.get("units", {}).values()}
        report["requests"] = len(docs)
        report["units_total"] = units_total
        report["unique_plans"] = len(unique_plans)

        # ---- corrupt-corpus invariants (docs/ROBUSTNESS.md) ----------
        if args.corrupt_corpus:
            records = _load_records(root)
            expected_digests = {
                _synthetic_digest(src) for src in _CORRUPT_SRCS
            }
            registry = set()
            poison_dir = os.path.join(root, "queue", "poison")
            try:
                registry = {n[:-5] for n in os.listdir(poison_dir)
                            if n.endswith(".json")}
            except OSError:
                pass
            for digest in expected_digests - registry:
                failures.append(f"corrupt-corpus: digest {digest[:12]}… "
                                "missing from the poison registry")
            for digest in registry - expected_digests:
                failures.append(f"corrupt-corpus: digest {digest[:12]}… "
                                "quarantined but never injected")
            poison_recs = [r for r in records.values()
                           if r.get("errorKind") == "poison"]
            if not poison_recs:
                failures.append("corrupt-corpus: no record settled with "
                                "the poison kind")
            for rec in poison_recs:
                if rec.get("state") != "quarantined":
                    failures.append(
                        f"corrupt-corpus: poison record {rec.get('job')} "
                        f"ended {rec.get('state')!r}, expected "
                        "quarantined")
            swept = [r for r in poison_recs
                     if r.get("state") == "quarantined"
                     and not r.get("attempts")]
            if not swept:
                failures.append(
                    "corrupt-corpus: no sibling was swept without "
                    "executing (attempts == 0) — digest fail-fast never "
                    "fired")
            report["corrupt_corpus"] = {
                "digests": len(registry),
                "poison_records": len(poison_recs),
                "swept_without_executing": len(swept),
            }

        # ---- invariants ----------------------------------------------
        failures.extend(check_invariants(root, poisoned_plans,
                                         expect_failed=expect_failed))
        if kills_done < args.kills:
            failures.append(f"only {kills_done}/{args.kills} kills were "
                            "delivered (fleet too small?)")
        # the /metrics scrape is a floor over the replicas still alive
        # at capture time — a stealer killed LATER in the schedule took
        # its counter with it. The durable span journal records every
        # steal fleet-wide, so it is the authoritative count.
        steals_observed = max(
            counters["chain_serve_lease_steals_total"],
            (report.get("fleet", {}).get("spans", {}) or {})
            .get("by_phase", {}).get("steal", 0),
        )
        if args.stops > 0 and steals_observed < 1:
            failures.append(
                "SIGSTOP zombie produced no lease steal — the run proved "
                "nothing about fencing (lower --lease-s or raise "
                "--work-ms/--stop-s)")
        if warm_ms and args.warm_budget_ms > 0 and \
                _percentile(warm_ms, 0.50) > args.warm_budget_ms:
            failures.append(
                f"warm p50 {_percentile(warm_ms, 0.50):.1f} ms over the "
                f"{args.warm_budget_ms:.0f} ms budget under churn")
    finally:
        for rep in replicas:
            if rep.alive():
                try:
                    os.kill(rep.proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                rep.proc.terminate()
        for rep in replicas:
            if rep.proc.poll() is None:
                try:
                    rep.proc.wait(timeout=20)
                except Exception:  # noqa: BLE001 - last resort on a wedged child
                    rep.proc.kill()
    report["failures"] = failures
    report["ok"] = not failures
    return report


# ----------------------------------------------------------- self-test


def run_self_test(args, root: str) -> int:
    """Prove the invariant checker can FAIL (the repo's standing
    gate-must-be-able-to-fire discipline): run a small clean pass, then
    seed three distinct corruptions into the durable state and demand
    the checker reports each class."""
    log = get_logger()
    args.replicas, args.kills, args.stops = 1, 0, 0
    args.clients, args.srcs, args.hrcs = 2, 2, 2
    args.inject = False
    args.corrupt_corpus = False
    args.throughput_floor = 0.0
    args.warm_probes = 2
    args.work_ms = 5
    report = run_chaos(args, root)
    if not report["ok"]:
        log.error("serve-chaos self-test: clean pass FAILED: %s",
                  report["failures"])
        return 1
    records = _load_records(root)
    done = [r for r in records.values() if r.get("state") == "done"]
    docs = _load_requests(root)
    some_req = sorted(docs)[0]
    jobs_dir = os.path.join(root, "queue", "jobs")
    # 1) a fenced settle "accepted": settled epoch behind the record's
    rec = done[0]
    rec["settledEpoch"] = int(rec.get("epoch", 1)) - 1
    atomic_write_json(os.path.join(jobs_dir, rec["job"] + ".json"), rec)
    # 2) a request resurrected to 'active' (never-terminal class)
    doc = docs[some_req]
    doc["state"] = "active"
    atomic_write_json(os.path.join(root, "requests", some_req + ".json"),
                      doc)
    # 3) a lost artifact: delete a store object whose plan a STILL-done
    # request (not the one resurrected above) depends on
    from ..store.store import ArtifactStore

    store = ArtifactStore(os.path.join(root, "store"))
    victim_plan = None
    for req_id, d in sorted(docs.items()):
        if req_id == some_req or d.get("state") != "done":
            continue
        for unit in d.get("units", {}).values():
            if store.lookup(unit["plan"]) is not None:
                victim_plan = unit["plan"]
                break
        if victim_plan:
            break
    if victim_plan is None:
        log.error("serve-chaos self-test: no deletable artifact found")
        return 1
    manifest = store.lookup(victim_plan)
    os.unlink(store.object_path(manifest.object["sha256"]))
    # 4) a trace gap: strip one done job's claim spans from every
    # journal — its terminal record is then unexplained (an ownership
    # epoch no span introduced), which the completeness check must flag
    gap_job = done[-1]["job"]
    spans_dir = os.path.join(root, "queue", "spans")
    for name in os.listdir(spans_dir):
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(spans_dir, name)
        with open(path) as f:
            lines = f.readlines()
        kept = []
        for line in lines:
            try:
                span = json.loads(line)
            except ValueError:
                kept.append(line)
                continue
            if span.get("job") == gap_job and span.get("phase") == "claim":
                continue
            kept.append(line)
        # chainlint: disable=atomic-write (self-test tamper harness: deliberately corrupting the journal the checker must then flag)
        with open(path, "w") as f:
            f.writelines(kept)
    violations = check_invariants(root, set())
    classes = {
        "fenced": any("fenced settle was ACCEPTED" in v
                      for v in violations),
        "active": any("never reached a terminal" in v
                      for v in violations),
        "artifact": any(("no store artifact" in v or
                         "corrupt artifact" in v) for v in violations),
        "trace": any(("chain has a gap" in v or
                      "no spans at all" in v) for v in violations),
    }
    print(json.dumps({"self_test": True, "violations": violations,
                      "classes": classes}))
    if all(classes.values()):
        log.info("serve-chaos self-test OK: all %d seeded corruption "
                 "classes detected", len(classes))
        return 0
    log.error("serve-chaos self-test: checker MISSED seeded corruption: "
              "%s", classes)
    return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tools serve-chaos",
        description="multi-replica kill/steal/fence proof harness "
                    "(docs/SERVE.md)",
    )
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--kills", type=int, default=2,
                   help="replicas to SIGKILL mid-run (each restarted)")
    p.add_argument("--stops", type=int, default=1,
                   help="1 = SIGSTOP one replica past its lease (zombie)")
    p.add_argument("--lease-s", type=float, default=1.5)
    p.add_argument("--poll-s", type=float, default=0.3,
                   help="replica maintenance tick (steal latency)")
    p.add_argument("--clients", type=int, default=6)
    p.add_argument("--srcs", type=int, default=8)
    p.add_argument("--hrcs", type=int, default=5)
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--work-ms", type=float, default=80.0)
    p.add_argument("--size-bytes", type=int, default=2048)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--wave-width", type=int, default=4)
    p.add_argument("--max-attempts", type=int, default=3)
    p.add_argument("--stop-delay-s", type=float, default=0.6,
                   help="burst-to-SIGSTOP delay (zombie must hold claims)")
    p.add_argument("--stop-s", type=float, default=5.0,
                   help="how long the zombie stays stopped (> lease-s)")
    p.add_argument("--kill-delay-s", type=float, default=0.5)
    p.add_argument("--restart-delay-s", type=float, default=0.8)
    p.add_argument("--warm-probes", type=int, default=15)
    p.add_argument("--warm-budget-ms", type=float, default=50.0,
                   help="p50 gate for warm POSTs during churn (0 = off)")
    p.add_argument("--no-inject", dest="inject", action="store_false",
                   help="skip the transient/poison fault-injection "
                        "requests")
    p.add_argument("--corrupt-corpus", action="store_true",
                   help="drive the hostile-upload workload through the "
                        "churn: poison-SRC units whose content digests "
                        "must quarantine fleet-wide with fail-fast "
                        "sweeps (docs/ROBUSTNESS.md)")
    p.add_argument("--throughput-floor", type=float, default=0.0,
                   help="minimum done-units/s over the churn window "
                        "(0 = report only; ROADMAP item 3 gate)")
    p.add_argument("--timeout-s", type=float, default=180.0)
    p.add_argument("--out", default=None,
                   help="also write the JSON report here")
    p.add_argument("--fleet-out", default=None,
                   help="write the merged fleet view (replicas + SLO "
                        "histograms captured during churn) here")
    p.add_argument("--root", default=None,
                   help="shared fleet root (default: a fresh temp dir)")
    p.add_argument("--self-test", action="store_true",
                   help="prove the invariant checker can fail")
    args = p.parse_args(list(argv) if argv is not None else None)

    root = os.path.abspath(args.root or
                           tempfile.mkdtemp(prefix="chain-serve-chaos-"))
    os.makedirs(root, exist_ok=True)
    if args.self_test:
        return run_self_test(args, root)
    report = run_chaos(args, root)
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    log = get_logger()
    if report["failures"]:
        for f in report["failures"]:
            log.error("serve-chaos: %s", f)
        return 1
    log.info(
        "serve-chaos: OK — %d requests / %d units / %d plans through "
        "%d kills + %d stop(s); %d lease steal(s), %d fenced settle(s), "
        "warm p50 %s ms",
        report["requests"], report["units_total"], report["unique_plans"],
        report["kills_done"], args.stops,
        report["counters"]["chain_serve_lease_steals_total"],
        report["counters"]["chain_serve_fenced_settles_total"],
        report["warm_request_ms"]["p50"],
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
