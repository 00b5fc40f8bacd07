"""`tools queue-crashcheck` — crash-consistency proof for the serve queue.

The DurableQueue's whole promise is that a daemon can die at ANY disk
boundary and a restart reaches a sane state (docs/SERVE.md). This
harness makes that promise exhaustive instead of anecdotal: it runs a
scripted queue workload that exercises every transition of the declared
state machine (serve/queue.py STATES/TRANSITIONS), counts the
`fsio.atomic_write_json` boundaries it crosses, then replays the
workload once per boundary × crash mode:

  * ``before`` — the process dies with the write NOT on disk (the
    os.replace never happened);
  * ``after``  — the process dies the instant the write landed (nothing
    after the replace executed).

Each injected death abandons the in-memory queue (exactly what SIGKILL
does), reopens a fresh ``DurableQueue`` on the same root, and asserts
the recovered world:

  * every record's state is a DECLARED state, and never ``running`` —
    recovery must requeue interrupted executions, not strand them;
  * no ``.inprogress`` sentinel survives recovery;
  * the in-memory queued index matches the records' states exactly;
  * the queue still DRAINS: claiming and completing everything queued
    leaves every record terminal (no stuck work).

Exit 0 with a one-line JSON summary on success; exit 1 listing every
violated fault point otherwise.

The pytest lane (tests/test_torch_queue_crashcheck.py) runs the same
harness in-process.

The port's copy of processing_chain_tpu/tools/queue_crashcheck.py,
without `--render-table` (the docs table renders from the reference's
chainlint, which the port does not carry; the port's queue declares the
same transitions).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

from ..serve import queue as queue_mod
from ..serve.queue import STATES, TERMINAL, TRANSITIONS, DurableQueue
from ..utils.log import get_logger


class _InjectedCrash(BaseException):
    """Simulated process death: BaseException so no handler in the
    queue's own code can swallow it (mirroring what SIGKILL 'catches')."""


class _FaultyWriter:
    """Wraps atomic_write_json: counts boundaries, dies at one of them."""

    def __init__(self, real, fault_at: Optional[int] = None,
                 mode: str = "before") -> None:
        self.real = real
        self.fault_at = fault_at
        self.mode = mode
        self.count = 0

    def __call__(self, path, obj, **kw):
        self.count += 1
        if self.fault_at is not None and self.count == self.fault_at:
            if self.mode == "before":
                raise _InjectedCrash(f"died before write #{self.count}")
            self.real(path, obj, **kw)
            raise _InjectedCrash(f"died after write #{self.count}")
        self.real(path, obj, **kw)


def _unit(n: int) -> dict:
    return {"database": "DB", "src": f"SRC{n:03d}", "hrc": "HRC000",
            "params": {}, "pvs_id": f"DB_SRC{n:03d}_HRC000"}


def _scenario(q: DurableQueue) -> None:
    """Exercise every declared edge: enqueue/attach, claim, complete,
    retry-requeue, terminal fail, failed re-arm, done re-arm (eviction),
    permanent-failure quarantine + operator re-arm, an expired-lease
    steal with the loser's settle fenced, and a final drain. Helper
    replica handles are CLOSED in the finally (an injected crash kills
    the whole process — their in-process liveness must die with it)."""
    peer = DurableQueue(q.root, replica=f"peer-{os.path.basename(q.root)}",
                        lease_s=0.05)
    try:
        r1, _ = q.enqueue("p1", {"op": "t", "n": 1}, _unit(1), "t0",
                          "normal", "req-a", "o1.bin")
        r2, _ = q.enqueue("p2", {"op": "t", "n": 2}, _unit(2), "t0",
                          "normal", "req-a", "o2.bin")
        r3, _ = q.enqueue("p3", {"op": "t", "n": 3}, _unit(3), "t1",
                          "high", "req-b", "o3.bin")
        q.enqueue("p1", {"op": "t", "n": 1}, _unit(1), "t2", "normal",
                  "req-c", "o1.bin")                        # attach
        q.claim([r1.job_id, r2.job_id])                     # queued -> running
        q.complete(r1.job_id)                               # running -> done
        q.fail(r2.job_id, "boom", requeue=True)             # running -> queued
        q.claim([r2.job_id])
        q.fail(r2.job_id, "boom again", requeue=False)      # running -> failed
        q.enqueue("p2", {"op": "t", "n": 2}, _unit(2), "t0", "normal",
                  "req-d", "o2.bin")                        # failed -> queued
        q.rearm(r1.job_id)                                  # done -> queued
        # permanent-failure taxonomy: quarantine, then operator re-arm
        r4, _ = q.enqueue("p4", {"op": "t", "n": 4}, _unit(4), "t0",
                          "normal", "req-e", "o4.bin")
        q.claim([r4.job_id])
        q.quarantine(r4.job_id, "bad params")       # running -> quarantined
        q.rearm(r4.job_id)                          # quarantined -> queued
        # lease fencing: the peer claims r4, its lease expires (0.05 s,
        # no heartbeat), q steals it back, and the peer's settle is
        # REFUSED by the epoch fence
        peer.poll()
        assert peer.claim([r4.job_id]), "peer could not claim r4"
        time.sleep(0.12)                            # outlive the lease
        stolen = q.poll()["stolen"]                 # running -> queued (steal)
        assert stolen >= 1, "expired lease was not stolen"
        fenced = peer.complete(r4.job_id)
        assert fenced is None, "fenced settle was accepted"
        # poison-SRC quarantine: a QUEUED record carrying a poisoned
        # content digest is swept through the declared poison edge
        # (fault-injecting the registry write + the swept persist),
        # then the operator re-arm unparks it for the drain
        digest = "d" * 64
        r5, _ = q.enqueue("p5", {"op": "t", "n": 5}, _unit(5), "t0",
                          "normal", "req-f", "o5.bin", src_digest=digest)
        swept = q.poison_src(digest, src="SRC005",
                             error="hostile bytes",
                             by_job=r5.job_id)  # queued -> quarantined
        assert any(r.job_id == r5.job_id for r in swept), \
            "poison sweep missed the queued record carrying the digest"
        q.rearm_src(digest)                     # quarantined -> queued
        # drain whatever is queued now
        queued = [r.job_id for r in q.queued_snapshot()]
        for rec in q.claim(queued):
            q.complete(rec.job_id)
        # r3 may still be queued if the drain claimed it already —
        # complete anything left so the baseline run ends terminal
        for rec in q.claim([r3.job_id]):
            q.complete(rec.job_id)
    finally:
        peer.close()


def _seed_interrupted_root(root: str) -> None:
    """A root as a SIGKILLed daemon leaves it: one record persisted as
    'running' with its lease down — recovery must requeue it (the
    recovery-path atomic writes are fault-injected when DurableQueue
    opens this root). close() without settling is the faithful kill:
    the process's liveness dies, the on-disk record/lease stay."""
    q = DurableQueue(root)
    rec, _ = q.enqueue("pr", {"op": "t", "n": 9}, _unit(9), "t0", "normal",
                       "req-r", "o9.bin")
    q.claim([rec.job_id])
    q.close()


def _check_recovered(root: str, violations: list, where: str) -> None:
    q = DurableQueue(root)
    try:
        with q._lock:
            records = dict(q._jobs)
            queued_idx = set(q._queued)
        for job_id, rec in records.items():
            if rec.state not in STATES:
                violations.append(
                    f"{where}: {job_id} recovered into undeclared state "
                    f"{rec.state!r}")
            if rec.state == "running":
                # every owner in these roots is dead (closed), so a
                # running record after recovery is stranded — a LIVE
                # peer's lease is the only legitimate keeper
                violations.append(
                    f"{where}: {job_id} stranded in 'running' after "
                    "recovery")
            if os.path.isfile(q._sentinel_path(job_id)):
                violations.append(
                    f"{where}: {job_id} lease survived recovery")
            if (rec.state == "queued") != (job_id in queued_idx):
                violations.append(
                    f"{where}: {job_id} state {rec.state!r} disagrees "
                    "with the queued index")
        # the recovered queue must still drain to terminal states
        for _ in range(len(records) + 1):
            claimable = [r.job_id for r in q.queued_snapshot()]
            if not claimable:
                break
            for rec in q.claim(claimable):
                q.complete(rec.job_id)
        with q._lock:
            stuck = [
                (job_id, rec.state) for job_id, rec in q._jobs.items()
                if rec.state not in TERMINAL
            ]
        if stuck:
            violations.append(f"{where}: records stuck after drain: {stuck}")
        # settle forensics: a terminal record's settled epoch must be
        # the epoch the settling owner actually held — an accepted
        # stale-epoch settle (a fenced zombie slipping through) shows
        # up as a mismatch here
        with q._lock:
            for job_id, rec in q._jobs.items():
                if rec.state in TERMINAL and \
                        rec.settled_epoch is not None and \
                        rec.settled_epoch != rec.epoch:
                    violations.append(
                        f"{where}: {job_id} settled under epoch "
                        f"{rec.settled_epoch} but owns epoch {rec.epoch} "
                        "— a fenced settle was accepted")
    finally:
        q.close()


def run_crashcheck(workdir: Optional[str] = None,
                   verbose: bool = False) -> dict:
    """Execute the full fault matrix; returns the summary dict."""
    log = get_logger()
    own_tmp = workdir is None
    base = workdir or tempfile.mkdtemp(prefix="queue-crashcheck-")
    real_writer = queue_mod.atomic_write_json
    violations: list[str] = []
    fault_points = {"scenario": 0, "recovery": 0}
    try:
        # -------- pass 0: count boundaries (no faults) ------------------
        counter = _FaultyWriter(real_writer)
        queue_mod.atomic_write_json = counter
        root = os.path.join(base, "count")
        q0 = DurableQueue(root)
        try:
            _scenario(q0)
        finally:
            q0.close()
        fault_points["scenario"] = counter.count

        rec_root = os.path.join(base, "rcount")
        _seed_interrupted_root(rec_root)
        rec_counter = _FaultyWriter(real_writer)
        queue_mod.atomic_write_json = rec_counter
        DurableQueue(rec_root).close()  # recovery pass only
        fault_points["recovery"] = rec_counter.count

        # -------- pass 1: scenario faults -------------------------------
        cases = 0
        for k in range(1, fault_points["scenario"] + 1):
            for mode in ("before", "after"):
                cases += 1
                root = os.path.join(base, f"s{k:03d}{mode[0]}")
                queue_mod.atomic_write_json = _FaultyWriter(
                    real_writer, fault_at=k, mode=mode)
                died = False
                qf = None
                try:
                    # construction is INSIDE the fault scope: opening a
                    # queue performs durable writes of its own (the
                    # replica-epoch bump), and a death there must be as
                    # recoverable as one mid-scenario
                    qf = DurableQueue(root)
                    _scenario(qf)
                except _InjectedCrash:
                    died = True
                finally:
                    # the injected death killed the whole process: its
                    # in-process liveness dies with it, the disk stays
                    if qf is not None:
                        qf.close()
                queue_mod.atomic_write_json = real_writer
                if not died:
                    violations.append(
                        f"scenario#{k}/{mode}: fault point never reached")
                    continue
                _check_recovered(root, violations, f"scenario#{k}/{mode}")
                if verbose:
                    log.info("queue-crashcheck: scenario#%d/%s ok", k, mode)

        # -------- pass 2: recovery-path faults --------------------------
        for k in range(1, fault_points["recovery"] + 1):
            for mode in ("before", "after"):
                cases += 1
                root = os.path.join(base, f"r{k:03d}{mode[0]}")
                _seed_interrupted_root(root)
                queue_mod.atomic_write_json = _FaultyWriter(
                    real_writer, fault_at=k, mode=mode)
                try:
                    DurableQueue(root).close()
                except _InjectedCrash:
                    pass
                queue_mod.atomic_write_json = real_writer
                # the daemon died AGAIN during recovery; the next restart
                # must still land every record in a declared, drainable
                # state
                _check_recovered(root, violations, f"recovery#{k}/{mode}")
                if verbose:
                    log.info("queue-crashcheck: recovery#%d/%s ok", k, mode)
    finally:
        queue_mod.atomic_write_json = real_writer
        if own_tmp:
            shutil.rmtree(base, ignore_errors=True)
    return {
        "fault_points": fault_points,
        "cases": cases,
        "transitions_declared": len(TRANSITIONS),
        "violations": violations,
        "ok": not violations,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tools queue-crashcheck",
        description="fault-inject every serve-queue atomic-write boundary "
                    "and assert recovery reaches declared states only",
    )
    p.add_argument("--workdir", default=None,
                   help="keep fault roots here instead of a temp dir")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(list(argv) if argv is not None else None)
    summary = run_crashcheck(workdir=args.workdir, verbose=args.verbose)
    print(json.dumps(summary))
    if not summary["ok"]:
        for v in summary["violations"]:
            print(f"queue-crashcheck: VIOLATION: {v}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
