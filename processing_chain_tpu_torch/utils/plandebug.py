"""Runtime plan-purity recorder (copy of
processing_chain_tpu/utils/plandebug.py: the dynamic half of chainlint's
``plan-purity`` rule).

The static checker (tools/chainlint/planpurity.py) proves hidden inputs
cannot *reach* artifact bytes without being declared; this recorder
proves the declarations are *true*. With ``PC_PLAN_DEBUG=1`` (the test
suite turns it on in tests/conftest.py, exactly like ``PC_LOCK_DEBUG``)
every store commit records its ``plan hash → artifact content digest``
pair plus a snapshot of the ``PC_*`` and process-topology environment;
``check()`` raises if any plan hash was ever bound to two different byte
streams. The suite's ``pytest_sessionfinish`` gate calls only the JAX
package's ``check()``; this recorder's is called by
tests/test_torch_plandebug.py, over its unit cases and a round of the
port's serve path. When it fires, the violation names
the env keys that differed between the two commits, which is usually
the hidden input itself: a knob annotated ``# plan-exempt`` that turned
out to change bytes shows up here as same-plan/different-bytes with
that knob in the diff.

Zero production overhead by the lockdebug contract: ``record()`` is a
single ``enabled()`` check when the recorder is off, and it is only
called at store-commit cadence (once per built artifact), never per
frame.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


def enabled() -> bool:
    return os.environ.get("PC_PLAN_DEBUG", "").strip().lower() in (
        "1", "on", "true", "yes",
    )


_lock = threading.Lock()
#: (store scope, plan hash) -> (artifact sha256, env snapshot, producer)
_commits: dict[tuple, tuple] = {}
#: (plan_hash, first_digest, second_digest, differing env keys, producers)
_violations: list[tuple] = []


#: the torch process-topology variables store/plan_schema.py declares
_TOPOLOGY = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def _env_snapshot() -> dict:
    """The chain's knob surface: every PC_* variable plus the process
    topology store/plan_schema.py declares exempt — the recorder is the
    thing that guards those claims, so a violation's forensic diff must
    be able to NAME them."""
    return {
        k: v for k, v in os.environ.items()
        if k.startswith("PC_") or k in _TOPOLOGY
    }


def record(plan_hash: str, artifact_sha256: str,
           producer: str = "", scope: str = "") -> None:
    """Bind one commit's plan hash to its artifact digest. A re-commit
    of the same plan with identical bytes is the normal deterministic
    case (rebuilds, corruption repair, adoption) and records nothing
    new; different bytes under one plan hash is the cache-poisoning bug
    this recorder exists to catch. `scope` is the store root: two
    DIFFERENT stores binding one hash to different bytes are separate
    caches (the suite spins up a fresh store per test, often with
    hardcoded synthetic hashes), not poisoning — the invariant is
    per-cache."""
    if not enabled():
        return
    snap = _env_snapshot()
    key = (scope, plan_hash)
    with _lock:
        prior = _commits.get(key)
        if prior is None:
            _commits[key] = (artifact_sha256, snap, producer)
            return
        prior_digest, prior_snap, prior_producer = prior
        if prior_digest == artifact_sha256:
            return
        keys = sorted(
            k for k in set(prior_snap) | set(snap)
            if prior_snap.get(k) != snap.get(k)
        )
        _violations.append((
            plan_hash, prior_digest, artifact_sha256, tuple(keys),
            (prior_producer, producer),
        ))


def reset() -> None:
    with _lock:
        _commits.clear()
        del _violations[:]


def snapshot_state() -> tuple:
    """(commits, violations) copies — for tests that must exercise the
    recorder in isolation and then RESTORE the suite-wide recording
    (a bare reset() mid-suite would blind a later check() to
    everything recorded before it)."""
    with _lock:
        return dict(_commits), list(_violations)


def restore_state(state: tuple) -> None:
    commits, violations = state
    with _lock:
        _commits.clear()
        _commits.update(commits)
        _violations[:] = violations


class PlanPurityViolation(AssertionError):
    """Raised by check(): one plan hash produced two byte streams."""


def check() -> dict:
    """Assert no plan hash was ever bound to two different byte streams;
    returns {'plans': n, 'violations': 0} for logging/assertions."""
    with _lock:
        violations = list(_violations)
        n = len(_commits)
    if violations:
        details = []
        for plan_hash, d1, d2, keys, producers in violations[:8]:
            env_part = (
                f"; PC_*/topology env keys that differed: {', '.join(keys)}"
                if keys else "; no PC_*/topology env key differed (non-env "
                             "hidden input or nondeterministic encoder)"
            )
            details.append(
                f"plan {plan_hash[:16]}… produced bytes {d1[:12]}… and "
                f"{d2[:12]}… (producers: {producers[0] or '?'} / "
                f"{producers[1] or '?'}){env_part}"
            )
        raise PlanPurityViolation(
            "plan-purity violation recorded under PC_PLAN_DEBUG — one "
            "plan hash, two byte streams (a hidden input escaped the "
            "plan):\n  " + "\n  ".join(details)
        )
    return {"plans": n, "violations": 0}


def dump(path: str) -> Optional[str]:
    """Persist the observed plan→digest map (forensics)."""
    from .fsio import atomic_write_json

    with _lock:
        doc = {
            "plans": {
                f"{scope}::{h}" if scope else h:
                    {"sha256": d, "producer": p}
                for (scope, h), (d, _snap, p) in sorted(_commits.items())
            },
            "violations": [
                {"plan": h, "first": d1, "second": d2,
                 "env_keys": list(keys), "producers": list(prods)}
                for h, d1, d2, keys, prods in _violations
            ],
        }
    atomic_write_json(path, doc)
    return path
