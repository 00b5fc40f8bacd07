"""Mark-and-sweep garbage collection for the artifact store.

Roots (mark phase): every readable manifest, because a manifest IS the
liveness record of a cached plan — plus the pins file, which exempts its
manifests from LRU eviction entirely. Ref-counting is implicit: an object
is live while any surviving manifest (artifact or sidecar) names its
digest.

Sweep phases, in order:
  1. stale tmp/ entries older than `tmp_max_age_s` (crashed writers) —
     swept in EVERY tier's scratch dir, not just the hot root's;
  2. orphan objects no manifest references (older than `min_object_age_s`,
     so an in-flight commit's just-renamed object is never raced) —
     swept per tier, with the tier named in the evidence;
  3. demotion to per-tier budgets (docs/STORE.md "Tier hierarchy"):
     every tier except the last that has outgrown its OWN byte budget
     demotes its coldest objects one rung down — coldest by the heat
     ledger's recorded reads, then by LRU manifest stamp, pinned plans
     last. Demotion moves bytes, it never destroys them: this is the
     "demote before evict" half of the placement policy;
  4. LRU eviction of unpinned manifests, oldest last-used first, until
     referenced bytes fit `size_budget_bytes` (the TOTAL budget, across
     all tiers) — each eviction re-runs the implicit ref-count so
     objects shared with a surviving manifest stay. Because demotion
     ran first, eviction is in practice eviction out of the LAST tier;
     the evidence names the tier each victim's bytes actually left.

Every eviction counts `chain_store_evictions_total`; a `dry_run` pass
reports what would happen without touching disk.

The port's copy of processing_chain_tpu/store/gc.py.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .. import telemetry as tm
from ..utils.log import get_logger
from .backends import BackendIntegrityError
from .store import STORE_EVICTIONS, ArtifactStore, Manifest


def _manifest_digests(manifest: Manifest) -> set[str]:
    return {d["sha256"] for d in manifest.all_digests()}


def collect(
    store: ArtifactStore,
    size_budget_bytes: Optional[int] = None,
    dry_run: bool = False,
    tmp_max_age_s: float = 3600.0,
    min_object_age_s: float = 3600.0,
    now: Optional[float] = None,
    extra_pins: Optional[set] = None,
    heat=None,
) -> dict:
    """Run one mark-and-sweep pass; returns the summary dict that
    `tools store-admin gc` renders and serve's pressure hook consumes.

    `extra_pins` are EPHEMERAL pins: plan hashes exempt from LRU
    eviction for this pass only, without touching pins.json — the serve
    daemon passes the plans referenced by unfinished requests so the
    cache can never evict an artifact a queued request is about to
    claim. Summary keys beyond the per-phase detail: `bytes_freed`
    (orphans + evictions), `objects_evicted` (object files actually
    unlinked), `pins_honored` (manifests the LRU pass skipped because
    durable or ephemeral pins protect them).

    `heat` (a store.heat.HeatLedger) turns on eviction forensics: every
    victim's evidence dict — the same one `report["victims"]` carries,
    the `store_evict` event ships, and `tools store-admin gc` prints — is
    journaled so a later read/rebuild of the plan can be recognized as
    eviction regret (docs/STORE.md "Access heat & eviction
    forensics")."""
    log = get_logger()
    now = time.time() if now is None else now
    report = {
        "dry_run": dry_run,
        "tmp_removed": 0,
        "orphans_removed": 0,
        "orphan_bytes": 0,
        "evicted_manifests": [],
        #: per-victim evidence dicts (LRU victims AND orphans), the
        #: forensics record: reason, last-used age, recorded reads,
        #: freed bytes, and the budget that triggered the pass
        "victims": [],
        #: per-move evidence dicts from the per-tier-budget demotion
        #: phase (same shape the `store_demote` event ships)
        "demotions": [],
        "demoted_bytes": 0,
        "evicted_bytes": 0,
        "kept_manifests": 0,
        "kept_bytes": 0,
        "bytes_freed": 0,
        "objects_evicted": 0,
        "pins_honored": 0,
    }

    # phase 1: crashed-writer leftovers in EVERY tier's scratch dir —
    # the hot root's tmp/ plus whatever scratch each colder backend
    # stages its commits in
    tmp_dirs: list[str] = []
    for t in store.tiers.tiers:
        for d in t.backend.tmp_dirs():
            if d not in tmp_dirs:
                tmp_dirs.append(d)
    for tmp_dir in tmp_dirs:
        try:
            for name in os.listdir(tmp_dir):
                path = os.path.join(tmp_dir, name)
                try:
                    if now - os.stat(path).st_mtime < tmp_max_age_s:
                        continue
                    if not dry_run:
                        os.unlink(path)
                    report["tmp_removed"] += 1
                except OSError:
                    continue
        except OSError:
            continue

    # mark: manifests (with their LRU stamp) and the digests they hold live
    pins = set(store.pins()) | set(extra_pins or ())
    manifests: list[tuple[float, Manifest]] = []
    for m in store.iter_manifests():
        try:
            mtime = os.stat(store.manifest_path(m.plan_hash)).st_mtime
        except OSError:
            mtime = 0.0
        manifests.append((mtime, m))
    live: set[str] = set()
    for _, m in manifests:
        live.update(_manifest_digests(m))

    # phase 2: orphan objects, swept per tier so a crashed move's
    # leftover copy is collected wherever it sits. The accounting view
    # (`sizes`, and which tier a live object's bytes count against) is
    # the hottest copy, matching store.iter_objects().
    sizes: dict[str, int] = {}
    object_tier: dict[str, str] = {}
    for sha, size, tname in store.tiers.iter_objects():
        sizes[sha] = size
        object_tier[sha] = tname
    for t in store.tiers.tiers:
        for sha, size in t.backend.list():
            if sha in live:
                continue
            path = t.backend.local_path(sha)
            try:
                if path is not None:
                    age_s = now - os.stat(path).st_mtime
                else:
                    # no stat surface (object tier). Cold tiers only
                    # ever receive MOVES of manifest-referenced objects
                    # — never fresh ingests racing their manifest write
                    # — so the min-age guard has nothing to protect
                    age_s = float("inf")
                if age_s < min_object_age_s:
                    continue
                if not dry_run:
                    if not t.backend.delete(sha):
                        continue
                report["orphans_removed"] += 1
                report["orphan_bytes"] += size
                evidence = {
                    "object": sha,
                    "reason": "orphan",
                    "tier": t.name,
                    "age_s": round(min(max(0.0, age_s), 1e12), 3),
                    "freed_bytes": size,
                }
                report["victims"].append(evidence)
                if heat is not None and not dry_run:
                    heat.record_eviction(evidence)
            except OSError:
                continue

    # the heat ledger's recorded reads, fetched ONCE per pass (it
    # merges every replica's journal) — ranks demotion candidates and
    # fills the "what did this plan's history look like" half of the
    # eviction evidence
    recorded_reads = heat.read_counts() if heat is not None else {}

    # phase 3: demotion to per-tier budgets — demote before evict.
    # Coldness ranking: unpinned before pinned, fewest recorded reads
    # first, then oldest newest-owning-manifest LRU stamp first.
    if store.tiers.multi:
        owners: dict[str, tuple[float, str]] = {}
        for mtime, m in manifests:
            for sha in _manifest_digests(m):
                prev = owners.get(sha)
                if prev is None or mtime > prev[0]:
                    owners[sha] = (mtime, m.plan_hash)
        tier_list = store.tiers.tiers
        for i, tier in enumerate(tier_list[:-1]):
            if tier.budget_bytes is None:
                continue
            held = list(tier.backend.list())
            total = sum(size for _, size in held)
            if total <= tier.budget_bytes:
                continue
            dst = tier_list[i + 1]

            def coldness(entry: tuple[str, int]) -> tuple:
                mtime, plan = owners.get(entry[0], (0.0, None))
                reads = recorded_reads.get(plan, 0) if plan else 0
                return (plan in pins, reads, mtime)

            held.sort(key=coldness)
            for sha, size in held:
                if total <= tier.budget_bytes:
                    break
                if sha not in live:
                    continue  # orphan copies are phase 2's job
                mtime, plan = owners.get(sha, (0.0, None))
                if dry_run:
                    evidence = {"object": sha, "op": "demote",
                                "from_tier": tier.name,
                                "to_tier": dst.name, "bytes": size}
                    if plan is not None:
                        evidence["plan"] = plan
                else:
                    try:
                        evidence = store.tiers.demote(
                            sha, tier, dst, plan=plan, heat=heat)
                    except (OSError, BackendIntegrityError) as exc:
                        log.warning(
                            "store gc: demoting %s %s→%s failed: %s",
                            sha[:12], tier.name, dst.name, exc)
                        continue
                evidence["reads"] = (
                    recorded_reads.get(plan, 0) if plan else 0)
                evidence["last_used_age_s"] = round(
                    max(0.0, now - mtime), 3)
                total -= size
                report["demotions"].append(evidence)
                report["demoted_bytes"] += size

    # phase 4: LRU eviction to the size budget (pinned manifests exempt)
    def referenced_bytes(ms: list[tuple[float, Manifest]]) -> int:
        refs: set[str] = set()
        for _, m in ms:
            refs.update(_manifest_digests(m))
        return sum(sizes.get(sha, 0) for sha in refs)

    if size_budget_bytes is not None:
        manifests.sort(key=lambda e: e[0])  # oldest last-used first
        report["pins_honored"] = sum(
            1 for _, m in manifests if m.plan_hash in pins
        )
        while manifests and referenced_bytes(manifests) > size_budget_bytes:
            victim_i = next(
                (i for i, (_, m) in enumerate(manifests)
                 if m.plan_hash not in pins),
                None,
            )
            if victim_i is None:
                log.warning(
                    "store gc: size budget %d unreachable — every remaining "
                    "manifest is pinned", size_budget_bytes,
                )
                break
            victim_mtime, victim = manifests.pop(victim_i)
            survivors: set[str] = set()
            for _, m in manifests:
                survivors.update(_manifest_digests(m))
            doomed = _manifest_digests(victim) - survivors
            freed = sum(sizes.get(sha, 0) for sha in doomed)
            # the tier the victim's bytes actually left: the one
            # holding the most doomed bytes (after demotion ran, that
            # is in practice the LAST tier)
            tier_bytes: dict[str, int] = {}
            for sha in doomed:
                tname = object_tier.get(sha)
                if tname is not None:
                    tier_bytes[tname] = (
                        tier_bytes.get(tname, 0) + sizes.get(sha, 0))
            left_tier = (
                max(tier_bytes, key=tier_bytes.get) if tier_bytes
                else store.tiers.tiers[-1].name)
            evidence = {
                "plan": victim.plan_hash,
                "producer": victim.producer,
                "reason": "over_budget",
                "tier": left_tier,
                "last_used_age_s": round(max(0.0, now - victim_mtime), 3),
                "reads": recorded_reads.get(victim.plan_hash, 0),
                "freed_bytes": freed,
                "objects": len(doomed),
                "budget_bytes": size_budget_bytes,
            }
            if not dry_run:
                store._drop_manifest(victim.plan_hash)
                for sha in doomed:
                    store.tiers.delete_everywhere(sha)
                STORE_EVICTIONS.inc()
                # the event carries the full evidence, not aggregates:
                # the operator render, the forensics journal, and this
                # event stay in agreement because all three ship the
                # same dict
                tm.emit("store_evict", **evidence)
                if heat is not None:
                    heat.record_eviction(evidence)
            report["evicted_manifests"].append(victim.plan_hash)
            report["victims"].append(evidence)
            report["evicted_bytes"] += freed
            report["objects_evicted"] += len(doomed)

    report["kept_manifests"] = len(manifests)
    report["kept_bytes"] = referenced_bytes(manifests)
    report["objects_evicted"] += report["orphans_removed"]
    report["bytes_freed"] = report["orphan_bytes"] + report["evicted_bytes"]
    if not dry_run:
        store.update_gauges(full=True)
    return report


def enforce_budget(
    store: ArtifactStore,
    size_budget_bytes: Optional[int],
    extra_pins: Optional[set] = None,
    dry_run: bool = False,
    heat=None,
) -> dict:
    """The LRU size-budget path as a programmatic API: one collect()
    pass tuned for a LONG-RUNNING caller (serve's pressure hook) — tmp
    and orphan sweeps keep their crash-safety ages, eviction honors both
    durable pins and the caller's ephemeral `extra_pins`. Returns the
    same summary dict as collect(); `tools store-admin gc` and the serve
    pressure hook therefore share one implementation and one report
    vocabulary (bytes_freed / objects_evicted / pins_honored)."""
    return collect(
        store,
        size_budget_bytes=size_budget_bytes,
        dry_run=dry_run,
        extra_pins=extra_pins,
        heat=heat,
    )
