"""Hot/warm/cold placement over pluggable CAS backends (docs/STORE.md
"Tier hierarchy").

A `TieredStore` composes an ordered list of `Tier`s — index 0 is always
the store root's own `objects/` directory (the hot tier), colder tiers
follow. Reads fall through hot→warm→cold; the tier a read FOUND the
bytes in is the hit tier (`chain_store_tier_hits_total{tier=…}`), and a
non-hot hit is promoted read-through so the next reader pays local
latency. GC-pressure demotion moves the coldest objects the other way
when a tier outgrows its own byte budget (store/gc.py: demote before
evict; eviction only out of the last tier).

Placement moves are crash-safe by ordering: the bytes are streamed into
the destination backend (digest-verified at the boundary they cross,
committed atomic+durable) and only THEN deleted from the source — a
SIGKILL at any instant leaves either the untouched source, a tmp
scratch for GC, or a harmless both-tiers duplicate that the next move
pass completes. The heat ledger's move record is written after the
source delete, so a crashed move is never counted and a retried one
counts exactly once.

A bare store root is just a one-tier config: `TieredStore.single()`
wraps the classic layout with no budgets and no colder tiers, and every
code path degrades to the original flat-store behavior.

The port's copy of processing_chain_tpu/store/tiers.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Optional

from .. import telemetry as tm
from ..utils import lockdebug
from .backends import (
    BackendIntegrityError,
    LocalBackend,
    StoreBackend,
    crashpoint,
    make_backend,
)

TIER_HITS = tm.counter(
    "chain_store_tier_hits_total",
    "artifact reads by the tier the bytes were found in", ("tier",),
)
TIER_PROMOTIONS = tm.counter(
    "chain_store_tier_promotions_total",
    "objects promoted toward hot, labeled by the tier they LEFT",
    ("tier",),
)
TIER_DEMOTIONS = tm.counter(
    "chain_store_tier_demotions_total",
    "objects demoted toward cold, labeled by the tier they ENTERED",
    ("tier",),
)
TIER_BYTES = tm.gauge(
    "chain_store_tier_bytes", "bytes held per store tier", ("tier",)
)

#: spec-entry budgets: plain bytes or K/M/G/T suffixed
_BUDGET_RE = re.compile(r"^(\d+(?:\.\d+)?)([kKmMgGtT]?)$")


class TierSpecError(ValueError):
    """A malformed `--store-tiers` / PC_STORE_TIERS spec."""


def parse_budget(text: str) -> int:
    m = _BUDGET_RE.match(text.strip())
    if not m:
        raise TierSpecError(f"unparseable byte budget {text!r} "
                            "(expected e.g. 500M, 2G, 1048576)")
    scale = {"": 1, "k": 1 << 10, "m": 1 << 20,
             "g": 1 << 30, "t": 1 << 40}[m.group(2).lower()]
    return int(float(m.group(1)) * scale)


@dataclass
class Tier:
    """One rung of the hierarchy: a name forensics can print, a backend
    holding the bytes, and an optional byte budget that triggers
    demotion (NOT eviction) when outgrown."""

    name: str
    backend: StoreBackend
    budget_bytes: Optional[int] = None

    def bytes_held(self) -> int:
        return sum(size for _, size in self.backend.list())


def parse_tier_spec(spec: str) -> tuple[Optional[int], list]:
    """Parse a `--store-tiers` spec into (hot_budget, extra tiers).

    Grammar: comma/semicolon-separated entries —

        hot[@BUDGET]                   budget for the implicit hot tier
        shared=PATH[@BUDGET]           a warm tier (shared local-FS root)
        local=PATH[@BUDGET]            a warm tier (plain local root)
        object=PATH[@BUDGET]           an S3-shaped cold tier (the
                                       directory-backed reference client)

    e.g. `hot@64M,shared=/mnt/warm@2G,object=/mnt/cold`. Tier names are
    assigned by kind: shared/local entries are warm, object entries are
    cold (duplicates numbered warm2, cold2, …).
    """
    hot_budget: Optional[int] = None
    tiers: list[Tier] = []
    used_names: set[str] = set()
    for raw in re.split(r"[;,]", spec):
        entry = raw.strip()
        if not entry:
            continue
        budget: Optional[int] = None
        if "@" in entry:
            entry, _, budget_text = entry.rpartition("@")
            budget = parse_budget(budget_text)
        if entry == "hot":
            hot_budget = budget
            continue
        if "=" not in entry:
            raise TierSpecError(
                f"unparseable tier entry {raw!r} (expected "
                "hot[@BUDGET] or kind=path[@BUDGET])")
        kind, _, path = entry.partition("=")
        kind = kind.strip()
        if not path:
            raise TierSpecError(f"tier entry {raw!r} names no path")
        base = "cold" if kind == "object" else "warm"
        name = base
        n = 2
        while name in used_names:
            name = f"{base}{n}"
            n += 1
        used_names.add(name)
        tiers.append(Tier(name=name, backend=make_backend(kind, path),
                          budget_bytes=budget))
    # warm tiers sort before cold regardless of spec order — falling
    # through hot→warm→cold is the contract, not an accident of the
    # command line
    tiers.sort(key=lambda t: t.backend.kind == "object")
    return hot_budget, tiers


class TieredStore:
    """The ordered tier list plus the placement moves between rungs."""

    def __init__(self, tiers: list, promote_on_read: bool = True) -> None:
        if not tiers:
            raise ValueError("a TieredStore needs at least the hot tier")
        self.tiers: list[Tier] = list(tiers)
        self.promote_on_read = promote_on_read
        # guarded-by: _move_lock — cross-tier moves of distinct objects
        # are independent, but two concurrent moves of ONE object could
        # interleave a delete under a copy; one lock is cheap because
        # moves are rare (reads dominate by orders of magnitude)
        self._move_lock = lockdebug.make_lock("store_tiers")

    @classmethod
    def single(cls, objects_dir: str, tmp_dir: str) -> "TieredStore":
        """A bare store root as a one-tier config — zero migration."""
        return cls([Tier("hot", LocalBackend(objects_dir, tmp_dir))])

    @classmethod
    def from_spec(cls, spec: str, objects_dir: str,
                  tmp_dir: str) -> "TieredStore":
        hot_budget, extra = parse_tier_spec(spec)
        hot = Tier("hot", LocalBackend(objects_dir, tmp_dir),
                   budget_bytes=hot_budget)
        return cls([hot, *extra])

    # ------------------------------------------------------------- lookup

    @property
    def hot(self) -> Tier:
        return self.tiers[0]

    @property
    def multi(self) -> bool:
        return len(self.tiers) > 1

    def tier(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no store tier named {name!r}")

    def locate(self, sha256: str) -> Optional[Tier]:
        """The hottest tier holding the object (reads fall through in
        this order; a mid-move duplicate resolves to the hotter copy)."""
        for t in self.tiers:
            if t.backend.head(sha256) is not None:
                return t
        return None

    def head(self, sha256: str) -> Optional[tuple]:
        for t in self.tiers:
            size = t.backend.head(sha256)
            if size is not None:
                return t, size
        return None

    def iter_objects(self) -> Iterator[tuple[str, int, str]]:
        """(sha256, size, tier name) for every object, deduped to the
        hottest copy — the accounting view GC and stats consume."""
        seen: set[str] = set()
        for t in self.tiers:
            for sha, size in t.backend.list():
                if sha in seen:
                    continue
                seen.add(sha)
                yield sha, size, t.name

    def tier_stats(self) -> dict:
        """Per-tier {objects, bytes, budget_bytes} (no dedup: a mid-move
        duplicate is real disk in both tiers)."""
        out: dict[str, dict] = {}
        for t in self.tiers:
            n = 0
            total = 0
            for _, size in t.backend.list():
                n += 1
                total += size
            out[t.name] = {"objects": n, "bytes": total,
                           "budget_bytes": t.budget_bytes}
        return out

    def update_gauges(self) -> None:
        if not tm.enabled():
            return
        for name, s in self.tier_stats().items():
            TIER_BYTES.labels(tier=name).set(s["bytes"])

    # -------------------------------------------------------------- moves

    def promote(self, sha256: str, plan: Optional[str] = None,
                heat=None) -> Optional[dict]:
        """Move an object to the hot tier (read-through promotion).
        Returns the move evidence dict, or None when already hot."""
        src = self.locate(sha256)
        if src is None:
            raise FileNotFoundError(f"object {sha256[:12]} in no tier")
        if src is self.hot:
            return None
        return self._move(sha256, src, self.hot, op="promote",
                          plan=plan, heat=heat)

    def demote(self, sha256: str, src: Tier, dst: Tier,
               plan: Optional[str] = None, heat=None) -> dict:
        return self._move(sha256, src, dst, op="demote",
                          plan=plan, heat=heat)

    def _move(self, sha256: str, src: Tier, dst: Tier, op: str,
              plan: Optional[str] = None, heat=None) -> dict:
        """Copy-verify-commit-then-delete. The source copy survives
        until the destination commit is durable; the heat record lands
        only after the delete, so crashed moves never double-count."""
        with self._move_lock:  # holds-lock: store_tiers
            nbytes = dst.backend.head(sha256)
            if nbytes is None:
                with src.backend.open_read(sha256) as f:
                    try:
                        nbytes = dst.backend.put_stream(f, sha256)
                    except BackendIntegrityError:
                        # the SOURCE copy is corrupt: surface it as the
                        # store-corruption class the read path already
                        # converts to a rebuild — never delete the only
                        # (even corrupt) copy here
                        raise
            crashpoint("pre_delete")
            src.backend.delete(sha256)
        evidence = {"object": sha256, "op": op, "from_tier": src.name,
                    "to_tier": dst.name, "bytes": int(nbytes)}
        if plan is not None:
            evidence["plan"] = plan
        if op == "promote":
            TIER_PROMOTIONS.labels(tier=src.name).inc()
            tm.emit("store_promote", **evidence)
        else:
            TIER_DEMOTIONS.labels(tier=dst.name).inc()
            tm.emit("store_demote", **evidence)
        if heat is not None:
            heat.record_move(evidence)
        return evidence

    def delete_everywhere(self, sha256: str) -> bool:
        """Unlink the object from every tier holding it (corruption
        drops and final eviction)."""
        removed = False
        for t in self.tiers:
            removed = t.backend.delete(sha256) or removed
        return removed
