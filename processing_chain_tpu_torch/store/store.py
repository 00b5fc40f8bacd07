"""CAS object directory with atomic commits and integrity-verified reads
(copy of processing_chain_tpu/store/store.py). Every commit feeds the
PC_PLAN_DEBUG plan-purity recorder (utils/plandebug); media objects get
the container read-back probe through the port's media boundary.

On-disk layout under the store root (docs/STORE.md):

    objects/<digest[:2]>/<digest>     content-addressed artifact bytes
    manifests/<plan_hash>.json        one manifest per cached plan
    tmp/                              in-flight commits (pid-unique names)
    pins.json                         {plan_hash: label} GC roots
    seen-paths.jsonl                  every output path ever bound (the
                                      adoption ledger: survives manifest
                                      eviction/corruption drops)
    digest-cache.json                 stat-keyed input digest cache

Commit protocol: artifact bytes are hardlinked (copied across devices)
into tmp/ first, fsync'd, then os.replace'd into objects/ — a writer
crashed at any instant leaves at worst a tmp/ orphan that GC sweeps,
never a half-object under a valid digest. The manifest is written last
(atomic_write), so a plan hash resolves only to fully-committed bytes.

Read protocol (`serve_hit`): the manifest's object is spot-checked
(size + head digest; full digest for small objects or deep verifies),
then materialized to the legacy output path by hardlink when possible.
A mismatch anywhere counts `chain_store_corrupt_total`, drops the
manifest, and the caller rebuilds — corruption converts to a cache miss,
never to a served artifact. Media objects additionally get a container
read-back probe (open + decode one frame) at commit, which rejects the
write-time corruption class the round-5 advisor reproduced (10-bit
rawvideo muxed into AVI reads back as garbage) before it can be cached.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from .. import telemetry as tm
from ..utils.fsio import atomic_write
from ..utils.log import get_logger
from . import keys
from .backends import BackendIntegrityError
from .backends.local import _link_or_copy
from .tiers import TieredStore
from ..utils import lockdebug, plandebug

STORE_HITS = tm.counter(
    "chain_store_hits_total", "jobs served from the artifact store", ("runner",)
)
STORE_MISSES = tm.counter(
    "chain_store_misses_total", "plan hashes with no committed artifact",
    ("runner",),
)
STORE_EVICTIONS = tm.counter(
    "chain_store_evictions_total", "manifests evicted by GC (LRU or orphan)"
)
STORE_CORRUPT = tm.counter(
    "chain_store_corrupt_total",
    "integrity failures detected on read (digest or container probe)",
)
STORE_ADOPTIONS = tm.counter(
    "chain_store_adoptions_total",
    "pre-store artifacts adopted on first sight (legacy skip-existing parity)",
)
STORE_BYTES = tm.gauge(
    "chain_store_object_bytes", "bytes held in the store's object directory"
)
STORE_OBJECTS = tm.gauge(
    "chain_store_objects", "objects held in the store's object directory"
)

#: full-digest verification threshold for ordinary (non-deep) reads
_FULL_VERIFY_MAX = 64 << 20

#: containers worth a read-back probe (everything the chain muxes)
_MEDIA_EXTS = {".avi", ".mp4", ".mkv", ".webm", ".mov"}


class StoreCorruption(RuntimeError):
    """An artifact failed integrity verification (digest mismatch or a
    container that does not read back)."""


@dataclass
class Manifest:
    """One cached plan → artifact binding (manifests/<plan_hash>.json)."""

    plan_hash: str
    object: dict  # {"sha256", "head_sha256", "size"}
    producer: str = ""
    created_at: float = 0.0
    chain_version: str = ""
    provenance: dict = field(default_factory=dict)
    media: Optional[dict] = None  # commit-time read-back probe summary
    sidecars: dict = field(default_factory=dict)  # suffix -> object digest dict
    #: path RELATIVE to the output's directory -> digest (relative so a
    #: relocated database still materializes companions next to the new
    #: dest instead of resurrecting the old tree)
    extras: dict = field(default_factory=dict)
    materialized: Optional[dict] = None  # {"path", "size", "mtime_ns"}

    def to_json(self) -> dict:
        return {
            "planHash": self.plan_hash,
            "object": self.object,
            "producer": self.producer,
            "createdAt": self.created_at,
            "chainVersion": self.chain_version,
            "provenance": self.provenance,
            "media": self.media,
            "sidecars": self.sidecars,
            "extras": self.extras,
            "materialized": self.materialized,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Manifest":
        return cls(
            plan_hash=data["planHash"],
            object=data["object"],
            producer=data.get("producer", ""),
            created_at=float(data.get("createdAt", 0.0)),
            chain_version=data.get("chainVersion", ""),
            provenance=data.get("provenance", {}),
            media=data.get("media"),
            sidecars=data.get("sidecars", {}),
            extras=data.get("extras", {}),
            materialized=data.get("materialized"),
        )

    def all_digests(self) -> list[dict]:
        """Main object + sidecars + extras, for verification and GC."""
        return [self.object, *self.sidecars.values(), *self.extras.values()]


def _probe_readback(path: str) -> Optional[dict]:
    """Open a media container and decode one frame; a summary dict on
    success, None for non-media files or when the native media boundary
    is unavailable in this environment, StoreCorruption when the file
    does not read back."""
    if os.path.splitext(path)[1].lower() not in _MEDIA_EXTS:
        return None
    try:
        from ..io import medialib
        medialib.ensure_loaded()
    except Exception:
        return None  # no decoder on this host: digest checks still apply
    from ..io.medialib import MediaError
    from ..io.video import VideoReader

    try:
        streams = medialib.probe(path).get("streams", [])
        with VideoReader(path) as reader:
            decoded = 0
            for _ in reader:
                decoded += 1
                break
            if decoded == 0:
                raise MediaError("no frames decodable")
            return {
                "pix_fmt": reader.pix_fmt,
                "width": reader.width,
                "height": reader.height,
                "fps": round(reader.fps, 6),
                "streams": len(streams),
            }
    except MediaError as exc:
        raise StoreCorruption(f"{path}: container read-back failed: {exc}") from exc


class ArtifactStore:
    """Content-addressed store rooted at one directory. Thread-compatible
    with the chain's job pools: commits are tmp+rename (last writer of an
    identical object wins, harmlessly), manifests are whole-file atomic
    writes, and the digest cache and adoption ledger carry their own
    locks (commit-time hash re-resolution runs on JobRunner workers)."""

    def __init__(self, root: str, tier_spec: Optional[str] = None) -> None:
        self.root = os.path.abspath(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.manifests_dir = os.path.join(self.root, "manifests")
        self.tmp_dir = os.path.join(self.root, "tmp")
        for d in (self.objects_dir, self.manifests_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)
        # the tier hierarchy (docs/STORE.md "Tier hierarchy"): index 0 is
        # ALWAYS this root's own objects/ directory, so a bare root is
        # just a one-tier config and opens with zero migration
        if tier_spec:
            self.tiers = TieredStore.from_spec(
                tier_spec, self.objects_dir, self.tmp_dir)
        else:
            self.tiers = TieredStore.single(self.objects_dir, self.tmp_dir)
        self.digests = keys.DigestCache(os.path.join(self.root, "digest-cache.json"))
        self._pins_path = os.path.join(self.root, "pins.json")
        #: lazily-built set of output paths the store has ever bound
        #: (manifests ∪ the durable seen-paths ledger) — the
        #: adopt-vs-rebuild discriminator (see should_adopt)
        self._known_paths: Optional[set[str]] = None
        self._paths_path = os.path.join(self.root, "seen-paths.jsonl")
        self._paths_lock = lockdebug.make_lock("store_paths")
        self._seen_paths: Optional[set[str]] = None  # lazy ledger cache
        #: incrementally-maintained gauge state ({"objects", "bytes"});
        #: None until the first update_gauges walk
        self._gauge_stats: Optional[dict] = None

    # ------------------------------------------------------------- hashing

    def plan_hash(self, payload: dict) -> str:
        """Resolve a payload's file_refs through this store's digest cache
        and hash it. Raises OSError when an input file is missing."""
        return keys.plan_hash(payload, digest=self.digests.digest)

    # -------------------------------------------------------------- layout

    def object_path(self, sha256: str) -> str:
        return os.path.join(self.objects_dir, sha256[:2], sha256)

    def manifest_path(self, plan_hash: str) -> str:
        return os.path.join(self.manifests_dir, plan_hash + ".json")

    # ------------------------------------------------------------ manifests

    def lookup(self, plan_hash: str) -> Optional[Manifest]:
        path = self.manifest_path(plan_hash)
        try:
            with open(path) as f:
                return Manifest.from_json(json.load(f))
        except FileNotFoundError:
            return None
        except OSError as exc:
            # transient environment error (EMFILE/EIO/EACCES), not data
            # corruption: degrade to a miss but leave the manifest alone —
            # deleting a healthy cache entry over a busy file table would
            # force a spurious rebuild and misreport corruption
            get_logger().warning("store: cannot read manifest %s (%s); "
                                 "treating as a miss", path, exc)
            return None
        except (ValueError, KeyError) as exc:
            # an unparseable manifest is corruption reported as a miss;
            # the rebuild's commit overwrites it atomically. Deleting it
            # HERE would make read-only surfaces (ls, verify without
            # --drop, gc --dry-run — all funnel through lookup) mutate
            # the store as a side effect.
            get_logger().warning(
                "store: unreadable manifest %s (%s); treating as a miss "
                "(`tools store-admin verify --drop` removes it)", path, exc,
            )
            STORE_CORRUPT.inc()
            return None

    def iter_manifests(self) -> Iterator[Manifest]:
        try:
            names = sorted(os.listdir(self.manifests_dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            m = self.lookup(name[:-5])
            if m is not None:
                yield m

    def _write_manifest(self, manifest: Manifest) -> None:
        def _write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(manifest.to_json(), f, indent=1, sort_keys=True)

        atomic_write(self.manifest_path(manifest.plan_hash), _write)

    def _drop_manifest(self, plan_hash: str) -> None:
        try:
            os.unlink(self.manifest_path(plan_hash))
        except FileNotFoundError:
            pass

    def touch(self, manifest: Manifest) -> None:
        """LRU bookkeeping: manifest file mtime is the last-used stamp."""
        try:
            os.utime(self.manifest_path(manifest.plan_hash))
        except OSError:
            pass

    # --------------------------------------------------------------- pins

    def pins(self) -> dict[str, str]:
        try:
            with open(self._pins_path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def pin(self, plan_hash: str, label: str = "") -> None:
        pins = self.pins()
        pins[plan_hash] = label or time.strftime("%Y-%m-%d")
        self._write_pins(pins)

    def unpin(self, plan_hash: str) -> None:
        pins = self.pins()
        if pins.pop(plan_hash, None) is not None:
            self._write_pins(pins)

    def _write_pins(self, pins: dict) -> None:
        def _write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(pins, f, indent=1, sort_keys=True)

        atomic_write(self._pins_path, _write)

    # ---------------------------------------------------- adoption ledger

    def _load_seen_paths(self) -> set[str]:
        """The ledger, loaded once per store object (JSONL: one JSON
        string per line; a torn last line from a crash is skipped)."""
        if self._seen_paths is None:
            seen: set[str] = set()
            try:
                with open(self._paths_path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            entry = json.loads(line)
                        except ValueError:
                            continue  # torn tail from a crashed appender
                        if isinstance(entry, str):
                            seen.add(entry)
            except OSError:
                pass
            self._seen_paths = seen
        return self._seen_paths

    def _record_seen_path(self, path: str) -> None:
        """Durably record an output path the store has bound. The ledger
        must outlive the manifest: GC eviction (or a corruption drop)
        removes the manifest but leaves the materialized output on disk,
        and without this record a later run with a CHANGED plan would
        re-adopt those stale bytes instead of rebuilding (defeating
        hash-equality staleness exactly where it matters). O(1) per
        commit: append-only JSONL, deduped through the in-memory cache.
        Best-effort: a persistence failure degrades to the legacy
        adoption trust."""
        path = os.path.abspath(path)
        with self._paths_lock:
            seen = self._load_seen_paths()
            if path in seen:
                return
            seen.add(path)
            if self._known_paths is not None:
                self._known_paths.add(path)
            try:
                with open(self._paths_path, "a") as f:
                    f.write(json.dumps(path) + "\n")
            except OSError:
                pass

    # -------------------------------------------------------------- commit

    def _ingest(self, path: str) -> dict:
        """Hash `path` and commit its bytes into the hot tier atomically
        (tmp + rename with a pid+thread-unique scratch name; the backend
        stamps ingestion-time mtime so GC's min-object-age guard holds);
        returns the digest dict. Identical objects dedupe by construction
        — across every tier: bytes already held cold are not re-ingested
        hot, the read path promotes them when they earn it."""
        digest = keys.hash_file(path)
        if self.tiers.locate(digest["sha256"]) is None:
            self.tiers.hot.backend.put(path, digest["sha256"])
            if self._gauge_stats is not None:
                self._gauge_stats["objects"] += 1
                self._gauge_stats["bytes"] += digest["size"]
        return digest

    def commit(
        self,
        plan_hash: str,
        output_path: str,
        producer: str = "",
        provenance: Optional[dict] = None,
        sidecar_suffixes: tuple = (),
        extra_outputs: tuple = (),
        adopted: bool = False,
    ) -> Manifest:
        """Bind `plan_hash` to the artifact at `output_path` (plus any
        existing `output_path + suffix` sidecars and `extra_outputs`
        companion files at their own absolute paths). The container
        read-back probe runs BEFORE ingestion: an artifact that does not
        decode is rejected here, at the boundary where rebuilding is
        cheap, instead of being served as a 'verified' cache hit later."""
        media = _probe_readback(output_path)
        digest = self._ingest(output_path)
        sidecars = {}
        for suffix in sidecar_suffixes:
            side = output_path + suffix
            if os.path.isfile(side):
                sidecars[suffix] = self._ingest(side)
        extras = {}
        base = os.path.dirname(os.path.abspath(output_path))
        for extra in extra_outputs:
            if os.path.isfile(extra):
                rel = os.path.relpath(os.path.abspath(extra), base)
                extras[rel] = self._ingest(extra)
        st = os.stat(output_path)
        provenance = dict(provenance or {})
        if adopted:
            provenance["adopted"] = True
        manifest = Manifest(
            plan_hash=plan_hash,
            object=digest,
            producer=producer,
            created_at=time.time(),
            chain_version=keys.chain_version(),
            provenance=provenance,
            media=media,
            sidecars=sidecars,
            extras=extras,
            materialized={"path": os.path.abspath(output_path),
                          "size": st.st_size, "mtime_ns": st.st_mtime_ns},
        )
        self._write_manifest(manifest)
        self._record_seen_path(output_path)
        # plan-purity recorder (PC_PLAN_DEBUG, utils/plandebug): every
        # commit binds plan hash -> content digest; two different byte
        # streams under one hash fail the suite's sessionfinish gate
        plandebug.record(plan_hash, digest["sha256"], producer=producer,
                         scope=self.root)
        self.update_gauges()
        return manifest

    def should_adopt(self, output_path: str) -> bool:
        """Whether an existing output the store has never seen should be
        adopted (committed as-is under the current plan hash) instead of
        rebuilt. True exactly when the store has never bound this path —
        neither a live manifest nor the durable seen-paths ledger (which
        survives GC eviction and corruption drops) knows it. Pre-store
        artifacts keep the legacy skip-existing trust on the first
        store-enabled run; a path the store HAS tracked whose plan hash
        no longer matches is genuinely stale and must rebuild."""
        if self._known_paths is None:
            self._known_paths = {
                m.materialized["path"]
                for m in self.iter_manifests()
                if m.materialized
            } | self._load_seen_paths()
        return os.path.abspath(output_path) not in self._known_paths

    # ---------------------------------------------------------------- read

    def verify_object(self, digest: dict, deep: bool = False) -> None:
        """Raise StoreCorruption unless the stored object matches its
        digest: size always, head digest always, full digest when small
        or `deep`. The object may live in ANY tier; a cold-tier copy is
        verified through the backend's streamed read — the same checks,
        at whichever boundary holds the bytes."""
        sha = digest["sha256"]
        located = self.tiers.head(sha)
        if located is None:
            raise StoreCorruption(f"object {sha[:12]} missing")
        tier, size = located
        if size != digest["size"]:
            raise StoreCorruption(
                f"object {sha[:12]}: size {size} != recorded "
                f"{digest['size']} (tier {tier.name})"
            )
        obj = tier.backend.local_path(sha)
        if obj is not None:
            if deep or size <= _FULL_VERIFY_MAX:
                found = keys.hash_file(obj)
                if found["sha256"] != sha:
                    raise StoreCorruption(
                        f"object {sha[:12]}: content digest mismatch "
                        f"(tier {tier.name})"
                    )
            else:
                with open(obj, "rb") as f:
                    head = f.read(1 << 20)
                if keys.sha256_hex(head) != digest["head_sha256"]:
                    raise StoreCorruption(
                        f"object {sha[:12]}: head digest mismatch "
                        f"(tier {tier.name})"
                    )
        else:  # no filesystem path (object tier): stream the same checks
            with tier.backend.open_read(sha) as f:
                if deep or size <= _FULL_VERIFY_MAX:
                    hasher = hashlib.sha256()
                    while True:
                        block = f.read(1 << 20)
                        if not block:
                            break
                        hasher.update(block)
                    if hasher.hexdigest() != sha:
                        raise StoreCorruption(
                            f"object {sha[:12]}: content digest mismatch "
                            f"(tier {tier.name})"
                        )
                elif keys.sha256_hex(f.read(1 << 20)) != digest["head_sha256"]:
                    raise StoreCorruption(
                        f"object {sha[:12]}: head digest mismatch "
                        f"(tier {tier.name})"
                    )

    def drop_corrupt_objects(self, manifest: Manifest) -> None:
        """Unlink every object of `manifest` that fails verification. The
        bytes must go WITH the manifest: the rebuild produces the same
        content digest, and `_ingest` dedupes on object existence — a
        corrupt object left in place would be silently re-adopted and
        re-detected on every later run."""
        for digest in manifest.all_digests():
            try:
                self.verify_object(digest, deep=True)
            except StoreCorruption:
                if not self.tiers.delete_everywhere(digest["sha256"]):
                    continue
                if self._gauge_stats is not None:
                    self._gauge_stats["objects"] -= 1
                    self._gauge_stats["bytes"] -= digest["size"]

    def _materialize_one(self, digest: dict, dest: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        obj = self.object_path(digest["sha256"])
        if not os.path.isfile(obj) and self.tiers.multi:
            # the bytes live in a colder tier: promote first (digest-
            # verified at the boundary they cross), then hardlink from
            # the hot copy exactly like the flat-store path
            try:
                self.tiers.promote(digest["sha256"])
            except BackendIntegrityError as exc:
                raise StoreCorruption(str(exc)) from exc
        try:
            if os.path.samefile(obj, dest):
                # dest already IS the object (hardlink). Linking through
                # tmp would strand it: POSIX rename of two links of one
                # inode is a silent NO-OP, leaving tmp behind to fail
                # the NEXT materialize with EEXIST — which converted a
                # perfectly warm hit into a spurious rebuild whenever
                # two destinations share one plan hash (sibling HRCs
                # with identical wo_buffer plans).
                return
        except OSError:
            pass  # dest missing (or stat raced): materialize normally
        tmp = f"{dest}.store.{os.getpid()}.part"
        try:
            if os.path.isfile(tmp):
                # stale strand from a pre-fix run or a crashed
                # materialize: heal it instead of failing EEXIST
                os.unlink(tmp)
            _link_or_copy(obj, tmp)
            os.replace(tmp, dest)
        except BaseException:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise

    def _dest_current(self, manifest: Manifest, dest: str) -> bool:
        """Cheap staleness check for an already-materialized output: stat
        signature equality with what commit/materialize recorded."""
        rec = manifest.materialized
        if not rec or rec.get("path") != os.path.abspath(dest):
            return False
        try:
            st = os.stat(dest)
        except OSError:
            return False
        return st.st_size == rec["size"] and st.st_mtime_ns == rec["mtime_ns"]

    def serve_hit(
        self, manifest: Manifest, dest: str, materialize: bool = True,
        deep: bool = False,
    ) -> bool:
        """Serve a plan-hash hit: verify the object, then ensure `dest`
        (and sidecars) hold its bytes. False — after counting the
        corruption and dropping the manifest — means the caller must
        rebuild; the store never serves bytes it cannot vouch for."""
        try:
            for digest in manifest.all_digests():
                self.verify_object(digest, deep=deep)
        except StoreCorruption as exc:
            get_logger().warning(
                "store: %s (plan %s, producer %r); %s", exc,
                manifest.plan_hash[:12], manifest.producer,
                "dropping manifest and rebuilding" if materialize
                else "would drop manifest and rebuild (dry-run: store "
                     "left untouched)",
            )
            STORE_CORRUPT.inc()
            tm.emit("store_corrupt", plan=manifest.plan_hash,
                    producer=manifest.producer, error=str(exc)[:300])
            if materialize:
                # dry-run planning must not mutate the store: report the
                # corruption (counter + "would rebuild") and leave the
                # drop to the real run
                self.drop_corrupt_objects(manifest)
                self._drop_manifest(manifest.plan_hash)
            return False  # rebuild required
        if not materialize:  # dry-run planning: count the hit, touch nothing
            return True
        # extras rebase onto the CURRENT dest (they are stored relative
        # to the output's directory): a relocated database materializes
        # its companions next to the new output instead of resurrecting
        # the directory tree recorded at commit time
        extra_dest = os.path.dirname(os.path.abspath(dest))
        try:
            if not self._dest_current(manifest, dest):
                self._materialize_one(manifest.object, dest)
                for suffix, digest in manifest.sidecars.items():
                    self._materialize_one(digest, dest + suffix)
                for rel, digest in manifest.extras.items():
                    self._materialize_one(
                        digest, os.path.normpath(os.path.join(extra_dest, rel))
                    )
                st = os.stat(dest)
                manifest.materialized = {
                    "path": os.path.abspath(dest),
                    "size": st.st_size, "mtime_ns": st.st_mtime_ns,
                }
                self._write_manifest(manifest)
                self._record_seen_path(dest)
            else:
                # main output untouched, but a companion may have been
                # deleted out-of-band (e.g. -r removed an intermediate's
                # sidecar): restore any that are missing
                for suffix, digest in manifest.sidecars.items():
                    if not os.path.isfile(dest + suffix):
                        self._materialize_one(digest, dest + suffix)
                for rel, digest in manifest.extras.items():
                    path = os.path.normpath(os.path.join(extra_dest, rel))
                    if not os.path.isfile(path):
                        self._materialize_one(digest, path)
            self.touch(manifest)
            return True
        except (OSError, StoreCorruption) as exc:
            get_logger().warning(
                "store: could not materialize %s -> %s (%s); rebuilding",
                manifest.plan_hash[:12], dest, exc,
            )
            return False

    # ------------------------------------------------------- tiered reads

    def locate_tier(self, sha256: str) -> Optional[str]:
        """The name of the hottest tier holding the object, or None."""
        tier = self.tiers.locate(sha256)
        return tier.name if tier is not None else None

    def open_object_read(
        self, sha256: str, plan: Optional[str] = None, heat=None,
    ) -> tuple:
        """Open an object for serving: `(hit_tier, path, fileobj, size)`.

        The hit tier is the one the read FOUND the bytes in (counted in
        `chain_store_tier_hits_total` and journaled with the read); a
        non-hot hit is promoted read-through first — digest-verified at
        the boundary it crosses — and then served from the hot copy's
        fd, falling back to a direct backend stream when the promotion
        cannot complete (e.g. hot disk full). `path` is None when the
        serving tier has no filesystem path (a direct cold stream)."""
        from .tiers import TIER_HITS

        located = self.tiers.head(sha256)
        if located is None:
            raise FileNotFoundError(f"object {sha256[:12]} in no tier")
        tier, size = located
        hit = tier.name
        TIER_HITS.labels(tier=hit).inc()
        if tier is not self.tiers.hot and self.tiers.promote_on_read:
            try:
                self.tiers.promote(sha256, plan=plan, heat=heat)
                path = self.object_path(sha256)
                return hit, path, open(path, "rb"), size
            except (OSError, BackendIntegrityError) as exc:
                get_logger().warning(
                    "store: read-through promotion of %s from %s failed "
                    "(%s); serving from %s directly",
                    sha256[:12], hit, exc, hit,
                )
        path = tier.backend.local_path(sha256)
        return hit, path, tier.backend.open_read(sha256), size

    # ----------------------------------------------------------- accounting

    def iter_objects(self) -> Iterator[tuple[str, int]]:
        """(sha256, size) for every object across all tiers, deduped to
        the hottest copy (a mid-move duplicate counts once)."""
        for sha, size, _tier in self.tiers.iter_objects():
            yield sha, size

    def stats(self) -> dict:
        n = 0
        total = 0
        for _, size in self.iter_objects():
            n += 1
            total += size
        manifests = sum(
            1 for f in os.listdir(self.manifests_dir) if f.endswith(".json")
        ) if os.path.isdir(self.manifests_dir) else 0
        out = {"objects": n, "bytes": total, "manifests": manifests,
               "pins": len(self.pins())}
        if self.tiers.multi:
            out["tiers"] = self.tiers.tier_stats()
        return out

    def update_gauges(self, full: bool = False) -> None:
        """Refresh the byte/object gauges. The full objects/ walk runs
        once (then GC passes force it with `full=True`); per-commit calls
        apply the increments _ingest tracked — a walk per commit would
        make store population O(N²) in stat calls."""
        if not tm.enabled():
            return
        if full or self._gauge_stats is None:
            s = self.stats()
            self._gauge_stats = {"objects": s["objects"], "bytes": s["bytes"]}
            self.tiers.update_gauges()
        STORE_BYTES.set(self._gauge_stats["bytes"])
        STORE_OBJECTS.set(self._gauge_stats["objects"])
