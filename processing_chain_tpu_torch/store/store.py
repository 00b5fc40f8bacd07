"""CAS object directory with atomic commits and integrity-verified reads
(trimmed copy of processing_chain_tpu/store/store.py: one local backend,
one output file an artifact, no tier hierarchy, no object backend, no
adoption of pre-store outputs, no pins or GC). Every commit feeds the
PC_PLAN_DEBUG plan-purity recorder (utils/plandebug).

On-disk layout under the store root (docs/STORE.md):

    objects/<digest[:2]>/<digest>     content-addressed artifact bytes
    manifests/<plan_hash>.json        one manifest per cached plan
    tmp/                              in-flight commits (pid-unique names)
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
never to a served artifact. The reference additionally probes media
containers at commit through libav; the port has no media boundary, so
its probe is the reference's answer when no decoder loads: none.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from .. import telemetry as tm
from ..utils import plandebug
from ..utils.fsio import atomic_write
from ..utils.log import get_logger
from . import keys
from .backends.local import LocalBackend, _link_or_copy

STORE_HITS = tm.counter(
    "chain_store_hits_total", "jobs served from the artifact store", ("runner",)
)
STORE_MISSES = tm.counter(
    "chain_store_misses_total", "plan hashes with no committed artifact",
    ("runner",),
)
STORE_CORRUPT = tm.counter(
    "chain_store_corrupt_total",
    "integrity failures detected on read (digest or container probe)",
)
STORE_BYTES = tm.gauge(
    "chain_store_object_bytes", "bytes held in the store's object directory"
)
STORE_OBJECTS = tm.gauge(
    "chain_store_objects", "objects held in the store's object directory"
)

#: full-digest verification threshold for ordinary (non-deep) reads
_FULL_VERIFY_MAX = 64 << 20

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
            materialized=data.get("materialized"),
        )


class ArtifactStore:
    """Content-addressed store rooted at one directory. Thread-compatible
    with the chain's job pools: commits are tmp+rename (last writer of an
    identical object wins, harmlessly), manifests are whole-file atomic
    writes, and the digest cache carries its own lock (plan hashes are
    resolved on JobRunner workers)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.manifests_dir = os.path.join(self.root, "manifests")
        self.tmp_dir = os.path.join(self.root, "tmp")
        for d in (self.objects_dir, self.manifests_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)
        self.backend = LocalBackend(self.objects_dir, self.tmp_dir)
        self.digests = keys.DigestCache(os.path.join(self.root, "digest-cache.json"))
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
            # the rebuild's commit overwrites it atomically
            get_logger().warning(
                "store: unreadable manifest %s (%s); treating as a miss",
                path, exc,
            )
            STORE_CORRUPT.inc()
            return None

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

    # -------------------------------------------------------------- commit

    def _ingest(self, path: str) -> dict:
        """Hash `path` and commit its bytes into the backend atomically
        (tmp + rename with a pid+thread-unique scratch name; the backend
        stamps ingestion-time mtime so GC's min-object-age guard holds);
        returns the digest dict. Identical objects dedupe by
        construction."""
        digest = keys.hash_file(path)
        if self.backend.head(digest["sha256"]) is None:
            self.backend.put(path, digest["sha256"])
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
    ) -> Manifest:
        """Bind `plan_hash` to the artifact at `output_path`. The
        reference runs a container read-back probe here, before
        ingestion; the port has no decoder, so `media` is None as in the
        reference on a host where none loads."""
        digest = self._ingest(output_path)
        st = os.stat(output_path)
        manifest = Manifest(
            plan_hash=plan_hash,
            object=digest,
            producer=producer,
            created_at=time.time(),
            chain_version=keys.chain_version(),
            provenance=dict(provenance or {}),
            materialized={"path": os.path.abspath(output_path),
                          "size": st.st_size, "mtime_ns": st.st_mtime_ns},
        )
        self._write_manifest(manifest)
        # plan-purity recorder (PC_PLAN_DEBUG, utils/plandebug): every
        # commit binds plan hash -> content digest; two different byte
        # streams under one hash fail its check()
        plandebug.record(plan_hash, digest["sha256"], producer=producer,
                         scope=self.root)
        self.update_gauges()
        return manifest

    # ---------------------------------------------------------------- read

    def verify_object(self, digest: dict, deep: bool = False) -> None:
        """Raise StoreCorruption unless the stored object matches its
        digest: size always, head digest always, full digest when small
        or `deep`."""
        sha = digest["sha256"]
        size = self.backend.head(sha)
        if size is None:
            raise StoreCorruption(f"object {sha[:12]} missing")
        if size != digest["size"]:
            raise StoreCorruption(
                f"object {sha[:12]}: size {size} != recorded "
                f"{digest['size']}"
            )
        obj = self.object_path(sha)
        if deep or size <= _FULL_VERIFY_MAX:
            found = keys.hash_file(obj)
            if found["sha256"] != sha:
                raise StoreCorruption(
                    f"object {sha[:12]}: content digest mismatch")
        else:
            with open(obj, "rb") as f:
                head = f.read(1 << 20)
            if keys.sha256_hex(head) != digest["head_sha256"]:
                raise StoreCorruption(
                    f"object {sha[:12]}: head digest mismatch")

    def drop_corrupt_object(self, manifest: Manifest) -> None:
        """Unlink the object of `manifest` if it fails verification. The
        bytes must go WITH the manifest: the rebuild produces the same
        content digest, and `_ingest` dedupes on object existence — a
        corrupt object left in place would be silently re-adopted and
        re-detected on every later run."""
        digest = manifest.object
        try:
            self.verify_object(digest, deep=True)
        except StoreCorruption:
            if self.backend.delete(digest["sha256"]) \
                    and self._gauge_stats is not None:
                self._gauge_stats["objects"] -= 1
                self._gauge_stats["bytes"] -= digest["size"]

    def _materialize_one(self, digest: dict, dest: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        obj = self.object_path(digest["sha256"])
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

    def serve_hit(self, manifest: Manifest, dest: str) -> bool:
        """Serve a plan-hash hit: verify the object, then ensure `dest`
        holds its bytes. False — after counting the corruption and
        dropping the manifest — means the caller must rebuild; the store
        never serves bytes it cannot vouch for."""
        try:
            self.verify_object(manifest.object)
        except StoreCorruption as exc:
            get_logger().warning(
                "store: %s (plan %s, producer %r); dropping manifest and "
                "rebuilding", exc, manifest.plan_hash[:12], manifest.producer,
            )
            STORE_CORRUPT.inc()
            tm.emit("store_corrupt", plan=manifest.plan_hash,
                    producer=manifest.producer, error=str(exc)[:300])
            self.drop_corrupt_object(manifest)
            self._drop_manifest(manifest.plan_hash)
            return False  # rebuild required
        try:
            if not self._dest_current(manifest, dest):
                self._materialize_one(manifest.object, dest)
                st = os.stat(dest)
                manifest.materialized = {
                    "path": os.path.abspath(dest),
                    "size": st.st_size, "mtime_ns": st.st_mtime_ns,
                }
                self._write_manifest(manifest)
            self.touch(manifest)
            return True
        except (OSError, StoreCorruption) as exc:
            get_logger().warning(
                "store: could not materialize %s -> %s (%s); rebuilding",
                manifest.plan_hash[:12], dest, exc,
            )
            return False

    # --------------------------------------------------------------- reads

    def open_object_read(self, sha256: str) -> tuple:
        """Open an object for serving: `(path, fileobj, size)`. The open
        descriptor keeps the bytes alive for the whole response even if
        the object is unlinked meanwhile. Raises FileNotFoundError when
        the object is gone."""
        size = self.backend.head(sha256)
        if size is None:
            raise FileNotFoundError(f"object {sha256[:12]} missing")
        path = self.object_path(sha256)
        return path, self.backend.open_read(sha256), size

    # ----------------------------------------------------------- accounting

    def update_gauges(self) -> None:
        """Refresh the byte/object gauges. The objects/ walk runs once;
        later calls apply the increments _ingest tracked — a walk per
        commit would make store population O(N²) in stat calls."""
        if not tm.enabled():
            return
        if self._gauge_stats is None:
            sizes = [size for _, size in self.backend.list()]
            self._gauge_stats = {"objects": len(sizes), "bytes": sum(sizes)}
        STORE_BYTES.set(self._gauge_stats["bytes"])
        STORE_OBJECTS.set(self._gauge_stats["objects"])
