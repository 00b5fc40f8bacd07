"""Canonical plan hashing: the cache key schema of the artifact store
(copy of processing_chain_tpu/store/keys.py; the same payload hashes to
the same key in both packages).

A *plan* is a plain JSON-able dict describing everything that determines
an artifact's content: which input files (by content digest), which
resolved parameters (codec, rate control, canvas geometry, event lists),
and which producer version. Two runs that would produce the same artifact
hash to the same key; any semantic change — one flipped HRC parameter,
one re-encoded input segment — changes the key and invalidates exactly
the artifacts downstream of it.

Input files appear in plans as `file_ref(path)` markers so the model
layer never hashes anything itself; `resolve_plan` replaces each marker
with the file's content digest (sha256 + size) using a stat-keyed digest
cache, so a warm run pays one stat() per input instead of re-hashing
multi-GB SRC files.

Keys are versioned twice over: KEY_SCHEMA_VERSION (the shape of this
module's output — bump on any change to canonicalization or the resolved
marker format) and the chain version (tool provenance: artifacts built by
a different chain build are not trusted as equal). Both are folded into
every hash by `plan_hash`.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Any, Callable, Optional
from ..utils import lockdebug

#: bump when canonical_json / resolve_plan output shape changes
KEY_SCHEMA_VERSION = 1

#: digest read granularity (also the "head" spot-check window)
_BLOCK = 1 << 20

_FILE_MARKER = "__file__"


class PlanError(ValueError):
    """A plan payload cannot be canonicalized (unhashable value types)."""


def file_ref(path: str) -> dict:
    """Marker for an input file in a plan payload; resolved to a content
    digest by `resolve_plan` at hash time."""
    return {_FILE_MARKER: os.path.abspath(os.fspath(path))}


@functools.lru_cache(maxsize=1)
def chain_version() -> str:
    from ..utils.version import get_processing_chain_version

    return get_processing_chain_version()


def _canonical(value: Any) -> Any:
    """Normalize a payload value into the canonical JSON-able subset:
    dicts (string keys, sorted at dump time), lists (tuples collapse into
    them), bools/ints/floats/strings/None. Anything else is a schema bug
    and raises instead of hashing repr() noise."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                raise PlanError(f"plan keys must be strings, got {k!r}")
            out[k] = _canonical(v)
        return out
    if isinstance(value, (list, tuple)):
        return [_canonical(v) for v in value]
    if isinstance(value, float):
        # integral floats and ints must collide (YAML parses `24` and
        # `24.0` interchangeably across databases)
        return int(value) if value.is_integer() else value
    if value is None or isinstance(value, (bool, int, str)):
        return value
    raise PlanError(f"unhashable plan value {value!r} ({type(value).__name__})")


def canonical_json(payload: Any) -> str:
    """Deterministic serialization: sorted keys, no whitespace, normalized
    numbers. The hash input format — stable across processes and dict
    insertion orders."""
    return json.dumps(
        _canonical(payload), sort_keys=True, separators=(",", ":"),
        ensure_ascii=True, allow_nan=False,
    )


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def hash_file(path: str) -> dict:
    """Full + head content digest of a file: {"sha256", "head_sha256",
    "size"}. The head digest (first _BLOCK bytes) is the cheap spot-check
    window for verified reads of large artifacts."""
    full = hashlib.sha256()
    head = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        first = True
        for block in iter(lambda: f.read(_BLOCK), b""):
            if first:
                head.update(block[:_BLOCK])
                first = False
            full.update(block)
            size += len(block)
    return {"sha256": full.hexdigest(), "head_sha256": head.hexdigest(),
            "size": size}


def _stat_key(path: str, st: os.stat_result) -> str:
    return f"{path}|{st.st_size}|{st.st_mtime_ns}"


class DigestCache:
    """Content digests keyed by (path, size, mtime_ns), optionally
    persisted as JSON inside the store root. A file whose stat signature
    is unchanged serves its digest without re-reading; a rewrite that
    preserves both size and mtime_ns is indistinguishable by design (the
    same trust model as make/ninja/bazel local caches). Thread-safe:
    commit-time hash re-resolution runs on JobRunner worker threads, and
    `atomic_write`'s tmp name is pid-unique, not thread-unique, so an
    unlocked save() from two workers could persist a truncated file."""

    def __init__(self, path: Optional[str] = None) -> None:
        self._path = path
        self._entries: dict[str, dict] = {}
        self._dirty = 0
        self._lock = lockdebug.make_lock("digest_cache")
        if path and os.path.isfile(path):
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    self._entries = loaded
            except (OSError, ValueError):
                self._entries = {}

    def digest(self, path: str) -> dict:
        """{"sha256", "head_sha256", "size"} for `path` (raises OSError
        when unreadable)."""
        path = os.path.abspath(path)
        key = _stat_key(path, os.stat(path))
        with self._lock:
            hit = self._entries.get(key)
        if hit is not None:
            return hit
        entry = hash_file(path)  # outside the lock: hashing can be slow
        with self._lock:
            self._entries[key] = entry
            self._dirty += 1
        return entry

    def save(self) -> None:
        from ..utils.fsio import atomic_write

        with self._lock:
            if not self._path or not self._dirty:
                return
            # prune entries whose stat signature no longer matches disk:
            # every input rewrite adds a fresh key, so without this the
            # persisted cache would grow by one dead entry per rewrite
            # of every SRC/intermediate, forever (one stat per entry,
            # once per run end)
            live = {}
            for key, entry in self._entries.items():
                path = key.rsplit("|", 2)[0]
                try:
                    if _stat_key(path, os.stat(path)) == key:
                        live[key] = entry
                except OSError:
                    continue  # deleted input: drop its entries
            self._entries = live

            def _write(tmp: str) -> None:
                with open(tmp, "w") as f:
                    json.dump(live, f)

            try:
                atomic_write(self._path, _write)
                self._dirty = 0
            except OSError:
                pass  # cache persistence is best-effort by contract


def resolve_plan(payload: Any, digest: Callable[[str], dict]) -> Any:
    """Deep-copy `payload` with every file_ref marker replaced by
    {"file": basename, "sha256": ..., "size": ...}. `digest` is
    DigestCache.digest or equivalent. Raises OSError when a referenced
    input does not exist — callers decide whether that degrades to the
    legacy exists-check or aborts."""
    if isinstance(payload, dict):
        if set(payload) == {_FILE_MARKER}:
            path = payload[_FILE_MARKER]
            d = digest(path)
            # basename, not the absolute path: the same database rendered
            # under two mount points must produce equal keys
            return {"file": os.path.basename(path), "sha256": d["sha256"],
                    "size": d["size"]}
        return {k: resolve_plan(v, digest) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return [resolve_plan(v, digest) for v in payload]
    return payload


def plan_hash(payload: dict, digest: Optional[Callable[[str], dict]] = None) -> str:
    """The cache key: sha256 over the canonical serialization of the
    resolved payload, folded with the key schema + chain version."""
    resolved = resolve_plan(payload, digest) if digest is not None else payload
    envelope = {
        "schema": KEY_SCHEMA_VERSION,
        "chain": chain_version(),
        "plan": resolved,
    }
    return sha256_hex(canonical_json(envelope).encode())
