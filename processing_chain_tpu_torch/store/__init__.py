"""Content-addressed artifact store (port of processing_chain_tpu/store/):
plan hashing (keys), the object store with pins (store), the tier
hierarchy over pluggable backends (tiers, backends/), mark-and-sweep and
LRU GC (gc), the access-heat ledger (heat) and the process-wide
active-store slot (runtime)."""

from .keys import canonical_json, file_ref, plan_hash  # noqa: F401
from .store import ArtifactStore, Manifest, StoreCorruption  # noqa: F401
