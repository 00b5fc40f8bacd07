"""Content-addressed artifact store (port of processing_chain_tpu/store/):
plan hashing (keys), the local object store (store) and the process-wide
active-store slot (runtime)."""

from .keys import canonical_json, file_ref, plan_hash  # noqa: F401
from .store import ArtifactStore, Manifest, StoreCorruption  # noqa: F401
