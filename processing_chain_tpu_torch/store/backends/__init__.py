"""CAS backends: where artifact bytes live (trimmed copy of
processing_chain_tpu/store/backends/__init__.py). The port carries the
local `objects/` directory only; the reference's shared warm tier and
object-store cold tier are not ported."""

from .local import LocalBackend  # noqa: F401
