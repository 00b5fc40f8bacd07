"""Config-layer errors (copy of processing_chain_tpu/config/errors.py).

The reference (lib/test_config.py) calls sys.exit(1) at ~50 validation sites;
here every invariant violation raises ConfigError so the domain model is
usable as a library. The CLI layer converts ConfigError to exit code 1.
"""


class ConfigError(ValueError):
    """A database YAML (or its environment) violates a chain invariant."""
