"""chainlint: invariant-aware static analysis for the processing chain
(the port's copy of processing_chain_tpu/tools/chainlint, run on the
port's own registries: its telemetry catalog, store/plan_schema.py and
serve/queue.py).

Generic linters catch generic Python mistakes; this package encodes the
rules that are specific to THIS codebase's concurrency and durability
conventions (docs/LINT.md), so a reviewer never again has to hand-check:

  * ``lock-guard``        — attributes annotated ``# guarded-by: <lock>``
                            are only touched under ``with <lock>``;
  * ``lock-order``        — the static lock-acquisition graph (nested
                            ``with`` scopes) stays acyclic, matched by a
                            runtime recorder (utils/lockdebug.py);
  * ``bufpool-ownership`` — every ``BufferPool.acquire`` result reaches
                            ``release``/``recycle=`` or a documented
                            ownership transfer on all control-flow paths;
  * ``subprocess-hygiene``— external commands go through
                            ``utils.runner.shell`` with list argv;
  * ``atomic-write``      — run-dir artifact writes use
                            ``fsio.atomic_write`` or tmp+``os.replace``;
  * ``telemetry-name``    — metric/event names are declared once in
                            ``telemetry/catalog.py`` and stay in sync
                            with docs/TELEMETRY.md.

Exposed as ``python -m processing_chain_tpu_torch tools chain-lint``
(cli.py) and gated against the committed ``baseline.json`` beside this
module.
"""

from .core import Finding, LintConfig, run_lint  # noqa: F401
