"""`python -m processing_chain_tpu_torch p00|p01|p02|p03|p04 -c DB.yaml …` (the stage
command line, cli.py) and `python -m processing_chain_tpu_torch tools
<name> …` (the port's counterpart of the reference CLI's `tools`
subcommands)."""

from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence

#: tool name -> module whose `main(argv)` runs it
_TOOLS = {
    "chain-serve": ".tools.chain_serve",
    "mesh-report": ".tools.mesh_report",
    "run-report": ".telemetry.report",
    "chain-profile": ".tools.chain_profile",
    "chain-top": ".tools.chain_top",
    "mesh-top": ".tools.mesh_top",
    "clean-logs": ".tools.clean_logs",
    "plots": ".tools.plots",
    "serve-admin": ".tools.serve_admin",
    "store": ".tools.store_admin",
    "store-admin": ".tools.store_admin",
    "store-heat": ".tools.store_heat",
    "store-tiers": ".tools.store_tiers",
    "fleet-doctor": ".tools.fleet_doctor",
    "fleet-top": ".tools.fleet_top",
    "queue-crashcheck": ".tools.queue_crashcheck",
    "trace": ".tools.trace_tool",
    "serve-soak": ".tools.serve_soak",
    "serve-chaos": ".tools.serve_chaos",
    "chain-lint": ".tools.chainlint.cli",
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("p00", "p01", "p02", "p03", "p04"):
        from . import cli

        return cli.main(argv)
    if len(argv) < 2 or argv[0] != "tools" or argv[1] not in _TOOLS:
        sys.stderr.write(
            f"usage: python -m processing_chain_tpu_torch p00|p01|p02|p03|p04 -c DB.yaml … | "
            f"tools {{{','.join(_TOOLS)}}} …\n")
        return 2
    return importlib.import_module(_TOOLS[argv[1]], __package__).main(argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
