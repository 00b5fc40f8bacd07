"""`python -m processing_chain_tpu_torch tools <name> …` (the port's
counterpart of the reference CLI's `tools` subcommands; the stages are
not ported yet)."""

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
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] != "tools" or argv[1] not in _TOOLS:
        sys.stderr.write(
            f"usage: python -m processing_chain_tpu_torch tools "
            f"{{{','.join(_TOOLS)}}} …\n")
        return 2
    return importlib.import_module(_TOOLS[argv[1]], __package__).main(argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
