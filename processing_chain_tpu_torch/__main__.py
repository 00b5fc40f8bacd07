"""`python -m processing_chain_tpu_torch tools <name> …` (the port's
counterpart of the reference CLI's `tools` subcommands; the stages are
not ported yet)."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

_TOOLS = ("chain-serve", "mesh-report")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] != "tools" or argv[1] not in _TOOLS:
        sys.stderr.write(
            f"usage: python -m processing_chain_tpu_torch tools "
            f"{{{','.join(_TOOLS)}}} …\n")
        return 2
    if argv[1] == "mesh-report":
        from .tools import mesh_report

        return mesh_report.main(argv[2:])
    from .tools import chain_serve

    return chain_serve.main(argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
