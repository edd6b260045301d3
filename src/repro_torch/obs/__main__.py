"""CLI entry: ``python -m repro_torch.obs --validate metrics.jsonl`` (or
``--to-prom``), as ``repro.obs``'s.

Lives here (not in emit.py) so runpy does not re-execute a module the
package ``__init__`` already imported; the guard keeps a package walk
that imports it from running the CLI.
"""
from .emit import main

if __name__ == "__main__":
    raise SystemExit(main())
