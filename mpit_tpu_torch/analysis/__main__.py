"""``python -m mpit_tpu_torch.analysis`` — the port's analysis toolbox
dispatcher (reads source; needs no device).

Subcommands:

- (default / paths) — the mtlint linter over ``mpit_tpu_torch/`` (same as
  ``tools/torch_mtlint.py``)
- ``schema``      — wire-schema registry tooling: ``--emit-docs`` writes
  the generated PROTOCOL.md §1/§6.0 tables, ``--check`` gates doc and
  code drift (CI runs ``schema --emit-docs --check``)
- ``modelcheck``  — bounded interleaving exploration of the schema's
  handshake machines (``--report`` writes the explored-state JSON)
- ``disciplines`` — verify the declared concurrency/ownership
  disciplines (atomic sections, single-writer sets, ownership seams)
  and the torch rules' ``HOT_PATHS`` against the tree, and gate on
  stale declarations (``--report`` writes the mpit_disciplines/1
  coverage JSON)
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "schema":
        from mpit_tpu_torch.analysis import schema

        return schema.main(argv[1:])
    if argv and argv[0] == "modelcheck":
        from mpit_tpu_torch.analysis import modelcheck

        return modelcheck.main(argv[1:])
    if argv and argv[0] == "disciplines":
        from mpit_tpu_torch.analysis import disciplines

        return disciplines.main(argv[1:])
    from mpit_tpu_torch.analysis.cli import main as lint_main

    return lint_main(argv)


if __name__ == "__main__":
    sys.exit(main())
