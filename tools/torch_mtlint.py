#!/usr/bin/env python
"""mtlint for the PyTorch port — run the port's static analyzer from a
checkout without installing the package.  It reads source and needs no
device:

    python tools/torch_mtlint.py mpit_tpu_torch/
    python tools/torch_mtlint.py tests/fixtures/mtlint/badpkg   # exits nonzero

The baseline is the nearest ``mtlint_torch.toml`` above the first path.
Installed entry point: ``mtlint-torch`` (pyproject [project.scripts]).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from mpit_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
