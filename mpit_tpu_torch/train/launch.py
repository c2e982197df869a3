"""Launcher — the port of :mod:`mpit_tpu.train.launch`, ``--np 1`` only.

``--np 1`` is single-process local training with no communication (the
claunch.lua analog).  Process gangs (``--np N``: parameter servers and
workers over the host transport) come with the parameter-server slice of
the port and raise here.

Usage:
    python -m mpit_tpu_torch.train.launch --np 1 --opt msgd
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional

from mpit_tpu_torch.train.trainer import TRAINER_DEFAULTS, MnistTrainer
from mpit_tpu_torch.utils.config import Config

LAUNCH_DEFAULTS = TRAINER_DEFAULTS.merged(np=1)


def run_rank(rank: int, size: int, cfg: Config, data: Any = None) -> Dict[str, Any]:
    """Run one rank's role to completion; returns its result dict."""
    if size != 1:
        raise NotImplementedError(
            f"--np {size}: process gangs are the parameter-server slice of "
            "the port; this slice runs --np 1"
        )
    trainer = MnistTrainer(cfg, data=data, rank=rank)
    return {"role": "local", **trainer.run()}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    cfg = LAUNCH_DEFAULTS.parse_args(list(sys.argv[1:] if argv is None else argv))
    t0 = time.monotonic()
    result = run_rank(0, int(cfg.np), cfg)
    print(json.dumps({"rank0": _summarize(result)}, indent=2))
    print(f"total wall time: {time.monotonic() - t0:.1f}s")
    return result


def _summarize(result: Dict[str, Any]) -> Dict[str, Any]:
    keep = {"role", "final_test_err", "time_to_target", "elapsed"}
    return {k: v for k, v in result.items() if k in keep}


if __name__ == "__main__":
    main()
