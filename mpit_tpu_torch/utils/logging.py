"""Rank-prefixed structured logging.

The reference prints to stdout with hand-rolled rank prefixes everywhere
(reference asyncsgd/goot.lua:144-145, BiCNN/bicnn.lua:414-418).  Here one
logger factory gives every role-process a ``[role rank]``-prefixed logger
with levels, so launcher, server, client and tester output interleave
legibly in a multi-process run.

A copy of ``mpit_tpu/utils/logging.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname).1s %(message)s"


def get_logger(role: str = "proc", rank: int | None = None) -> logging.Logger:
    name = f"mpit[{role}{'' if rank is None else f' {rank}'}]"
    logger = logging.getLogger(name)
    if not logger.handlers:
        # MPIT_LOG_STREAM=stderr keeps stdout machine-parseable for
        # callers whose contract is one JSON line there (bench.py).
        stream = (sys.stderr
                  if os.environ.get("MPIT_LOG_STREAM") == "stderr"
                  else sys.stdout)
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(os.environ.get("MPIT_LOGLEVEL", "INFO").upper())
    return logger
