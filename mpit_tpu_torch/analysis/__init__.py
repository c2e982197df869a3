"""mtlint for mpit_tpu_torch — framework-aware static analysis of the port.

The port's own copy of the JAX package's analyzer, pointed at
``mpit_tpu_torch/``.  It reads source and needs no device: the rules run
on any host, the card's included, without importing torch.  The rule
families keep the port's invariants machine-checked on every tier-1 run:

- **protocol** (MT-P1xx/P2xx/P5xx): PS wire-protocol conformance — tag
  pairing across the client/server roles, ``*_ACK`` write tails,
  request/reply deadlock shapes, bounded waits, and comm/native spec
  drift;
- **concurrency** (MT-C2xx): lock-order inversions, blocking calls
  under a lock, and scheduler yields inside lock regions;
- **torch** (MT-T3xx): host syncs and Python branches on tensor values
  inside hot functions (CUDA-graph captures, autograd Functions under
  ``ops/``, and the declared ``torchrules.HOT_PATHS``), out-of-place
  state rebinding in update steps, and host transfers on the device
  plane — the counterpart of the JAX package's MT-J3xx;
- **observability** (MT-O4xx): the mpit_tpu_torch.obs contract;
- **wire schema** (MT-S6xx): the declarative registry in
  ``analysis/schema.py`` (the same wire as the JAX package's, so the
  same registry) — the wire modules and the negotiation code must
  conform, and the PROTOCOL.md §1/§6.0 tables are generated from it
  (``python -m mpit_tpu_torch.analysis schema --emit-docs [--check]``);
- **model checking** (MT-M7xx): ``python -m mpit_tpu_torch.analysis
  modelcheck`` explores the schema-declared handshake state machines;
- **disciplines** (MT-Y8xx/MT-D9xx): declared atomic sections, single
  writers and ownership seams, verified against the port's code.

Run ``python tools/torch_mtlint.py mpit_tpu_torch/`` (or the
``mtlint-torch`` console entry).  The checked-in ``mtlint_torch.toml``
baseline carries the vetted suppressions — keyed by line-content
hashes, so unrelated line moves never force a re-pin.
"""

from mpit_tpu_torch.analysis.config import Config, Suppression, discover_config, load_config
from mpit_tpu_torch.analysis.core import RULES, Finding
from mpit_tpu_torch.analysis.engine import Report, run

__all__ = [
    "Config",
    "Finding",
    "Report",
    "RULES",
    "Suppression",
    "discover_config",
    "load_config",
    "run",
]
