"""mpit_tpu_torch.lm — the flagship workload: a sharded transformer LM
trained through the full parameter-server stack, measured in tokens/second.

The port of ``mpit_tpu/lm/``:

- :mod:`mpit_tpu_torch.lm.model` — transformer-LM over
  ``models/transformer.TinyDecoder`` and the flash kernels, flattened to
  the PS wire vector, with per-parameter optimizer slots;
- :mod:`mpit_tpu_torch.lm.plan` — ``dplane/partition.py`` rules over the
  params+optimizer tree, lowered to a weighted **aligned-cut** layout
  (and to a shard control ShardMap when placement should migrate);
- :mod:`mpit_tpu_torch.lm.data` — a seeded, bit-reproducible packed token
  stream (same seed => identical batches, in any process, in either
  package);
- :mod:`mpit_tpu_torch.lm.trainer` — the async DOWNPOUR/EAMSGD client loop
  with a ``mpit_lm_tokens_total`` meter; tokens/sec is the headline.

Launcher entry: ``train/launch.py --lm 1``.
"""

from mpit_tpu_torch.lm.data import EOS, PackedStream, packed_batch
from mpit_tpu_torch.lm.model import LmModel, build, train_state_tree
from mpit_tpu_torch.lm.plan import PARTITION_RULES, LmPlan, audit_rules, plan
from mpit_tpu_torch.lm.trainer import LM_DEFAULTS, LmTrainer

__all__ = [
    "EOS", "PackedStream", "packed_batch",
    "LmModel", "build", "train_state_tree",
    "PARTITION_RULES", "LmPlan", "audit_rules", "plan",
    "LM_DEFAULTS", "LmTrainer",
]
