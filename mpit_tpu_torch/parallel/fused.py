"""The row-batched fused commit for mesh trainer state.

The port of ``mpit_tpu/parallel/fused.py``.  The reference wraps its 1-D
Pallas sweep in ``shard_map`` so each device commits the worker-row tile
it holds.  On the one-device stand-in mesh every worker row lives on the
same card, and K1 itself takes the whole ``(n_dp, plong)`` state with a
``(n_dp,)`` ``clr`` on the device and an optional ``sug``: one launch
commits every row, each with its own decayed lr, the EASGD retract riding
the same sweep on sync rounds.  So this module only names that kernel;
:class:`mpit_tpu_torch.parallel.MeshEASGD` reaches it through
:func:`mpit_tpu_torch.optim.msgd.msgd_commit`.
"""

from mpit_tpu_torch.ops.fused_update import fused_nesterov_commit

__all__ = ["fused_nesterov_commit"]
