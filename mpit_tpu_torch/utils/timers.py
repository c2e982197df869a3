"""Re-export of the phase timers, which live in :mod:`mpit_tpu_torch.obs.timers`
(the JAX package's ``mpit_tpu/utils/timers.py`` shim).  Import from
``mpit_tpu_torch.obs`` in new code."""

from mpit_tpu_torch.obs.timers import (  # noqa: F401
    PhaseTimers,
    profiler_trace,
    trace_annotation,
)

__all__ = ["PhaseTimers", "profiler_trace", "trace_annotation"]
