"""Config, logging, device selection and device timing.  The phase timers
live in :mod:`mpit_tpu_torch.obs`; re-exported here as the JAX package's
``mpit_tpu.utils`` does."""

from mpit_tpu_torch.obs.timers import PhaseTimers, profiler_trace, trace_annotation

__all__ = ["PhaseTimers", "profiler_trace", "trace_annotation"]
