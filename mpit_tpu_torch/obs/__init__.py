"""Trainer-loop timers and ``torch.profiler`` hooks."""

from mpit_tpu_torch.obs.timers import PhaseTimers, profiler_trace, trace_annotation

__all__ = ["PhaseTimers", "profiler_trace", "trace_annotation"]
