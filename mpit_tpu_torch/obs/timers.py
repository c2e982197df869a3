"""Per-phase wall-clock timers and ``torch.profiler`` hooks.

:class:`PhaseTimers` is the trainer-loop timer of
:mod:`mpit_tpu.obs.timers`, copied.  :func:`trace_annotation` and
:func:`profiler_trace` are its profiler bridge on ``torch.profiler``:
wrap host work in :func:`trace_annotation` while :func:`profiler_trace`
records, and the phase shows on the timeline beside the CUDA kernels.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseTimers:
    """Accumulate wall-clock seconds per named phase."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self._t0 = time.monotonic()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.monotonic()
        try:
            yield
        finally:
            self.total[name] += time.monotonic() - start
            self.count[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.total[name] += seconds
        self.count[name] += 1

    def elapsed(self) -> float:
        """Seconds since this timer set was created."""
        return time.monotonic() - self._t0

    def summary(self) -> str:
        lines = [f"total elapsed {self.elapsed():.3f}s"]
        for name in sorted(self.total):
            tot, cnt = self.total[name], self.count[name]
            avg = tot / max(cnt, 1)
            lines.append(f"  {name:<16} {tot:9.3f}s  n={cnt:<8d} avg={avg * 1e3:8.3f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """A named range on the profiler timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiler_trace(log_dir: str | None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the enclosed block and write it
    as ``<log_dir>/trace.json`` (Chrome trace format, opens in Perfetto);
    no-op when ``log_dir`` is falsy.  CUDA activity is recorded when a
    card is present."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
