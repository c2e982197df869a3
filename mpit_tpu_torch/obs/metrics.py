"""Process-local metrics registry — counters, gauges, log2 histograms.

Design rules, in priority order:

- **Disabled is a no-op object.**  ``get_registry()`` returns
  :data:`NULL_REGISTRY` unless obs is enabled; every instrument it hands
  out is the one shared :data:`NULL` singleton whose methods do nothing
  and read no clock.  Hot paths hold instrument references and call
  ``.inc()`` unconditionally — the null object *is* the off switch.
- **Lock-cheap.**  Instrument creation (get-or-create by name+labels)
  takes the registry lock; the instruments themselves update plain
  attributes with single bytecode-level operations, which the GIL makes
  safe for the counting we do (transport reader threads + role threads).
  Call sites on hot paths cache their instruments at construction.
- **Zero-dep.**  Stdlib only; importable from the analyzer, the bench
  children, and CI boxes without a GPU or the native build.

Histograms use **fixed log2 buckets**: bucket ``i`` counts values in
``[2^(i + LO_EXP - 1), 2^(i + LO_EXP))`` — one ``math.frexp`` per
observe, no per-histogram bucket-bound configuration to disagree on,
and the same scheme serves seconds (2^-20 ≈ 1 µs granularity floor) and
byte sizes (top bucket ≥ 2^31).  Snapshots render only non-empty
buckets, keyed by their upper-bound exponent.

A copy of the JAX package's ``mpit_tpu/obs/metrics.py``: the port imports
nothing of that package.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Optional, Tuple

ENV = "MPIT_OBS"
TRACE_ENV = "MPIT_OBS_TRACE"
HTTP_ENV = "MPIT_OBS_HTTP"
PROFILE_ENV = "MPIT_OBS_PROFILE"

#: log2 histogram layout (see module docstring).
HIST_LO_EXP = -20
HIST_BUCKETS = 52


def bucket_index(value: float) -> int:
    """Bucket for ``value``: values in [2^(e-1), 2^e) land in the bucket
    whose exponent is ``e`` (clamped to the fixed range; <= 0 -> 0)."""
    if value <= 0.0:
        return 0
    e = math.frexp(value)[1]
    return min(max(e - HIST_LO_EXP, 0), HIST_BUCKETS - 1)


def bucket_upper(index: int) -> float:
    """Exclusive upper bound of bucket ``index`` (2.0 ** exponent)."""
    return 2.0 ** (index + HIST_LO_EXP)


def _render_name(name: str, labels: Tuple[Tuple[str, object], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator (ints or float sums like idle seconds)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, object], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-written value (queue depths, staged bytes, lease horizons)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, object], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def add(self, dv) -> None:
        self.value += dv


class Histogram:
    """Fixed-log2-bucket distribution with count/sum/min/max."""

    __slots__ = ("name", "labels", "buckets", "count", "total", "vmin", "vmax")

    def __init__(self, name: str, labels: Tuple[Tuple[str, object], ...] = ()):
        self.name = name
        self.labels = labels
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.buckets[bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            # non-empty buckets only, keyed by upper-bound exponent
            "buckets": {
                i + HIST_LO_EXP: n
                for i, n in enumerate(self.buckets) if n
            },
        }


class _Timer:
    """``with registry.timer(name, **labels):`` — observes the block's
    wall seconds into a histogram.  The clock lives *here*, not at the
    call site: role files route every duration through obs (the MT-O4xx
    lint contract) instead of hand-rolling ``time.monotonic()`` pairs."""

    __slots__ = ("hist", "t0")

    def __init__(self, hist: Histogram):
        self.hist = hist
        self.t0 = 0.0

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.hist.observe(time.perf_counter() - self.t0)


class _NullInstrument:
    """The shared do-nothing instrument AND null timer context.  One
    object serves every disabled counter/gauge/histogram/timer so the
    disabled path allocates nothing and reads no clock."""

    __slots__ = ()
    name = ""
    labels = ()
    value = 0
    count = 0
    total = 0.0

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def add(self, dv) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def snapshot(self) -> Dict[str, object]:
        return {}

    def __enter__(self) -> "_NullInstrument":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = _NullInstrument()


class Registry:
    """One process-local metric namespace.  Instruments are get-or-create
    by (name, sorted labels); re-requesting with a different kind is a
    loud error (a counter silently shadowing a histogram would corrupt
    both streams)."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, object]):
        key = (name, tuple(sorted(labels.items())))
        inst = self._metrics.get(key)
        if inst is None:
            with self._lock:
                inst = self._metrics.get(key)
                if inst is None:
                    inst = cls(name, key[1])
                    self._metrics[key] = inst
        if type(inst) is not cls:
            raise TypeError(
                f"metric {_render_name(name, key[1])!r} already registered "
                f"as {type(inst).__name__}, requested as {cls.__name__}"
            )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def timer(self, name: str, **labels) -> _Timer:
        return _Timer(self._get(Histogram, name, labels))

    # -- export --------------------------------------------------------------

    def instruments(self):
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, object]:
        """Full-name -> value (counters/gauges) or histogram dict."""
        out: Dict[str, object] = {}
        for inst in self.instruments():
            full = _render_name(inst.name, inst.labels)
            if isinstance(inst, Histogram):
                out[full] = inst.snapshot()
            else:
                out[full] = inst.value
        return dict(sorted(out.items()))

    def format_summary(self, prefix: Optional[str] = None) -> str:
        """Compact one-line ``name=value`` rendering for log lines
        (histograms render as count/sum)."""
        parts = []
        for full, v in self.snapshot().items():
            if prefix and not full.startswith(prefix):
                continue
            if isinstance(v, dict):
                parts.append(f"{full}=n{v.get('count', 0)}/"
                             f"{float(v.get('sum') or 0.0):.3g}s")
            else:
                parts.append(f"{full}={v:g}" if isinstance(v, float)
                             else f"{full}={v}")
        return ", ".join(parts) if parts else "(no metrics)"

    def exposition(self) -> str:
        """Prometheus-style text exposition (counters as ``_total``-named
        gauges of their value; histograms as cumulative ``_bucket{le=}``
        plus ``_sum``/``_count``)."""
        lines = []
        for inst in sorted(self.instruments(),
                           key=lambda i: (i.name, i.labels)):
            base = dict(inst.labels)
            if isinstance(inst, Histogram):
                cum = 0
                for i, n in enumerate(inst.buckets):
                    if not n:
                        continue
                    cum += n
                    lines.append(_render_name(
                        inst.name + "_bucket",
                        tuple(sorted({**base, "le": f"{bucket_upper(i):g}"}
                                     .items()))) + f" {cum}")
                if inst.count:
                    lines.append(_render_name(
                        inst.name + "_bucket",
                        tuple(sorted({**base, "le": "+Inf"}.items())))
                        + f" {inst.count}")
                lines.append(_render_name(inst.name + "_sum", inst.labels)
                             + f" {inst.total:g}")
                lines.append(_render_name(inst.name + "_count", inst.labels)
                             + f" {inst.count}")
            else:
                v = inst.value
                lines.append(_render_name(inst.name, inst.labels)
                             + (f" {v:g}" if isinstance(v, float) else f" {v}"))
        return "\n".join(lines) + ("\n" if lines else "")


class NullRegistry:
    """The disabled registry: every instrument is the shared null
    singleton; exports are empty.  Never counts, never locks."""

    enabled = False

    def counter(self, name: str, **labels) -> _NullInstrument:
        return NULL

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return NULL

    def histogram(self, name: str, **labels) -> _NullInstrument:
        return NULL

    def timer(self, name: str, **labels) -> _NullInstrument:
        return NULL

    def instruments(self):
        return []

    def snapshot(self) -> Dict[str, object]:
        return {}

    def format_summary(self, prefix: Optional[str] = None) -> str:
        return "(obs disabled)"

    def exposition(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()

_GLOBAL = Registry()
#: tri-state programmatic override: None = follow the environment.
_FORCED: Optional[bool] = None


def obs_enabled() -> bool:
    """True when the global registry/recorder should be live: forced via
    :func:`configure`, ``MPIT_OBS`` truthy, ``MPIT_OBS_TRACE`` set (a
    trace request implies spans, which imply metrics),
    ``MPIT_OBS_HTTP`` set (a live introspection endpoint serving an
    empty registry would be a lie), or ``MPIT_OBS_PROFILE`` truthy (a
    CPU-attribution request implies the spans/metrics it annotates —
    obs/profile.py; the reverse implication does not hold)."""
    if _FORCED is not None:
        return _FORCED
    if os.environ.get(ENV, "") not in ("", "0"):
        return True
    if os.environ.get(PROFILE_ENV, "") not in ("", "0"):
        return True
    return bool(os.environ.get(TRACE_ENV, "")
                or os.environ.get(HTTP_ENV, ""))


def get_registry():
    """The process-global registry when obs is enabled, else the null
    registry.  Capture at construction time — enabling obs after a
    component was built does not retrofit its instruments."""
    return _GLOBAL if obs_enabled() else NULL_REGISTRY


def registry_or_local(registry: Optional[Registry] = None) -> Registry:
    """An always-real registry: the explicit one > the enabled global >
    a fresh private ``Registry``.  For components whose counters are
    load-bearing *results* (PS servers/clients report them in result
    dicts and tests assert on them): they always count for real; global
    enablement only decides whether they join the process-wide
    exposition and trace dump."""
    if registry is not None:
        return registry
    reg = get_registry()
    return reg if reg.enabled else Registry()


def configure(enabled: Optional[bool] = None, reset: bool = False) -> None:
    """Programmatic enablement (tests, notebooks).  ``enabled=None``
    returns control to the environment; ``reset=True`` discards the
    global registry's instruments (and the span recorder — see
    :func:`mpit_tpu_torch.obs.spans.reset`, which this calls)."""
    global _FORCED, _GLOBAL
    _FORCED = enabled
    if reset:
        _GLOBAL = Registry()
        from mpit_tpu_torch.obs import clock, flight, profile, spans, statusd

        spans.reset()
        flight.reset()
        statusd.clear_providers()
        clock.reset()
        profile.reset()
