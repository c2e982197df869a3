"""Per-cell SLO autoscaling — the gang autoscaler's loop pointed at the
serving fabric.  The port of ``mpit_tpu/cells/autoscale.py``, over the
port's own ``shardctl/autoscale.py`` and ``obs``.

The gang autoscaler's policy engine (:class:`~mpit_tpu_torch.shardctl.autoscale.
AutoscalePolicy`) is reused *unchanged*: hysteresis bands, debounce,
cooldown, flap budget and operator precedence are properties of the
decision function, not of what it scales.  What changes is the binding:

- **signals** — the window's ``p99_ms`` is the p99 of read ops served
  *by cell ranks only* (the fleet's serving latency, not the training
  gang's GRAD path), ``busy_ratio`` is the cells' admission+lag-shed
  rejection ratio, and the ``staleness`` slot carries the fleet's
  **max cell lag in committed versions** — cell lag literally is
  staleness, so the policy's existing band arithmetic applies verbatim
  (a lag target of 4 with ``high_frac=1`` breaches at >4).
- **verbs** — ``add_cell`` / ``drain_cell`` callables supplied by the
  harness (spawn a follower + tell readers, or
  :meth:`~mpit_tpu_torch.cells.cell.ServingCell.retire_serving` toward a
  sibling so readers follow the GOODBYE).  Executed verbs are audited,
  counted on the ``mpit_autoscale_*`` instruments, and dumped as
  ``autoscale_up`` / ``autoscale_down`` flight postmortems with the
  decision + window — the same shapes ``validate_dump`` enforces for
  the gang autoscaler.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from mpit_tpu_torch.obs import get_flight, registry_or_local
from mpit_tpu_torch.obs import metrics as _obsmetrics
from mpit_tpu_torch.obs import top as _top
from mpit_tpu_torch.shardctl.autoscale import (
    HOLD,
    UP,
    AutoscaleConfig,
    AutoscalePolicy,
    Decision,
    SLOConfig,
    TelemetryWindow,
)
from mpit_tpu_torch.utils.logging import get_logger


@dataclass(frozen=True)
class CellSLO:
    """The fleet's objectives: read p99 and the lag bound readers
    should rarely see enforced.  ``to_slo`` maps onto the policy's
    existing signal slots (lag rides ``staleness`` — same unit, same
    semantics: committed versions behind)."""

    p99_ms: float = 0.0
    max_lag: float = 0.0
    busy_ratio: float = 0.0

    def to_slo(self) -> SLOConfig:
        return SLOConfig(p99_ms=self.p99_ms, staleness=self.max_lag,
                         busy_ratio=self.busy_ratio)


def _cell_samples(samples: list, cell_ranks: "set") -> list:
    """Restrict one parse_exposition sample list to cell-rank rows, so
    the pooled quantile describes the serving fleet, not the gang."""
    out = []
    for name, labels, value in samples:
        try:
            rank = int(labels.get("rank", "-1"))
        except ValueError:
            continue
        if rank in cell_ranks:
            out.append((name, labels, value))
    return out


def cell_window(t: float, cur: list, prev: Optional[list],
                cell_ranks: "List[int]") -> TelemetryWindow:
    """Fold a pooled exposition sample into the fleet's window: cell
    read p99 (bucket deltas — the window, not the run), rejection
    ratio, and max cell lag on the staleness slot."""
    cells = set(int(c) for c in cell_ranks)
    cur_c = _cell_samples(cur, cells)
    prev_c = _cell_samples(prev, cells) if prev is not None else None

    def _delta(name: str) -> float:
        cur_v = _top.metric_sum(cur_c, name)
        if prev_c is None:
            return cur_v
        return max(0.0, cur_v - _top.metric_sum(prev_c, name))

    if prev_c is not None:
        p99_s = _top.hist_quantile_between(prev_c, cur_c,
                                           "mpit_ps_op_seconds", 0.99)
    else:
        p99_s = _top.hist_quantile(cur_c, "mpit_ps_op_seconds", 0.99)
    served = _delta("mpit_ps_params_served_total")
    busy = _delta("mpit_ps_busy_replies_total")
    lag = max((value for name, _labels, value in cur_c
               if name == "mpit_cell_lag"), default=0.0)
    return TelemetryWindow(
        t=t,
        p99_ms=(p99_s * 1000.0 if p99_s is not None else None),
        busy_ratio=(busy / (busy + served) if (busy + served) > 0 else 0.0),
        staleness=lag,
        ops=served,
        gang_size=len(cells),
    )


class CellAutoscaler:
    """Bind the reused policy to a cell fleet: sample the registry on
    the pump cadence, decide, execute the supplied verbs, audit
    everything (holds included)."""

    def __init__(
        self,
        cfg: AutoscaleConfig,
        add_cell: Callable[[], bool],
        drain_cell: Callable[[], bool],
        live_cells: Callable[[], List[int]],
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.policy = AutoscalePolicy(cfg)
        self._add = add_cell
        self._drain = drain_cell
        self._live = live_cells
        self._registry = registry
        self._clock = clock
        self._prev: Optional[list] = None
        self._last_t: float = -1e18
        self.audit: List[Dict[str, object]] = []
        self.log = get_logger("cellscale", 0)
        self._flight = get_flight()
        m = registry_or_local()
        self._m_dec = {
            a: m.counter("mpit_autoscale_decisions_total", action=a,
                         scope="cells")
            for a in ("up", "down", "hold")
        }

    # -- sampling ------------------------------------------------------------

    def _sample(self) -> list:
        reg = self._registry
        if reg is None:
            reg = _obsmetrics.get_registry()
        return _top.parse_exposition(reg.exposition())

    def note_operator(self) -> None:
        self.policy.note_override(self._clock())

    # -- the loop ------------------------------------------------------------

    def pump(self) -> Optional[Decision]:
        """One autoscale step (call from the harness's control loop):
        returns the Decision when a window elapsed, None when it is not
        yet time to sample."""
        now = self._clock()
        if now - self._last_t < self.cfg.window_s:
            return None
        self._last_t = now
        cur = self._sample()
        cells = self._live()
        window = cell_window(now, cur, self._prev, cells)
        self._prev = cur
        decision = self.policy.decide(window, gang_size=len(cells))
        executed = False
        error: Optional[str] = None
        if decision.action != HOLD:
            verb = self._add if decision.action == UP else self._drain
            try:
                executed = bool(verb())
            except Exception as exc:  # audited, never fatal (§9.7)
                error = repr(exc)
                self.log.warning("cell scale %s failed: %r",
                                 decision.action, exc)
            if executed:
                self.policy.note_executed(decision)
                self._flight.record(f"autoscale_{decision.action}",
                                    scope="cells",
                                    reason=decision.reason)
                self._flight.dump(
                    f"autoscale_{decision.action}",
                    decision=decision.to_dict(),
                    window=(decision.window.to_dict()
                            if decision.window else None),
                    scope="cells")
        self._m_dec[decision.action].inc()
        self.audit.append({
            **decision.to_dict(),
            "executed": executed,
            "error": error,
            "cells": list(cells),
        })
        return decision
