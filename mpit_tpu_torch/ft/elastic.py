"""Elastic-gang primitives — preemption notices and the scale mailbox.

A copy of ``mpit_tpu/ft/elastic.py``: the port imports nothing of the JAX
package.

Two small, deliberately dumb pieces that let gang membership change
without restarting the world (ROADMAP item 4; the PS-task-model
dynamic-group regime of MXNET-MPI, PAPERS.md 1801.03855):

- :class:`PreemptionNotice` — the SIGTERM-with-grace contract.  A spot
  VM's preemption arrives as SIGTERM with a bounded grace window; the
  installed handler does the **only two things a signal handler may do
  here** (machine-checked: mtlint MT-P204): set plain attributes and
  optionally write one byte to a wake pipe.  Everything interesting —
  timestamping the notice, checkpoint-on-notice, telling the controller
  — happens on the observing thread's next poll, never inside the
  handler, because the handler can interrupt arbitrary bytecode (a held
  lock, a half-built frame, malloc).
- :class:`ElasticDirectory` — the controller↔supervisor mailbox.  The
  controller is a gang *child*; the only party that can create a new
  rank process is the supervisor (its parent).  Rather than invent a
  control socket, scale requests travel as files in a directory both
  sides already share through the environment (``MPIT_ELASTIC_DIR``):
  the controller drops ``spawn_<rank>.json``, the supervision loop
  consumes it and ``spawn_rank``s; a completed retirement drops
  ``retired_<rank>`` so the supervisor removes the rank from its
  restart budget (a retired rank's exit is a goodbye, not a crash to
  respawn).  Writes are atomic (tmp + rename), reads are
  consume-once, and a missing directory degrades to "elasticity off" —
  in-process test gangs drive the controller's scale methods directly
  and never touch the filesystem.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
from typing import Dict, List, Optional

ENV_DIR = "MPIT_ELASTIC_DIR"
ENV_GRACE_S = "MPIT_ELASTIC_GRACE_S"

#: default preemption grace window (seconds) when the environment
#: announces a notice should be honored but does not say how long.
DEFAULT_GRACE_S = 5.0


class PreemptionNotice:
    """SIGTERM-with-grace, observed — never acted on — in the handler.

    The handler sets ``_notified`` (and pokes ``wake_fd`` when given)
    and returns; :meth:`poll` is what the serving loop calls between
    scheduler passes — the *first* poll that sees the flag stamps
    ``noticed_at`` (monotonic) so the grace arithmetic runs on ordinary
    thread time, outside the handler (MT-P204: handlers only set flags
    / write a pipe).
    """

    def __init__(self, grace_s: float = DEFAULT_GRACE_S,
                 wake_fd: int = -1):
        self.grace_s = float(grace_s)
        self._wake_fd = int(wake_fd)
        self._notified = False
        self.noticed_at: Optional[float] = None
        self._prev_handler = None
        self._installed = False

    # -- the signal handler (MT-P204: flags + pipe writes only) -------------

    def _on_sigterm(self, signum, frame) -> None:
        self._notified = True
        if self._wake_fd >= 0:
            os.write(self._wake_fd, b"\x01")

    # -- main-thread API -----------------------------------------------------

    def install(self) -> "PreemptionNotice":
        """Install the SIGTERM handler (main thread only — the signal
        module's own constraint).  Keeps the previous disposition for
        :meth:`restore`."""
        self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._installed = True
        return self

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._installed = False

    @property
    def notified(self) -> bool:
        return self._notified

    def poll(self) -> bool:
        """Observe the flag from an ordinary thread; the first observing
        poll stamps ``noticed_at``.  Returns the flag."""
        if self._notified and self.noticed_at is None:
            import time

            self.noticed_at = time.monotonic()
        return self._notified

    def grace_remaining_s(self) -> float:
        """Seconds of grace left (``grace_s`` until first observed)."""
        if not self.poll():
            return self.grace_s
        import time

        return max(0.0, self.grace_s - (time.monotonic() - self.noticed_at))

    @property
    def grace_ms(self) -> int:
        """The wire form of the announced window (PREEMPT directive)."""
        return int(self.grace_s * 1000)

    @classmethod
    def from_env(cls, default_grace_s: float = DEFAULT_GRACE_S
                 ) -> "PreemptionNotice":
        return cls(grace_s=float(
            os.environ.get(ENV_GRACE_S, default_grace_s)))


class ElasticDirectory:
    """The file mailbox between a gang's controller and its supervisor.

    Protocol (all files under one directory):

    - ``spawn_<rank>.json`` — controller asks for a new rank process;
      the JSON body is the extra env the child should get (may be
      ``{}``).  The supervisor consumes (unlinks) the file when it
      spawns.
    - ``retired_<rank>`` — the rank completed the RETIRE handshake; its
      exit must leave the restart budget (consume-on-read is *not* used
      here — retirement is permanent for the run, so the marker stays).
    """

    def __init__(self, root: "str | os.PathLike"):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- controller side -----------------------------------------------------

    def request_spawn(self, rank: int,
                      extra_env: Optional[Dict[str, str]] = None) -> None:
        tmp = self.root / f".spawn_{rank}.json.tmp"
        tmp.write_text(json.dumps(extra_env or {}))
        os.replace(tmp, self.root / f"spawn_{rank}.json")

    def mark_retired(self, rank: int) -> None:
        (self.root / f"retired_{rank}").touch()

    # -- supervisor side -----------------------------------------------------

    def consume_spawns(self) -> List[tuple]:
        """[(rank, extra_env)] for every pending spawn request, each
        consumed exactly once."""
        out = []
        for path in sorted(self.root.glob("spawn_*.json")):
            try:
                rank = int(path.stem.split("_", 1)[1])
                env = json.loads(path.read_text())
            except (ValueError, json.JSONDecodeError):
                continue  # half-written alien file; atomic writers never
            path.unlink(missing_ok=True)
            out.append((rank, env))
        return out

    def retired(self) -> List[int]:
        out = []
        for path in self.root.glob("retired_*"):
            try:
                out.append(int(path.name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    @classmethod
    def from_env(cls) -> "Optional[ElasticDirectory]":
        root = os.environ.get(ENV_DIR, "")
        return cls(root) if root else None
