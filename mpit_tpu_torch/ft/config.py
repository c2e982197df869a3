"""FT configuration — one knob set shared by clients, servers, launchers.

A copy of ``mpit_tpu/ft/config.py``: the port imports nothing of the JAX
package.

Everything defaults to *off*: a default-constructed ``FTConfig`` makes
``ParamClient``/``ParamServer`` behave byte-for-byte like the pre-FT
protocol (legacy INIT, headerless zero-copy frames, unbounded waits), so
existing deployments and the codec-throughput records are untouched.
Each feature is enabled by its own knob because they cost differently:

- ``heartbeat_s`` / ``lease_ttl_s`` — liveness.  Cheap (one 16-byte
  message per interval); safe to run everywhere.
- ``op_deadline_s`` — deadlines + retry + FT frame headers.  Adds one
  staging copy per identity-codec frame, so the bandwidth-record path
  leaves it off and the churn-tolerant path turns it on.
- ``rejoin`` — the server keeps an INIT listener per client so a
  restarted incarnation can re-announce mid-run (implied by a lease TTL:
  eviction without rejoin would leak the rank forever).

Env mirrors (``FTConfig.from_env``) let process-gang children inherit
the gang's FT posture without threading it through every entry point.

The port keeps every field and env name of the JAX package's config, and
refuses the one whose layer comes with a later slice: ``chunk_bytes``
(chunked streaming rides ``comm/pool``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

#: What each refused field belongs to.
LATER_FIELDS = {
    "chunk_bytes": "chunked streaming (FLAG_CHUNKED, INIT v5; slice 5f, "
                   "streaming with comm/pool)",
}


@dataclass(frozen=True)
class FTConfig:
    #: client: seconds between HEARTBEAT beacons to each server (0 = off).
    heartbeat_s: float = 0.0
    #: server: seconds without a heartbeat before a client's lease
    #: expires and it is evicted (0 = leases off).
    lease_ttl_s: float = 0.0
    #: client: per-attempt deadline for every PS op (0 = unbounded, no
    #: retry, no frame headers).
    op_deadline_s: float = 0.0
    #: client: resend attempts after the first before failing loudly.
    max_retries: int = 8
    #: client: retry backoff: min(base * 2**attempt, cap) + jitter.
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    #: client incarnation number carried in INIT v3 and every framed
    #: header; a supervisor restart announces epoch + 1.
    epoch: int = 0
    #: server: accept a re-INIT from a restarted client incarnation.
    rejoin: bool = False
    #: client: announce FLAG_STALENESS — frames carry the 24-byte
    #: [epoch, seq, version] header so the server can measure gradient
    #: staleness (mpit_ps_grad_staleness).  Requires framing
    #: (op_deadline_s > 0); silently inactive otherwise, and negotiated
    #: off per pair for legacy peers exactly like framing itself.
    staleness: bool = False
    #: client: announce FLAG_TIMING — frames carry a send stamp and every
    #: ack/reply a [t_tx_echo, t_recv, t_ack] tail, feeding the per-peer
    #: clock-offset estimator and the causal latency decomposition
    #: (obs/clock.py, obs/causal.py; PROTOCOL.md §6.7).  Requires
    #: framing; silently inactive otherwise, negotiated off per pair for
    #: legacy peers exactly like staleness.
    timing: bool = False
    #: client: announce FLAG_CHUNKED — ship each GRAD / PARAM /
    #: PARAM_PUSH body as a pipelined stream of ~this-many-byte chunk
    #: frames (block-aligned; ft/wire.py chunk_elems_for) so encode,
    #: wire and apply overlap on the transfer-bound hot path
    #: (PROTOCOL.md §12).  Requires framing (retry resends missing
    #: chunks; dedup is per (op, chunk)); 0 keeps whole-frame transfers.
    chunk_bytes: int = 0

    def __post_init__(self) -> None:
        if self.chunk_bytes:
            raise NotImplementedError(
                f"FTConfig(chunk_bytes={self.chunk_bytes}): "
                f"{LATER_FIELDS['chunk_bytes']} of the port")

    @property
    def active(self) -> bool:
        """Any FT feature on => the client announces INIT v3."""
        return (self.heartbeat_s > 0 or self.op_deadline_s > 0
                or self.lease_ttl_s > 0 or self.rejoin or self.epoch > 0)

    @property
    def framed(self) -> bool:
        """Deadlines+retry need at-most-once identity => frame headers."""
        return self.op_deadline_s > 0

    @property
    def stale_track(self) -> bool:
        """Staleness telemetry is live: framed + requested."""
        return self.framed and self.staleness

    @property
    def timing_track(self) -> bool:
        """Causal-timing telemetry is live: framed + requested."""
        return self.framed and self.timing

    @property
    def chunked(self) -> bool:
        """Pipelined streaming transfers are live: framed + a chunk
        size.  Chunking IS the retry machinery restructured — without
        deadlines there is no per-chunk resend path to ride."""
        return self.framed and self.chunk_bytes > 0

    @property
    def server_rejoin(self) -> bool:
        return self.rejoin or self.lease_ttl_s > 0

    @property
    def deadline_s(self) -> "float | None":
        return self.op_deadline_s if self.op_deadline_s > 0 else None

    @classmethod
    def from_env(cls, **overrides) -> "FTConfig":
        """FTConfig from MPIT_FT_* env vars; kwargs override env."""
        def _f(name: str, default: float) -> float:
            return float(os.environ.get(name, default))

        fields = dict(
            heartbeat_s=_f("MPIT_FT_HEARTBEAT_S", 0.0),
            lease_ttl_s=_f("MPIT_FT_LEASE_TTL_S", 0.0),
            op_deadline_s=_f("MPIT_FT_OP_DEADLINE_S", 0.0),
            max_retries=int(_f("MPIT_FT_MAX_RETRIES", 8)),
            backoff_base_s=_f("MPIT_FT_BACKOFF_BASE_S", 0.05),
            backoff_cap_s=_f("MPIT_FT_BACKOFF_CAP_S", 2.0),
            epoch=int(_f("MPIT_FT_EPOCH", 0)),
            rejoin=os.environ.get("MPIT_FT_REJOIN", "0") not in ("0", ""),
            staleness=os.environ.get("MPIT_FT_STALENESS", "0")
            not in ("0", ""),
            timing=os.environ.get("MPIT_FT_TIMING", "0") not in ("0", ""),
            chunk_bytes=int(_f("MPIT_FT_CHUNK_BYTES", 0)),
        )
        fields.update(overrides)
        return cls(**fields)
