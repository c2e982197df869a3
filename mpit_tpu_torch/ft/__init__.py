"""mpit_tpu_torch.ft — fault tolerance for the parameter-server gang.

The port of ``mpit_tpu/ft/``: its modules are host code, copied, and the
port imports nothing of the JAX package.

The EASGD/DOWNPOUR family's premise is loose coupling, but the pre-FT
protocol was tightly coupled to every member's health: a hung client
wedged its server's recv loops forever, a dropped message stalled the
op pump, and a killed rank could never come back.  This package makes
worker churn a handled event, in four pieces threaded through the
existing layers:

- **liveness** — HEARTBEAT beacons (ps/tags.py) into a server-side
  :class:`LeaseRegistry`; expiry evicts the client (services unblock,
  stop protocol completes without it) instead of waiting forever.
- **deadlines + retry** — every PS op can carry a deadline
  (aio/scheduler.py timers); timeouts resend the staged frame under a
  :class:`RetryPolicy` (capped exponential backoff, deterministic
  jitter), and the server's :class:`DedupTable` admits each framed op
  at most once on ``(client, epoch, seq)`` (ft/wire.py).
- **checkpoint / rejoin** — stamped atomic server snapshots carry the
  dedup table; a restarted rank re-announces via INIT v3 with a bumped
  epoch and resumes mid-run (ft/supervisor.py restarts dead ranks).
- **fault injection** — :class:`FaultyTransport` forces drop / delay /
  dup / sever deterministically (ft/faults.py), so every recovery path
  above is exercised by replayable tier-1 tests.
"""

from mpit_tpu_torch.ft.config import FTConfig
from mpit_tpu_torch.ft.dedup import DUP, FRESH, STALE, DedupTable
from mpit_tpu_torch.ft.elastic import ElasticDirectory, PreemptionNotice
from mpit_tpu_torch.ft.faults import (
    FaultPlan,
    FaultyTransport,
    LinkClock,
    PacedTransport,
    inject_preemption,
)
from mpit_tpu_torch.ft.leases import (
    ACTIVE,
    EVICTED,
    RETIRED,
    STOPPED,
    LeaseRegistry,
)
from mpit_tpu_torch.ft.retry import RetryExhausted, RetryPolicy
from mpit_tpu_torch.ft.traffic import Scenario, TrafficEvent, TrafficPhase
from mpit_tpu_torch.ft.wire import (
    ACK_TIMING_WORDS,
    CHUNK_ACK_TIMING_WORDS,
    CHUNK_ACK_WORDS,
    CHUNK_HDR_BYTES,
    CHUNK_REPLY_WORDS,
    FLAG_CHUNKED,
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_READONLY,
    FLAG_SUBSCRIBE,
    FLAG_STALENESS,
    FLAG_TIMING,
    HDR_BYTES,
    HDR_STALE_BYTES,
    TIMING_TAIL_BYTES,
    chunk_ack_frame,
    chunk_elems_for,
    chunk_hdr_bytes,
    chunk_reply_hdr_bytes,
    chunk_spans,
    chunk_stride,
    hdr_bytes,
    header_frame,
    init_v3,
    init_v5,
    pack_chunk_header,
    pack_chunk_reply,
    pack_header,
    pack_reply_stamps,
    pack_tx_stamp,
    pack_version,
    reply_hdr_bytes,
    timed_frame,
    unpack_chunk_header,
    unpack_chunk_reply,
    unpack_header,
    unpack_reply_stamps,
    unpack_tx_stamp,
    unpack_version,
)

__all__ = [
    "FTConfig",
    "DedupTable", "FRESH", "DUP", "STALE",
    "FaultPlan", "FaultyTransport", "PacedTransport", "inject_preemption",
    "PreemptionNotice", "ElasticDirectory",
    "LeaseRegistry", "ACTIVE", "EVICTED", "STOPPED", "RETIRED",
    "RetryPolicy", "RetryExhausted",
    "Scenario", "TrafficPhase", "TrafficEvent",
    "HDR_BYTES", "HDR_STALE_BYTES",
    "FLAG_FRAMED", "FLAG_HEARTBEAT", "FLAG_READONLY", "FLAG_STALENESS",
    "FLAG_SUBSCRIBE", "FLAG_TIMING", "FLAG_CHUNKED",
    "CHUNK_HDR_BYTES", "CHUNK_ACK_WORDS", "CHUNK_ACK_TIMING_WORDS",
    "CHUNK_REPLY_WORDS",
    "chunk_elems_for", "chunk_spans", "chunk_stride", "chunk_hdr_bytes",
    "chunk_reply_hdr_bytes", "pack_chunk_header", "unpack_chunk_header",
    "pack_chunk_reply", "unpack_chunk_reply", "chunk_ack_frame",
    "init_v5",
    "ACK_TIMING_WORDS", "TIMING_TAIL_BYTES",
    "hdr_bytes", "reply_hdr_bytes",
    "pack_header", "unpack_header", "header_frame", "timed_frame",
    "init_v3", "pack_version", "unpack_version",
    "pack_tx_stamp", "unpack_tx_stamp",
    "pack_reply_stamps", "unpack_reply_stamps",
]
