"""Wire-protocol tags (analog of reference asyncsgd/init.lua:3-10).

A copy of the tags of ``mpit_tpu/ps/tags.py`` that the port speaks: the
eight of the unframed wire, the fault-tolerance beacon (9), shard control's
directives and handoff (10-12), the causal timing echo (13), the serving
cells' diff stream (14-15) and the hierarchical aggregation tree's hops
(16-17).  The port imports nothing of the JAX package.

Eight channels, renamed by direction and purpose rather than the
reference's server-perspective naming.  0-byte messages serve as the
rendezvous conventions the reference relies on: PARAM_REQ is the "header"
a client sends to request a shard read (reference pclient.lua:74-75 ->
pserver.lua:100-101); *_ACK are the "tail" completion acks after writes
(reference pserver.lua:85-86, pclient.lua:55-56)."""

INIT = 1  # client -> server: int64 shard announcement.  Three wire
#           generations, distinguished by payload length:
#           v1 (16 B) [offset, size] = codec 'none', no fault tolerance;
#           v2 (24 B) [offset, size, codec_id];
#           v3 (40 B) [offset, size, codec_id, epoch, flags] — epoch is
#           the client incarnation number (bumped on restart/rejoin) and
#           flags bit0 enables FT frame headers (mpit_tpu_torch/ft/wire.py).
#           v4 (shard control) is [-1, codec_id, epoch, flags, <map>]
#           (mpit_tpu_torch/shardctl/wire.py); v5 (chunked streaming) is
#           refused by this port's server until its slice lands.
GRAD = 2  # client -> server: gradient/delta frame for the shard, in the
#           negotiated codec's wire format (raw dtype bytes for 'none');
#           FT-framed clients prepend an int64 [epoch, seq] header
GRAD_ACK = 3  # server -> client: ack after the update is applied — 0-byte
#               legacy, int64 [epoch, seq] echo for FT-framed clients
PARAM_REQ = 4  # client -> server: request-to-read header — 0-byte legacy,
#                int64 [epoch, seq] for FT-framed clients
PARAM = 5  # server -> client: current shard snapshot frame (negotiated
#            codec); FT-framed replies echo the request's [epoch, seq]
PARAM_PUSH = 6  # client -> server: whole-shard parameter write frame
#                 (FT-framed clients prepend [epoch, seq])
PARAM_PUSH_ACK = 7  # server -> client: ack after the write lands — 0-byte
#                     legacy, [epoch, seq] echo for FT-framed clients
STOP = 8  # client -> server: 0-byte graceful-shutdown signal
HEARTBEAT = 9  # client -> server: int64 [epoch, seq] liveness beacon; the
#                server's lease registry (mpit_tpu_torch/ft/leases.py)
#                renews the client's lease on every beat and evicts on
#                expiry.  Under shard control, servers also beat to the
#                controller with a per-shard load report appended.
MAP_UPDATE = 10  # controller -> server/client (and server -> controller
#                  as the DONE echo): a shard-map directive
#                  [kind, shard_id, peer] + serialized ShardMap
#                  (mpit_tpu_torch/shardctl/wire.py)
SHARD_PULL = 11  # server(dst) -> server(src): int64 [shard_id] — "I was
#                  directed to acquire this shard; send its state"
SHARD_STATE = 12  # server(src) -> server(dst): the frozen shard's full
#                   state (meta json + param bytes + rule-state arrays),
#                   a multi-message sequence on this one FIFO channel
HEARTBEAT_ECHO = 13  # server -> client: int64 [epoch, seq, t_tx_echo,
#                      t_recv, t_ack] — the FLAG_TIMING reply to a timed
#                      HEARTBEAT beacon.  Not an ack: heartbeats stay
#                      fire-and-forget, and the client drains echoes
#                      opportunistically (iprobe in ping/wait) to refresh
#                      its clock-offset estimator; a lost echo costs
#                      nothing.  Subscriber (FLAG_SUBSCRIBE) beats get the
#                      3-word [epoch, seq, head_version] form instead — the
#                      head announcement a replica cell's staleness
#                      admission keys on.
DIFF = 14  # server -> cell: one snapshot-diff frame of the committed
#            version stream: int64 [kind, from_version, to_version,
#            head_version, body_nbytes] then the body bytes in the SAME
#            message (message-atomic under fault injection).  kind FULL
#            carries the whole encoded snapshot frame at to_version
#            (attach/resync); kind DELTA carries the XOR of the to/from
#            encoded frames — the cell reconstructs to_version's frame
#            bit-exactly from its installed from_version copy.
DIFF_REQ = 15  # cell -> server: int64 [epoch, seq, have_version] — the
#                resync request, sent when the diff chain broke (a dropped
#                DELTA: from_version != the installed version) or the cell
#                fell beyond its resync horizon; the server answers with a
#                FULL frame at the current head.
REDUCE = 16  # client -> client: one partial-gradient chunk frame of the
#              hierarchical aggregation tree: int64 [epoch, seq,
#              chunk_idx, chunk_count, nfold] then the chunk's codec
#              frame, padded to the uniform stride.  ``nfold`` is the
#              number of leaf contributions already folded into the
#              partial; the receiving interior node folds the decoded
#              chunk into its own partial sum in fixed child-rank order
#              and forwards chunk k upstream while chunk k+1 is still
#              arriving.
REDUCE_ACK = 17  # client -> client: int64 [epoch, seq, chunk_idx, status]
#                  — per-admitted-chunk ack on the REDUCE hop.  status OK
#                  means received (retries resend only unacked chunks);
#                  status LATE means the round already folded without
#                  this sender (straggler deadline fired) — the sender
#                  falls back to a direct GRAD push of its partial, so a
#                  late contribution is counted and re-routed, never
#                  silently dropped and never double-folded.

EMPTY = b""  # the canonical 0-byte payload

# Protocol pairing table: every tag above names its sender and receiver
# roles (the JAX package's rows for the tags the port speaks).
TAG_PAIRS = {
    "INIT": ("client", "server"),
    "GRAD": ("client", "server"),
    "GRAD_ACK": ("server", "client"),
    "PARAM_REQ": ("client", "server"),
    "PARAM": ("server", "client"),
    "PARAM_PUSH": ("client", "server"),
    "PARAM_PUSH_ACK": ("server", "client"),
    "STOP": ("client", "server|controller"),
    "HEARTBEAT": ("client|server", "server|controller"),
    "MAP_UPDATE": ("controller|server", "server|client|controller"),
    "SHARD_PULL": ("server", "server"),
    "SHARD_STATE": ("server", "server"),
    "HEARTBEAT_ECHO": ("server", "client"),
    # The serving cells' diff stream: a replica cell attaches to its
    # upstream server like a client (SUBSCRIBE posture on INIT) but is its
    # own role.
    "DIFF": ("server", "cell"),
    "DIFF_REQ": ("cell", "server"),
    # The aggregation tree's hops travel client <-> client, outside the
    # client <-> server role model, like the server <-> server handoff.
    "REDUCE": ("client", "client"),
    "REDUCE_ACK": ("client", "client"),
}
