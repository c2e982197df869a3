"""Wire-protocol tags (analog of reference asyncsgd/init.lua:3-10).

A copy of the tags of ``mpit_tpu/ps/tags.py`` that the port speaks: the
eight of the unframed wire, the fault-tolerance beacon (9) and the causal
timing echo (13).  The tags of shard control (10-12), cells (14-15) and
aggregation (16-17) come with their slices.  The port imports nothing of the JAX
package.

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
#           v4 (shard control) and v5 (chunked streaming) are refused by
#           this port's server until their slices land.
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
#                expiry.
HEARTBEAT_ECHO = 13  # server -> client: int64 [epoch, seq, t_tx_echo,
#                      t_recv, t_ack] — the FLAG_TIMING reply to a timed
#                      HEARTBEAT beacon.  Not an ack: heartbeats stay
#                      fire-and-forget, and the client drains echoes
#                      opportunistically (iprobe in ping/wait) to refresh
#                      its clock-offset estimator; a lost echo costs
#                      nothing.

EMPTY = b""  # the canonical 0-byte payload
