"""Wire-protocol tags (analog of reference asyncsgd/init.lua:3-10).

A copy of the first eight tags of ``mpit_tpu/ps/tags.py``, the ones the
unframed wire uses; the tags of fault tolerance, shard control, cells and
aggregation come with their slices.  The port imports nothing of the JAX
package.

Eight channels, renamed by direction and purpose rather than the
reference's server-perspective naming.  0-byte messages serve as the
rendezvous conventions the reference relies on: PARAM_REQ is the "header"
a client sends to request a shard read (reference pclient.lua:74-75 ->
pserver.lua:100-101); *_ACK are the "tail" completion acks after writes
(reference pserver.lua:85-86, pclient.lua:55-56)."""

INIT = 1  # client -> server: int64 shard announcement, by payload length:
#           v1 (16 B) [offset, size] = codec 'none';
#           v2 (24 B) [offset, size, codec_id].
#           v3-v5 (fault tolerance, shard control, chunked streaming) are
#           refused by this port's server until their slices land.
GRAD = 2  # client -> server: gradient/delta frame for the shard, in the
#           negotiated codec's wire format (raw dtype bytes for 'none')
GRAD_ACK = 3  # server -> client: 0-byte ack after the update is applied
PARAM_REQ = 4  # client -> server: 0-byte request-to-read header
PARAM = 5  # server -> client: current shard snapshot frame (negotiated codec)
PARAM_PUSH = 6  # client -> server: whole-shard parameter write frame
PARAM_PUSH_ACK = 7  # server -> client: 0-byte ack after the write lands
STOP = 8  # client -> server: 0-byte graceful-shutdown signal

EMPTY = b""  # the canonical 0-byte payload
