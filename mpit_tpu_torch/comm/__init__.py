"""Host transports and wire codecs of the parameter server."""

from mpit_tpu_torch.comm.local import LocalRouter, LocalTransport
from mpit_tpu_torch.comm.transport import Handle, Transport

__all__ = ["Handle", "LocalRouter", "LocalTransport", "Transport"]
