"""L2 — the asynchronous parameter server: server, client, the read-only
serving tier's reader, tags, shard cut."""

from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.ps.client import ParamClient
from mpit_tpu_torch.ps.serve import ReaderClient, ServeConfig
from mpit_tpu_torch.ps.server import ParamServer
from mpit_tpu_torch.ps.sharding import Shard, shard_layout

__all__ = ["ParamClient", "ParamServer", "ReaderClient", "ServeConfig", "Shard",
           "shard_layout", "tags"]
