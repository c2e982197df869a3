"""L2 — the asynchronous parameter server: server, client, tags, shard cut."""

from mpit_tpu_torch.ps.client import ParamClient
from mpit_tpu_torch.ps.server import ParamServer
from mpit_tpu_torch.ps.sharding import Shard, shard_layout

__all__ = ["ParamClient", "ParamServer", "Shard", "shard_layout"]
