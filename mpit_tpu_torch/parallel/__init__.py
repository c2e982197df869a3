"""The one-card stand-in mesh: its collectives, the mesh trainers (EASGD,
sync data parallel) and sequence-parallel ring attention."""

from mpit_tpu_torch.parallel.collective import (
    allreduce_mean,
    ps_pull,
    ps_push,
    ps_pushpull,
    ring_shift,
)
from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import Mesh, make_mesh
from mpit_tpu_torch.parallel.ring_attention import (
    ring_attention,
    sp_mesh,
    zigzag_permute,
    zigzag_unpermute,
)
from mpit_tpu_torch.parallel.sync_dp import SyncDataParallel

__all__ = ["Mesh", "MeshEASGD", "SyncDataParallel", "allreduce_mean", "make_mesh",
           "ps_pull", "ps_push", "ps_pushpull", "ring_attention", "ring_shift",
           "sp_mesh", "zigzag_permute", "zigzag_unpermute"]
