"""Mesh trainers (EASGD, sync data parallel) on the one-device stand-in mesh."""

from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import Mesh, make_mesh
from mpit_tpu_torch.parallel.sync_dp import SyncDataParallel

__all__ = ["Mesh", "MeshEASGD", "SyncDataParallel", "make_mesh"]
