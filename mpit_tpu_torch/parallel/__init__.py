"""Mesh trainers on the one-device stand-in mesh."""

from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "MeshEASGD", "make_mesh"]
