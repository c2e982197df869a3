"""The port's meshes (virtual ranks on each process's device, ``dp`` cut
across a process group): their collectives, the mesh trainers (EASGD, sync
data parallel), sequence-parallel ring attention, tensor, pipeline and
expert parallelism over virtual ranks, and the multi-host bootstrap."""

from mpit_tpu_torch.parallel.collective import (
    allreduce_mean,
    gather,
    process_mean,
    ps_pull,
    ps_push,
    ps_pushpull,
    psum,
    ring_shift,
)
from mpit_tpu_torch.parallel.distributed import (
    ProcessGroup,
    barrier,
    bootstrap,
    read_hostfile,
)
from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    process_local_rows,
    put_global,
    put_local,
)
from mpit_tpu_torch.parallel.moe import ep_moe, moe_reference
from mpit_tpu_torch.parallel.pipeline import pipeline, stack_stage_params
from mpit_tpu_torch.parallel.ring_attention import (
    ring_attention,
    sp_mesh,
    zigzag_permute,
    zigzag_unpermute,
)
from mpit_tpu_torch.parallel.sync_dp import SyncDataParallel
from mpit_tpu_torch.parallel.tensor_parallel import tp_mlp, tp_self_attention

__all__ = ["Mesh", "MeshEASGD", "ProcessGroup", "SyncDataParallel", "allreduce_mean",
           "barrier", "bootstrap", "ep_moe", "gather", "make_mesh", "moe_reference",
           "pipeline", "process_local_rows", "process_mean", "ps_pull", "ps_push",
           "ps_pushpull", "psum", "put_global", "put_local", "read_hostfile",
           "ring_attention", "ring_shift", "sp_mesh", "stack_stage_params", "tp_mlp",
           "tp_self_attention", "zigzag_permute", "zigzag_unpermute"]
