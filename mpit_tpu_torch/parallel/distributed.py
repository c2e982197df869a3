"""Multi-host process bootstrap over ``torch.distributed`` — the port of
``mpit_tpu/parallel/distributed.py``, the mpirun/hostfile analog.

The reference scales across nodes with ``mpirun --hostfile`` (6 nodes x 16
slots), MPI assigning the ranks.  The JAX package forms the group with
``jax.distributed.initialize()``; here ``torch.distributed.
init_process_group`` does, over ``tcp://<coordinator>``:

- :func:`read_hostfile` parses the reference's ``host:slots`` format;
- :func:`bootstrap` resolves (coordinator, num_processes, process_id) in
  the JAX package's order: the arguments, then ``MPIT_COORDINATOR`` /
  ``MPIT_NUM_PROCESSES`` / ``MPIT_PROCESS_ID``, then ``MPIT_HOSTFILE`` (our
  line from ``MPIT_PROCESS_ID``), and with none of them a single process
  that forms no group.  The backend follows from the device and the host
  (:func:`choose_backend`), never from a failure: a failing NCCL never
  falls back;
- :class:`ProcessGroup` is the identity after bootstrap: the rank and
  size pair of the reference's launcher, the backend, and the devices as
  torch devices;
- :func:`barrier` waits for every process of the group (the checkpoint's
  publish).

On the card, NCCL takes one card a process and refuses two ranks on one
GPU.  Where a host runs no more of the group's processes than it has
cards, each takes its own card over NCCL; where it runs more, they share
the cards and their collectives go over gloo, which carries the card's
tensors through host buffers of its own (gloo's CUDA all-gather, the one
collective the trainers use).  ``describe()``, the launchers' logs and
their results name the backend.  Every rendezvous and collective gives
up after :data:`GROUP_TIMEOUT_S`, so a lost peer fails the run instead of
hanging it.  The JAX module's ``honor_jax_platforms`` has no counterpart.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import socket
from typing import List, Optional, Sequence, Tuple

import torch

LOOPBACK = ("localhost", "127.0.0.1", "::1")

#: Seconds a rendezvous or a collective waits for the other processes.
GROUP_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class HostEntry:
    host: str
    slots: int = 1


def read_hostfile(path: str | pathlib.Path) -> List[HostEntry]:
    """Parse ``host:slots`` lines (blank lines and ``#`` comments ignored;
    a missing ``:slots`` means 1)."""
    entries: List[HostEntry] = []
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        host, _, slots = line.partition(":")
        if not host:
            raise ValueError(f"bad hostfile line: {raw!r}")
        entries.append(HostEntry(host, int(slots) if slots else 1))
    if not entries:
        raise ValueError(f"hostfile {path} is empty")
    return entries


def coordinator_from_hostfile(entries: Sequence[HostEntry], port: int = 8476
                              ) -> Tuple[str, int]:
    """(coordinator_address, num_processes): the first host coordinates
    (mpirun's rank 0 on the first line); one process a hostfile line."""
    return f"{entries[0].host}:{port}", len(entries)


@dataclasses.dataclass(frozen=True)
class ProcessGroup:
    """Identity after bootstrap, and the devices the group drives.
    ``backend`` is ``"nccl"`` or ``"gloo"``, None where no group was
    formed."""

    process_id: int
    num_processes: int
    coordinator: Optional[str]
    device: str = "cuda"
    backend: Optional[str] = None

    @property
    def local_devices(self) -> List[torch.device]:
        """This host's devices of the group's type: its CUDA cards, or the
        CPU."""
        if self.device == "cpu":
            return [torch.device("cpu")]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    @property
    def devices(self) -> List[torch.device]:
        """Every process's devices, rank by rank (a torch device names no
        host: rank ``r``'s are the ``r``-th block)."""
        return self.local_devices * self.num_processes

    def describe(self) -> str:
        return (f"process {self.process_id}/{self.num_processes} "
                f"coordinator={self.coordinator or 'single-host'} "
                f"backend={self.backend or 'none'} "
                f"local={len(self.local_devices)} global={len(self.devices)}")


def resolve(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
            process_id: Optional[int] = None, hostfile: Optional[str] = None,
            port: int = 8476) -> Tuple[Optional[str], Optional[int], Optional[int],
                                       List[HostEntry]]:
    """The group :func:`bootstrap` would form, without forming it:
    ``(coordinator, num_processes, process_id, hostfile entries)``, each
    None where nothing sets it, with the JAX package's checks."""
    env = os.environ
    coordinator = coordinator or env.get("MPIT_COORDINATOR") or None
    if num_processes is None and "MPIT_NUM_PROCESSES" in env:
        num_processes = int(env["MPIT_NUM_PROCESSES"])
    if process_id is None and "MPIT_PROCESS_ID" in env:
        process_id = int(env["MPIT_PROCESS_ID"])
    hostfile = hostfile or env.get("MPIT_HOSTFILE") or None
    entries: List[HostEntry] = []
    if hostfile and (coordinator is None or num_processes is None):
        entries = read_hostfile(hostfile)
        hf_coord, hf_n = coordinator_from_hostfile(entries, port)
        coordinator = coordinator or hf_coord
        num_processes = num_processes if num_processes is not None else hf_n
    if coordinator is None and num_processes is None and process_id is None:
        return None, None, None, entries
    num_processes = 1 if num_processes is None else num_processes
    if process_id is None:
        if num_processes > 1:
            # Defaulting to 0 would make every host claim the coordinator's
            # rank and hang the rendezvous.
            raise ValueError(
                f"process_id required for a {num_processes}-process group: "
                "pass --process_id / MPIT_PROCESS_ID (unique per host)")
        process_id = 0
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} processes")
    return coordinator, num_processes, process_id, entries


def _host_slot(coordinator: str, num_processes: int, process_id: int,
               entries: Sequence[HostEntry]) -> Tuple[int, int]:
    """(this host's processes of the group, this process's index among
    them).  A hostfile says which lines share our host; a coordinator on
    the loopback is reachable only from this host, so every process is
    here; otherwise one process a host, the hostfile convention."""
    if entries:
        mine = entries[process_id].host
        same = [i for i, e in enumerate(entries) if e.host == mine]
        return len(same), same.index(process_id)
    if coordinator.rsplit(":", 1)[0].strip("[]") in LOOPBACK:
        return num_processes, process_id
    return 1, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def choose_backend(device: str, local: int, cards: int) -> str:
    """The backend of a group with ``local`` of its processes on this host,
    which has ``cards`` CUDA cards: gloo on the CPU; on the card NCCL where
    each process has a card of its own, else gloo (NCCL refuses two ranks
    on one GPU)."""
    if device == "cpu":
        return "gloo"
    if cards < 1:
        raise RuntimeError("no CUDA device: a group on the card needs one")
    return "nccl" if local <= cards else "gloo"


def bootstrap(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
              process_id: Optional[int] = None, hostfile: Optional[str] = None,
              port: int = 8476, device: str = "cuda") -> ProcessGroup:
    """Form the process group over ``torch.distributed`` and return the
    identity handle (see :func:`resolve` for the order).  ``device``:
    ``"cuda"`` (this process takes its host's card of its index, modulo the
    cards; the backend by :func:`choose_backend`) or ``"cpu"`` (gloo)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    coordinator, num_processes, process_id, entries = resolve(
        coordinator, num_processes, process_id, hostfile, port)
    if num_processes is None:
        # A single host, or a group something else formed: report the real
        # identity either way.
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return ProcessGroup(dist.get_rank(), dist.get_world_size(), None, device,
                                dist.get_backend())
        return ProcessGroup(0, 1, None, device)
    if coordinator is None:
        if num_processes > 1:
            raise ValueError(f"a {num_processes}-process group needs a coordinator: "
                             "pass --coordinator / MPIT_COORDINATOR or a hostfile")
        coordinator = f"localhost:{_free_port()}"  # a group of one
    local, index = _host_slot(coordinator, num_processes, process_id, entries)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = choose_backend(device, local, cards)
    if device == "cuda":
        torch.cuda.set_device(index % cards)
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return ProcessGroup(process_id, num_processes, coordinator, device, backend)


def shutdown() -> None:
    """Tear down the process group (a no-op when none was formed)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def barrier() -> None:
    """Wait until every process of the group gets here (a no-op without a
    group of more than one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _launcher_kwargs(cfg) -> dict:
    return dict(coordinator=cfg.coordinator or None,
                num_processes=cfg.num_processes or None,
                process_id=cfg.process_id if cfg.process_id >= 0 else None,
                hostfile=cfg.hostfile or None)


def launcher_processes(cfg) -> int:
    """The processes of the group that the launchers' multi-host flags
    (``hostfile``, ``coordinator``, ``num_processes``, ``process_id``; empty,
    0 and -1 unset) name, checked as :func:`resolve` checks them, without
    forming it: 1 where no flag is set.  The launchers check their layout
    against it before any rendezvous."""
    n = resolve(**_launcher_kwargs(cfg))[1]
    return 1 if n is None else n


def bootstrap_launcher(cfg, device: str) -> ProcessGroup:
    """The launchers' bootstrap from their multi-host flags: a group of any
    size forms (no group where no flag is set)."""
    return bootstrap(**_launcher_kwargs(cfg), device=device)
