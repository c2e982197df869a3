"""The port's multi-host bootstrap (``mpit_tpu_torch.parallel.distributed``)
against the JAX package's: the hostfile, the resolution order and its
errors, a real group of one in a fresh process, and a real group of two
processes formed from a hostfile and ``MPIT_PROCESS_ID``, each checking its
rank and one ``all_reduce``; the backend by device and by the host's
cards (NCCL a card a process, gloo where processes share a card) and the
group's timeout.  Groups on the CPU run over gloo (``device="cpu"``); the
JAX twins of the first nine tests are
``tests/test_distributed.py``'s."""

import datetime
import os
import socket
import subprocess
import sys

import pytest
import torch

from mpit_tpu.parallel import bootstrap as jax_bootstrap
from mpit_tpu.parallel import read_hostfile as jax_read_hostfile
from mpit_tpu.parallel.distributed import coordinator_from_hostfile as jax_coordinator
from mpit_tpu_torch.parallel import ProcessGroup, bootstrap, read_hostfile
from mpit_tpu_torch.parallel.distributed import (
    GROUP_TIMEOUT_S, choose_backend, coordinator_from_hostfile, resolve)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID", "MPIT_HOSTFILE")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _as_pairs(entries):
    return [(e.host, e.slots) for e in entries]


class TestHostfile:
    def test_reference_format(self, tmp_path):
        p = tmp_path / "hosts"
        p.write_text("bluejgpu1:16\nbluejgpu2:16\n\n# comment\nbluejgpu3:16\n")
        entries = read_hostfile(p)
        assert [e.host for e in entries] == ["bluejgpu1", "bluejgpu2", "bluejgpu3"]
        assert all(e.slots == 16 for e in entries)
        assert _as_pairs(entries) == _as_pairs(jax_read_hostfile(p))

    def test_default_slots_and_coordinator(self, tmp_path):
        p = tmp_path / "hosts"
        p.write_text("alpha\nbeta:4\n")
        entries = read_hostfile(p)
        assert entries[0].slots == 1 and entries[1].slots == 4
        coord, n = coordinator_from_hostfile(entries, port=9999)
        assert coord == "alpha:9999" and n == 2
        assert (coord, n) == jax_coordinator(jax_read_hostfile(p), port=9999)

    def test_empty_raises(self, tmp_path):
        p = tmp_path / "hosts"
        p.write_text("# nothing\n")
        for read in (read_hostfile, jax_read_hostfile):
            with pytest.raises(ValueError):
                read(p)

    def test_bad_line_raises(self, tmp_path):
        p = tmp_path / "hosts"
        p.write_text(":8\n")
        for read in (read_hostfile, jax_read_hostfile):
            with pytest.raises(ValueError):
                read(p)


class TestBootstrap:
    def test_single_host_noop(self, monkeypatch):
        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)
        pg = bootstrap(device="cpu")
        assert pg == ProcessGroup(0, 1, None, device="cpu")
        assert len(pg.devices) >= 1
        assert "single-host" in pg.describe()
        assert not torch.distributed.is_initialized()  # no group formed
        assert pg.devices == [torch.device("cpu")]
        jpg = jax_bootstrap()
        assert (pg.process_id, pg.num_processes, pg.coordinator) == (
            jpg.process_id, jpg.num_processes, jpg.coordinator)

    def test_rank_range_validated(self):
        for boot in (bootstrap, jax_bootstrap):
            with pytest.raises(ValueError):
                boot(coordinator="localhost:1", num_processes=2, process_id=5)

    def test_missing_process_id_raises(self, tmp_path, monkeypatch):
        # A 2-line hostfile without a per-host process_id: every host would
        # claim rank 0 and hang the rendezvous, so it must raise.
        for var in ("MPIT_PROCESS_ID", "MPIT_COORDINATOR", "MPIT_NUM_PROCESSES"):
            monkeypatch.delenv(var, raising=False)
        p = tmp_path / "hosts"
        p.write_text("a:1\nb:1\n")
        for boot in (bootstrap, jax_bootstrap):
            with pytest.raises(ValueError, match="process_id required"):
                boot(hostfile=str(p))

    def test_hostfile_env_resolution(self, tmp_path, monkeypatch):
        p = tmp_path / "hosts"
        p.write_text("me:1\nyou:1\n")
        monkeypatch.setenv("MPIT_HOSTFILE", str(p))
        monkeypatch.setenv("MPIT_PROCESS_ID", "3")
        # id 3 out of range for the 2-entry hostfile: the hostfile and the
        # env were both consulted.
        for boot in (bootstrap, jax_bootstrap):
            with pytest.raises(ValueError):
                boot()
        monkeypatch.setenv("MPIT_PROCESS_ID", "1")
        assert resolve()[:3] == ("me:8476", 2, 1)

    def test_more_processes_than_cards_on_a_host_raise(self, monkeypatch):
        """NCCL takes one card a process: two processes of a group on a
        loopback coordinator (so on this host) with one card share it over
        gloo, each on card 0 (the group's formation recorded, not run);
        what still raises is a group on the card of a host with no card."""
        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)
        seen = {}
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen.setdefault("card", i))
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: seen.update(kw))
        pg = bootstrap(coordinator="localhost:1234", num_processes=2, process_id=1,
                       device="cuda")
        assert (pg.backend, seen["backend"], seen["card"]) == ("gloo", "gloo", 0)
        assert "backend=gloo" in pg.describe()
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bootstrap(coordinator="localhost:1234", num_processes=2, process_id=0,
                      device="cuda")


@pytest.mark.parametrize("device, local, cards, backend", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 2, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_choose_backend(device, local, cards, backend):
    """NCCL where each of this host's processes has a card of its own, gloo
    where they share one, and on the CPU."""
    assert choose_backend(device, local, cards) == backend


@pytest.mark.parametrize("device, backend", [("cuda", "nccl"), ("cpu", "gloo")])
def test_backend_follows_the_device(monkeypatch, device, backend):
    """NCCL for a CUDA device, gloo only where the caller asks for the CPU:
    no fallback from one to the other.  The group's formation is recorded,
    not run (this host has no card); the rendezvous and every collective
    give up after ``GROUP_TIMEOUT_S``."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    seen = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen.setdefault("card", i))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen.update(kw))
    pg = bootstrap(coordinator="localhost:1234", num_processes=1, process_id=0,
                   device=device)
    assert seen.pop("backend") == backend
    assert seen.pop("timeout") == datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    assert seen == dict({"card": 0} if device == "cuda" else {},
                        init_method="tcp://localhost:1234", world_size=1, rank=0)
    assert pg == ProcessGroup(0, 1, "localhost:1234", device=device, backend=backend)


def _run_children(code, envs, timeout=120):
    """Run ``code`` in one fresh process per env (added to this process's
    environment without its ``MPIT_*`` group variables)."""
    base = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                              env={**base, **env}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for env in envs]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-1500:]
        outs.append(out)
    return outs


def test_real_group_of_one():
    """Form (and tear down) a group of one in a fresh process over gloo."""
    code = (
        "import torch\n"
        "from mpit_tpu_torch.parallel import bootstrap\n"
        "from mpit_tpu_torch.parallel.distributed import shutdown\n"
        f"pg = bootstrap(coordinator='localhost:{_free_port()}', num_processes=1,"
        " process_id=0, device='cpu')\n"
        "assert pg.num_processes == 1 and pg.process_id == 0\n"
        "assert len(pg.devices) >= 1\n"
        "assert torch.distributed.get_backend() == 'gloo'\n"
        "shutdown()\n"
        "assert not torch.distributed.is_initialized()\n"
        "print('GROUP OK')\n"
    )
    (out,) = _run_children(code, [{}])
    assert "GROUP OK" in out


def test_real_group_of_two_from_a_hostfile(tmp_path):
    """Two processes, one hostfile of two loopback lines and its port,
    ``MPIT_PROCESS_ID`` apart: each has its rank, and one ``all_reduce``
    of ``rank + 1`` gives 3 on both."""
    hosts = tmp_path / "hosts"
    hosts.write_text("localhost:1\nlocalhost:1\n")
    code = (
        "import torch\n"
        "from mpit_tpu_torch.parallel import bootstrap\n"
        "from mpit_tpu_torch.parallel.distributed import shutdown\n"
        f"pg = bootstrap(port={_free_port()}, device='cpu')\n"
        "assert torch.distributed.get_rank() == pg.process_id\n"
        "assert torch.distributed.get_world_size() == pg.num_processes == 2\n"
        "t = torch.tensor([pg.process_id + 1.0])\n"
        "torch.distributed.all_reduce(t)\n"
        "print('RANK', pg.process_id, 'SUM', float(t), pg.describe())\n"
        "shutdown()\n"
    )
    outs = _run_children(code, [{"MPIT_HOSTFILE": str(hosts), "MPIT_PROCESS_ID": str(r)}
                                for r in (0, 1)])
    for r, out in enumerate(outs):
        assert f"RANK {r} SUM 3.0" in out, out
        assert "global=2" in out
