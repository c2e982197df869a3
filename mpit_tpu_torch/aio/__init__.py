"""L1 — cooperative async engine (the port of ``mpit_tpu/aio/``).

The reference implements asynchronous I/O with Lua coroutines scheduled from
a FIFO queue (reference: queue.lua:3-47, init.lua:128-185) and turns MPI's
nonblocking Isend/Irecv/Test into "async send/recv with optional callback"
(reference: init.lua:40-102).

Here the same cooperative-multitasking contract is expressed with Python
generators: a :class:`Task` wraps a generator; the :class:`Scheduler` owns a
FIFO :class:`Queue` of tasks and single-steps them (``ping``) or drains them
(``wait``).  ``aio_send``/``aio_recv`` are generator factories that poll a
transport's nonblocking handles, yielding ``EXEC`` between polls.
"""

from mpit_tpu_torch.aio.queue import Queue
from mpit_tpu_torch.aio.scheduler import (
    DONE,
    ERR,
    EXEC,
    INIT,
    OK,
    DeadlineExceeded,
    LiveFlag,
    Scheduler,
    Task,
    TaskError,
    aio_recv,
    aio_send,
    aio_sleep,
    deadline_at,
)

__all__ = [
    "Queue",
    "Scheduler",
    "Task",
    "TaskError",
    "LiveFlag",
    "aio_send",
    "aio_recv",
    "aio_sleep",
    "deadline_at",
    "DeadlineExceeded",
    "INIT",
    "EXEC",
    "OK",
    "ERR",
    "DONE",
]
