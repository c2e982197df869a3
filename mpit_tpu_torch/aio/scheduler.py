"""Cooperative task scheduler (analog of reference init.lua:21-25,128-185).

A copy of ``mpit_tpu/aio/scheduler.py`` without its observability hooks
(flight recorder, CPU profile, spans; they come with the port's obs layer),
without the fault-tolerance deadlines and abort predicates (the ft layer),
and without the completion callbacks and wait variants no caller of the
port uses.  The port imports nothing of the JAX package.

The reference schedules Lua coroutines that yield one of five signals; the
scheduler pops one coroutine from a FIFO, resumes it one step, and re-pushes
it unless it finished (init.lua:147-174).  ``co_wait`` spins until the queue
drains (init.lua:178-185).  That cooperative single-step model is what lets
a parameter-server client overlap communication polls with device compute
(``pc:ping()``, reference optim-eamsgd.lua:63) without threads.

Here tasks are Python generators.  A generator yields ``EXEC`` (still
working — typically between transfer polls) and returns normally when done;
its return value is captured.  Exceptions become ``ERR`` state and are
re-raised from :meth:`Scheduler.wait`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Generator, Optional

from mpit_tpu_torch.aio.queue import Queue

# Idle backoff (microseconds) for the wait loops: after a full pass over
# the queue completes NO task, the waiter sleeps this long before polling
# again.  Every role of an in-process gang is a thread of one interpreter:
# a busy-spinning waiter holds the interpreter lock that the thread about
# to launch the next kernel, or to deliver the awaited message, needs.
# 0 disables.
IDLE_USEC = float(os.environ.get("MPIT_AIO_IDLE_USEC", "200"))

# Task signals (reference init.lua:21-25).  INIT/OK are retained for state
# reporting; the scheduler itself only reacts to EXEC (keep going) vs DONE.
INIT = "INIT"
EXEC = "EXEC"
OK = "OK"
ERR = "ERR"
DONE = "DONE"


class TaskError(RuntimeError):
    """An exception raised inside a scheduled task, with the task attached."""

    def __init__(self, task: "Task", cause: BaseException):
        super().__init__(f"task {task.name!r} failed: {cause!r}")
        self.task = task
        self.cause = cause


class Task:
    """A cooperatively-scheduled unit of work wrapping a generator.

    The generator is *not* primed at construction; the scheduler steps it.
    ``result`` holds the generator's return value once state is DONE.
    """

    __slots__ = ("gen", "name", "state", "result", "error")

    def __init__(self, gen: Generator[Any, None, Any], name: str = "task") -> None:
        self.gen = gen
        self.name = name
        self.state = INIT
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def step(self) -> str:
        """Advance the generator one yield.  Returns the new state."""
        if self.state in (DONE, ERR):
            return self.state
        try:
            next(self.gen)
            self.state = EXEC
        except StopIteration as stop:
            self.result = stop.value
            self.state = DONE
        except BaseException as exc:  # noqa: BLE001 — recorded, re-raised by wait()
            self.error = exc
            self.state = ERR
        return self.state

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Task({self.name!r}, state={self.state})"


class Scheduler:
    """FIFO round-robin scheduler of generator tasks.

    One scheduler per role (server or client), exactly as the reference
    runs one coroutine queue per rank.  Methods map to the reference API:
    ``spawn`` = co_execute (init.lua:133-144), ``ping`` = co_ping
    (init.lua:147-174), ``wait`` = co_wait (init.lua:178-185).
    """

    def __init__(self) -> None:
        self.queue: Queue[Task] = Queue()
        self.errors: list[TaskError] = []
        self._completions = 0

    # -- co_execute ---------------------------------------------------------
    def spawn(self, gen: Generator[Any, None, Any], name: str = "task") -> Task:
        """Create a task, prime it with one step, queue it if still running."""
        task = Task(gen, name=name)
        self._step_and_requeue(task)
        return task

    # -- co_ping ------------------------------------------------------------
    def ping(self) -> Optional[Task]:
        """Pop one task, advance it one step, re-queue unless finished.

        Returns the task stepped (or None when the queue is empty).  This is
        the comm/compute-overlap primitive: call between device ops to make
        transfer progress without blocking.
        """
        task = self.queue.pop()
        if task is None:
            return None
        self._step_and_requeue(task)
        return task

    def ping_pass(self) -> bool:
        """One full pass over the current queue (one ping per queued
        task), then the idle backoff when the pass completed no task.
        Returns True when anything completed.  The single building block
        of the wait loop — the backoff rule lives here only."""
        done0 = self._completions
        for _ in range(len(self.queue)):
            self.ping()
        progressed = self._completions != done0
        if not progressed and IDLE_USEC > 0 and self.queue:
            # Full pass, nothing finished: yield the core (see IDLE_USEC)
            # instead of burning it on iprobe spins.
            time.sleep(IDLE_USEC * 1e-6)
        return progressed

    # -- co_wait ------------------------------------------------------------
    def wait(self) -> None:
        """Drain the queue (the reference's co_wait, init.lua:178-185).
        Raises the first :class:`TaskError` encountered after draining."""
        while self.queue:
            self.ping_pass()
        if self.errors:
            raise self.errors.pop(0)

    def _step_and_requeue(self, task: Task) -> None:
        state = task.step()
        if state == EXEC:
            self.queue.push(task)
        elif state == ERR:
            self._completions += 1
            self.errors.append(TaskError(task, task.error))  # type: ignore[arg-type]
        elif state == DONE:
            self._completions += 1

    def __len__(self) -> int:
        return len(self.queue)


# ---------------------------------------------------------------------------
# Async transfer generators (analog of reference init.lua:40-102).
#
# A transport (mpit_tpu_torch.comm) exposes nonblocking primitives:
#   isend(data, dst, tag) -> handle          irecv(src, tag) -> handle
#   test(handle) -> bool                     iprobe(src, tag) -> bool
#   cancel(handle) -> None                   payload(handle) -> bytes/array
# The generators below poll those handles, yielding EXEC between polls, and
# honour a shared LiveFlag for the graceful-shutdown cancel path
# (reference init.lua:50-58,88-96; README:71).
# ---------------------------------------------------------------------------


class LiveFlag:
    """Shared on/off switch for a role's I/O (reference ``state.io``)."""

    __slots__ = ("io", "on")

    def __init__(self) -> None:
        self.io = True  # transfers may progress
        self.on = True  # service loops may continue

    def stop(self) -> None:
        self.io = False
        self.on = False


def aio_send(
    transport: Any,
    data: Any,
    dst: int,
    tag: int,
    live: Optional[LiveFlag] = None,
) -> Generator[str, None, None]:
    """Nonblocking send: post, then poll-test until complete.

    Mirrors reference init.lua:40-65 — including the shutdown path: when the
    live flag drops, the in-flight send is cancelled so buffer ownership
    returns to the caller before exit.
    """
    handle = transport.isend(data, dst, tag)
    while not transport.test(handle):
        if live is not None and not live.io:
            transport.cancel(handle)
            return
        yield EXEC


def aio_recv(
    transport: Any,
    src: int,
    tag: int,
    live: Optional[LiveFlag] = None,
    out: Optional[Any] = None,
) -> Generator[str, None, Any]:
    """Nonblocking receive: probe until a matching message exists, then post
    the receive and poll it to completion.  Returns the payload, or None
    when the live flag dropped first.

    Mirrors reference init.lua:67-102 (Iprobe poll -> Irecv -> Test poll,
    cancel-on-shutdown).  ``out``, when given, is a preallocated buffer the
    transport fills (the zero-copy analog of receiving into a tensor shard).
    """
    while not transport.iprobe(src, tag):
        if live is not None and not live.io:
            return None
        yield EXEC
    handle = transport.irecv(src, tag, out=out)
    while not transport.test(handle):
        if live is not None and not live.io:
            transport.cancel(handle)
            return None
        yield EXEC
    return transport.payload(handle)
