"""Cooperative task scheduler (analog of reference init.lua:21-25,128-185).

A copy of ``mpit_tpu/aio/scheduler.py`` without the completion callbacks
and wait variants no caller of the port uses.  Its observability hooks
are the JAX scheduler's: task spans, the per-step ``thread_time`` stamps of
the CPU profile, the run-queue sample and the stall dump of the flight
recorder (:mod:`mpit_tpu_torch.obs`).  The fault-tolerance timers are
here: op deadlines
(:class:`DeadlineExceeded`, :func:`deadline_at`), ``abort`` predicates on
the transfer generators (lease eviction, a superseded service
generation), :func:`aio_sleep` and ``Scheduler.wait(deadline=)``.  The
port imports nothing of the JAX package.

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
from typing import Any, Callable, Generator, Optional

from mpit_tpu_torch.aio.queue import Queue
from mpit_tpu_torch.obs import flight as _obs_flight
from mpit_tpu_torch.obs import metrics as _obs_metrics
from mpit_tpu_torch.obs import profile as _obs_profile
from mpit_tpu_torch.obs import spans as _obs_spans

# Idle backoff (microseconds) for the wait loops: after a full pass over
# the queue completes NO task, the waiter sleeps this long before polling
# again.  Every role of an in-process gang is a thread of one interpreter:
# a busy-spinning waiter holds the interpreter lock that the thread about
# to launch the next kernel, or to deliver the awaited message, needs.
# 0 disables.
IDLE_USEC = float(os.environ.get("MPIT_AIO_IDLE_USEC", "200"))

# Stuck-gang watchdog (obs/flight.py): when a non-empty queue has
# accumulated this many seconds of idle backoff without completing a
# single task, the scheduler dumps its live task table plus the flight
# recorder's recent events.  Counted in idle-backoff seconds (no extra
# clock reads on the hot path); active only when obs is enabled; 0
# disables.
STALL_S = float(os.environ.get("MPIT_OBS_STALL_S", "60"))

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


class DeadlineExceeded(RuntimeError):
    """An aio transfer missed its deadline (the ft op-deadline path).

    Carries enough context for the retry layer to identify the op: the
    peer rank, the wire tag, and which side (send/recv) timed out."""

    def __init__(self, kind: str, peer: int, tag: int, late_by: float):
        super().__init__(
            f"aio_{kind} (peer={peer}, tag={tag}) missed its deadline "
            f"by {late_by:.3f}s"
        )
        self.kind = kind
        self.peer = peer
        self.tag = tag
        self.late_by = late_by


def deadline_at(seconds: Optional[float]) -> Optional[float]:
    """Absolute monotonic deadline ``seconds`` from now (None passes
    through: no deadline).  Deadlines are absolute by the time they reach
    the poll loops: relative timeouts restarted per retry attempt would
    never fire under a steady trickle of progress."""
    return None if seconds is None else time.monotonic() + seconds


class Task:
    """A cooperatively-scheduled unit of work wrapping a generator.

    The generator is *not* primed at construction; the scheduler steps it.
    ``result`` holds the generator's return value once state is DONE.
    """

    __slots__ = ("gen", "name", "state", "result", "error", "t_obs", "cpu_s")

    def __init__(self, gen: Generator[Any, None, Any], name: str = "task") -> None:
        self.gen = gen
        self.name = name
        self.state = INIT
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_obs: Any = None  # span-recorder token (None when disabled)
        self.cpu_s = 0.0  # on-CPU seconds (profiler-stamped; 0 when off)

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

    def __init__(self, idle_usec: Optional[float] = None,
                 stall_s: Optional[float] = None) -> None:
        self.queue: Queue[Task] = Queue()
        self.errors: list[TaskError] = []
        self.idle_usec = IDLE_USEC if idle_usec is None else float(idle_usec)
        self._completions = 0
        # Observability: instruments are captured once — disabled they are
        # the shared null objects, so the per-step and idle accounting
        # below costs one no-op method call and reads no clock.
        self._rec = _obs_spans.get_recorder()
        self._flight = _obs_flight.get_flight()
        self._prof = _obs_profile.get_profiler()
        self.stall_s = STALL_S if stall_s is None else float(stall_s)
        self._idle_accum = 0.0
        self._stall_dumped = False
        _reg = _obs_metrics.get_registry()
        self._m_steps = _reg.counter("mpit_aio_steps_total")
        self._m_idle = _reg.counter("mpit_aio_idle_seconds_total")
        self._m_tasks = _reg.counter("mpit_aio_tasks_total")
        self._m_stalls = _reg.counter("mpit_aio_stall_dumps_total")

    # -- co_execute ---------------------------------------------------------
    def spawn(self, gen: Generator[Any, None, Any], name: str = "task") -> Task:
        """Create a task, prime it with one step, queue it if still running."""
        task = Task(gen, name=name)
        self._m_tasks.inc()
        task.t_obs = self._rec.task_begin(name)
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
        if self._prof.enabled:
            # Counter-track sample (throttled inside the profiler):
            # run-queue depth + cumulative task CPU.
            self._prof.sample(len(self.queue))
        progressed = self._completions != done0
        if progressed:
            self._idle_accum = 0.0
            self._stall_dumped = False
        elif self.idle_usec > 0 and self.queue:
            # Full pass, nothing finished: yield the core (see IDLE_USEC)
            # instead of burning it on iprobe spins.
            time.sleep(self.idle_usec * 1e-6)
            self._m_idle.inc(self.idle_usec * 1e-6)
            self._idle_accum += self.idle_usec * 1e-6
            if (self._flight.enabled and self.stall_s > 0
                    and not self._stall_dumped
                    and self._idle_accum >= self.stall_s):
                # Stuck gang: nothing completed across stall_s of idle
                # backoff.  Dump once per stall episode.
                self._stall_dumped = True
                self._m_stalls.inc()
                self._flight.record(
                    "scheduler_stall", idle_s=self._idle_accum,
                    pending=[t.name for t in self.queue])
                self._flight.dump(
                    "scheduler_stall",
                    tasks=[(t.name, t.state) for t in self.queue],
                    idle_s=self._idle_accum)
        return progressed

    # -- co_wait ------------------------------------------------------------
    def wait(self, deadline: Optional[float] = None) -> None:
        """Drain the queue (the reference's co_wait, init.lua:178-185).
        Raises the first :class:`TaskError` encountered after draining;
        with ``deadline`` (seconds), raises TimeoutError if tasks remain
        after it."""
        t_end = None if deadline is None else time.monotonic() + deadline
        while self.queue:
            self.ping_pass()
            if t_end is not None and time.monotonic() > t_end and self.queue:
                raise TimeoutError(
                    f"scheduler.wait: {len(self.queue)} task(s) still pending "
                    f"after {deadline}s: {[t.name for t in self.queue]}"
                )
        if self.errors:
            raise self.errors.pop(0)

    def wait_for(self, task: Task) -> Any:
        """Drive the queue until ``task`` completes; return its result (the
        shard controller's synchronous directives run through this)."""
        while task.state not in (DONE, ERR):
            if not self.queue:
                raise RuntimeError(f"task {task.name!r} pending but queue empty")
            self.ping_pass()
        if task.state == ERR:
            # Drop the queued duplicate so a later wait() does not re-raise
            # an error the caller already handled here.
            self.errors = [e for e in self.errors if e.task is not task]
            raise TaskError(task, task.error)
        return task.result

    def _step_and_requeue(self, task: Task) -> None:
        prof = self._prof
        if prof.enabled:
            # Per-task CPU attribution (obs/profile.py): the delta of the
            # stepping thread's CPU clock across this step belongs to this
            # task — the task-switch boundary is the yield.
            c0 = prof.cpu_now()
            state = task.step()
            d = prof.cpu_now() - c0
            if d > 0:
                task.cpu_s += d
            prof.step(task.name, d)
        else:
            state = task.step()
        self._m_steps.inc()
        if state == EXEC:
            self.queue.push(task)
        elif state == ERR:
            self._completions += 1
            self._rec.task_end(task.t_obs, task.name, ERR,
                               cpu_us=task.cpu_s * 1e6)
            self.errors.append(TaskError(task, task.error))  # type: ignore[arg-type]
        elif state == DONE:
            self._completions += 1
            self._rec.task_end(task.t_obs, task.name, DONE,
                               cpu_us=task.cpu_s * 1e6)

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
    deadline: Optional[float] = None,
    abort: Optional[Callable[[], bool]] = None,
) -> Generator[str, None, None]:
    """Nonblocking send: post, then poll-test until complete.

    Mirrors reference init.lua:40-65 — including the shutdown path: when the
    live flag drops, the in-flight send is cancelled so buffer ownership
    returns to the caller before exit.

    ``deadline`` (absolute monotonic seconds, see :func:`deadline_at`)
    raises :class:`DeadlineExceeded` if the transfer has not completed by
    then — the op-deadline primitive of the ft retry layer.  ``abort`` is
    polled between steps; returning True cancels the send and returns
    None (the lease-eviction path: a server must stop waiting on a peer
    its lease registry has declared dead).
    """
    handle = transport.isend(data, dst, tag)
    while not transport.test(handle):
        if live is not None and not live.io:
            transport.cancel(handle)
            return
        if abort is not None and abort():
            transport.cancel(handle)
            return
        if deadline is not None and time.monotonic() > deadline:
            transport.cancel(handle)
            raise DeadlineExceeded("send", dst, tag, time.monotonic() - deadline)
        yield EXEC


def aio_recv(
    transport: Any,
    src: int,
    tag: int,
    live: Optional[LiveFlag] = None,
    out: Optional[Any] = None,
    deadline: Optional[float] = None,
    abort: Optional[Callable[[], bool]] = None,
) -> Generator[str, None, Any]:
    """Nonblocking receive: probe until a matching message exists, then post
    the receive and poll it to completion.  Returns the payload, or None
    when the live flag dropped first.

    Mirrors reference init.lua:67-102 (Iprobe poll -> Irecv -> Test poll,
    cancel-on-shutdown).  ``out``, when given, is a preallocated buffer the
    transport fills (the zero-copy analog of receiving into a tensor shard).

    ``deadline`` (absolute monotonic seconds) raises
    :class:`DeadlineExceeded` from the probe loop if no matching message
    arrives in time.  ``abort`` returning True gives up and returns None
    (lease eviction / generation change).  Both are checked only while
    *probing*: once a matching message exists the recv is posted and
    drained to completion — cancelling a posted receive could strand or
    destroy a message another service generation still needs.
    """
    while not transport.iprobe(src, tag):
        if live is not None and not live.io:
            return None
        if abort is not None and abort():
            return None
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceeded("recv", src, tag, time.monotonic() - deadline)
        yield EXEC
    handle = transport.irecv(src, tag, out=out)
    while not transport.test(handle):
        if live is not None and not live.io:
            transport.cancel(handle)
            return None
        yield EXEC
    return transport.payload(handle)


def aio_sleep(
    seconds: float, live: Optional[LiveFlag] = None
) -> Generator[str, None, bool]:
    """Cooperative sleep: yield EXEC until ``seconds`` have elapsed (the
    scheduler-timer primitive behind retry backoff and lease reaping).
    Returns False if the live flag dropped before the timer fired, True
    otherwise.  Never blocks the scheduler — other tasks run between
    polls, and the ping_pass idle backoff keeps an otherwise-idle queue
    from busy-spinning the core while a timer counts down."""
    wake = time.monotonic() + seconds
    while time.monotonic() < wake:
        if live is not None and not live.on:
            return False
        yield EXEC
    return True
