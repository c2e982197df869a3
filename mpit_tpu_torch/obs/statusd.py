"""statusd — per-rank HTTP introspection endpoint (live gang telemetry).

The trace exporter answers "what happened" after a clean exit; the
straggler/skew/churn failure modes the async-PS literature cares about
(MXNET-MPI arxiv 1801.03855; imbalanced arrival arxiv 1804.05349) need
gang state *while it runs*.  ``MPIT_OBS_HTTP=<base_port>`` makes every
rank serve, on ``base_port + rank`` (loopback by default), three routes:

- ``GET /metrics`` — the registry's Prometheus text exposition (the
  exact format a scrape config or ``mpit top`` consumes);
- ``GET /status`` — JSON: rank/role/pid identity, the span recorder's
  **in-flight op table** (op, peer, ``[epoch, seq]``, current phase,
  seconds in flight), and whatever the role objects registered as
  status providers (server: lease/epoch per client, shard map version,
  owned shards, live task table; client: epoch, map version, pending
  tasks);
- ``GET /trace`` — dump-on-demand of the span recorder's trace buffer
  as Chrome trace JSON (same schema as the exit-time export), so a
  *running* gang can be profiled without waiting for it to finish.

Serving runs on one stdlib ``ThreadingHTTPServer`` daemon thread per
process — the cooperative scheduler never sees it, and the GIL makes the
reads (plain attributes, registry snapshots) safe without locking.  A
request costs the *requester* a snapshot; the role hot paths pay
nothing.  When ``MPIT_OBS_HTTP`` is unset, :func:`maybe_start` returns
``None`` without creating a socket, and provider registration is
skipped at the call sites (obs off), so the disabled path stays
null-object free.

This read path is deliberately reusable: ``python -m mpit_tpu_torch.obs top``
polls it, and the shardctl controller / future admission control can
consume the same endpoints (:func:`mpit_tpu_torch.obs.top.poll_rank`).

A copy of ``mpit_tpu/obs/statusd.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from mpit_tpu_torch.obs import clock as _clock
from mpit_tpu_torch.obs import metrics as _metrics
from mpit_tpu_torch.obs import profile as _profile
from mpit_tpu_torch.obs import spans as _spans

ENV = _metrics.HTTP_ENV  # MPIT_OBS_HTTP

#: name -> zero-arg callable returning a JSON-serializable dict.  Role
#: objects register themselves here (obs-enabled processes only); the
#: /status handler calls every provider per request.
_PROVIDERS: Dict[str, Callable[[], dict]] = {}
_PROVIDERS_LOCK = threading.Lock()

#: name -> callable(params dict) -> JSON-serializable dict.  Operator
#: verbs served as ``GET /<name>?k=v`` — e.g. the shard controller's
#: ``/scale`` route.  Handlers run on the HTTP thread, so they must
#: only *enqueue* work (a thread-safe deque the role's own loop
#: drains), never touch the cooperative scheduler.
_ACTIONS: Dict[str, Callable[[Dict[str, str]], dict]] = {}


def register_provider(name: str, fn: Callable[[], dict]) -> None:
    """Attach a status section (``/status`` key ``name``).  Re-registering
    a name replaces it (a restarted role supersedes its old section)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = fn


def register_action(name: str, fn: Callable[[Dict[str, str]], dict]) -> None:
    """Attach an operator verb at ``GET /<name>`` (query params become
    the handler's dict).  Same replace-on-re-register rule as
    providers."""
    with _PROVIDERS_LOCK:
        _ACTIONS[name] = fn


def clear_providers() -> None:
    """Drop every registered provider and action (tests; via
    obs.configure)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS.clear()
        _ACTIONS.clear()


def _action_for(route: str) -> "Optional[Callable[[Dict[str, str]], dict]]":
    with _PROVIDERS_LOCK:
        return _ACTIONS.get(route.lstrip("/"))


def _provider_sections() -> Dict[str, object]:
    with _PROVIDERS_LOCK:
        items = list(_PROVIDERS.items())
    out: Dict[str, object] = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 — introspection never kills a role
            out[name] = {"error": repr(exc)}
    return out


class StatusServer:
    """One rank's endpoint: a ThreadingHTTPServer on a daemon thread."""

    def __init__(self, port: int, rank: Optional[int] = None,
                 role: str = "", host: str = "127.0.0.1"):
        self.rank = rank
        self.role = role
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                route = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if route in ("/", "/metrics"):
                        body = _metrics.get_registry().exposition().encode()
                        self._reply(200, body, "text/plain; version=0.0.4")
                    elif route == "/status":
                        self._reply(200, json.dumps(outer.status()).encode(),
                                    "application/json")
                    elif route == "/trace":
                        self._reply(200, json.dumps(outer.trace()).encode(),
                                    "application/json")
                    elif (action := _action_for(route)) is not None:
                        from urllib.parse import parse_qsl, urlsplit

                        params = dict(parse_qsl(urlsplit(self.path).query))
                        self._reply(200, json.dumps(action(params)).encode(),
                                    "application/json")
                    else:
                        self._reply(404, b"routes: /metrics /status /trace"
                                    b" (+ registered actions)\n",
                                    "text/plain")
                except Exception as exc:  # noqa: BLE001 — see _provider_sections
                    self._reply(500, repr(exc).encode(), "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.5},
            name=f"mpit-statusd:{self.port}", daemon=True)
        self._thread.start()

    def status(self) -> dict:
        rec = _spans.get_recorder()
        return {
            "rank": self.rank,
            "role": self.role,
            "pid": os.getpid(),
            "obs": _metrics.obs_enabled(),
            "inflight_ops": rec.open_ops(),
            "clock": _clock.snapshot_all(),
            # Where the cores are right now (obs/profile.py): pool
            # threads/depth/busy, scheduler runq/CPU, top-5 tasks by
            # cpu_us.  Pool-only when profiling is off.
            "resources": _profile.resource_snapshot(),
            **_provider_sections(),
        }

    def trace(self) -> dict:
        from mpit_tpu_torch.obs import trace as _trace

        rec = _spans.get_recorder()
        pid = self.rank if self.rank is not None else os.getpid()
        label = (f"rank {self.rank}" + (f" ({self.role})" if self.role
                                        else "")) if self.rank is not None \
            else f"pid {pid}"
        return {
            "traceEvents": _trace.chrome_events(rec, pid=pid, label=label),
            "displayTimeUnit": "ms",
            "otherData": {"ranks": {str(pid): {
                "role": self.role,
                "metrics": _metrics.get_registry().snapshot()}},
                "clock": _clock.snapshot_all()},
        }

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def base_port() -> Optional[int]:
    """The announced base port, or None when MPIT_OBS_HTTP is unset."""
    raw = os.environ.get(ENV, "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError as exc:
        raise ValueError(
            f"{ENV} must be an integer base port, got {raw!r}") from exc


def maybe_start(rank: int, role: str = "") -> Optional[StatusServer]:
    """Start this rank's endpoint on ``base_port + rank`` when
    ``MPIT_OBS_HTTP`` is set; None (and no socket) otherwise.  A bind
    failure logs and returns None — introspection must never take a
    training rank down with it."""
    base = base_port()
    if base is None:
        return None
    try:
        server = StatusServer(base + int(rank), rank=int(rank), role=role)
    except OSError as exc:
        from mpit_tpu_torch.utils.logging import get_logger

        get_logger("statusd", rank).warning(
            "could not bind introspection endpoint on port %d: %s "
            "(rank runs without one)", base + int(rank), exc)
        return None
    from mpit_tpu_torch.obs import flight as _flight

    _flight.get_flight().set_identity(rank=rank, role=role)
    return server


def _ephemeral_low(default: int = 32768) -> int:
    """The first port of the kernel's ephemeral range, from which it picks
    the local port of an outgoing connection or of a bind to port 0."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return default


def free_base_port(n: int, host: str = "127.0.0.1", tries: int = 64) -> int:
    """A base port whose ``n`` loopback ports ``base .. base + n - 1`` were
    all free a moment ago (each bound and released in turn).  For a gang's
    ``MPIT_OBS_HTTP`` beside other processes on one host, where a fixed
    base may already be taken.  The base is drawn below the ephemeral
    range: there no outgoing connection of this or another process takes
    one of the ports between the probe and the gang's own binds (one did,
    a rank then ran without its endpoint).  Not in the JAX module: the
    port's own."""
    import random
    import socket

    top = _ephemeral_low() - n
    for _ in range(tries):
        base = random.randint(10000, top) if top > 10000 else random.randint(20000, 60000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind((host, port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError(f"no {n} consecutive free loopback ports found")
