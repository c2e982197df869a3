#!/usr/bin/env python3
"""Repeat one of the port's CPU tests many times and report what each run
shows — for faults that show only under load (``ROADMAP.md`` §C).

Cases:

- ``adam_server``: ``tests/test_torch_ps.py::TestPSBasic::
  test_server_side_adam`` with every Adam apply logged (thread, shard
  size, ``t``, the bits of the bias-corrected ``lr_t``, digests of the
  GRAD and of the shard before and after).  Each run's log is checked:
  each server applied ``t`` = 1, 2, 3 once each, and the (``t``,
  ``lr_t``, GRAD digest) triples equal the local rollout's — another
  ``t``, a foreign GRAD or a doubled one would show.  Failures print
  their log.
- ``adam_ft``: the two framed Adam gangs of ``tests/test_torch_ft.py::
  TestRetryDedupEndToEnd::test_drop_and_dup_run_matches_fault_free_bitwise
  [adam]`` (fault-free, then under the drop/dup matrix), with every K3 call
  logged where ``rules.adam_apply`` makes it: the server thread, ``t`` and
  its shape and dtype, the exponent's shape, the bits of ``lr_t``, and
  digests of the GRAD and of ``p``, ``m`` and ``v`` before and after, plus
  each server's ``dup_ops`` and ``admitted``.  A run whose two gangs end
  apart prints the first call at which their logs part.
- ``rejoin_read``: the port's twin of the reference's
  ``test_evicted_client_rejoins_with_bumped_epoch``, counting the runs in
  which ``rejoins`` still reads 0 right after the restarted client's
  ``start()`` returns (the reference test's immediate read), while the
  rest of the run (the read of the pre-crash state, the stop) must pass.

Run several copies at once to load the host:
    JAX_PLATFORMS=cpu python3 tools/torch_stress_repeat.py adam_server --runs 40
Prints one JSON line: the case, the runs and the counts.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()[:12]


def adam_server(runs: int) -> dict:
    import numpy as np
    import torch

    from mpit_tpu_torch.optim import rules

    log = []
    init, apply = rules._RULES["adam"]

    @functools.wraps(apply)
    def logged(p, g, state, **kw):
        before = _digest(p)
        out = apply(p, g, state, **kw)
        t = int(state["t"])
        e = torch.tensor(float(t))
        lr_t = float(kw.get("lr", 1e-3)
                     * torch.sqrt(1.0 - torch.pow(kw.get("beta2", 0.999), e))
                     / (1.0 - torch.pow(kw.get("beta1", 0.9), e)))
        log.append((threading.current_thread().name, p.numel(), t, lr_t.hex(),
                    _digest(g), before, _digest(p)))
        return out

    rules._RULES["adam"] = (init, logged)
    import test_torch_ps

    fails = bad_logs = 0
    for i in range(runs):
        log.clear()
        try:
            test_torch_ps.TestPSBasic().test_server_side_adam(np.random.default_rng(0))
        except AssertionError as exc:
            fails += 1
            print(f"FAIL run {i}: {exc}", file=sys.stderr)
            for row in log:
                print(f"  {row}", file=sys.stderr)
        served = [r for r in log if r[0] != "MainThread"]
        local = [r for r in log if r[0] == "MainThread"]
        by_server = {}
        for r in served:
            by_server.setdefault(r[0], []).append(r[2])
        ok = (len(by_server) == 2 and all(ts == [1, 2, 3] for ts in by_server.values())
              and sorted(r[2:5] for r in served) == sorted(r[2:5] for r in local))
        if not ok:
            bad_logs += 1
            print(f"BAD LOG run {i}: {log}", file=sys.stderr)
    return {"fails": fails, "bad_logs": bad_logs}


def _k3_log(sink: dict) -> None:
    """Wrap the K3 entry point that ``rules.adam_apply`` calls, logging each
    call's operands into ``sink["log"]`` (see the module docstring)."""
    from mpit_tpu_torch.optim import rules

    real = rules.fused_adam
    mine = threading.local()  # each server thread's entry in flight

    def logged(p, g, m, v, lr_t, **kw):
        before = (_digest(p), _digest(m), _digest(v))
        out = real(p, g, m, v, lr_t, **kw)
        mine.entry.update(n=p.numel(), lr_t=float(lr_t).hex(),
                          lr_t_shape=tuple(lr_t.shape), g=_digest(g), before=before,
                          after=(_digest(p), _digest(m), _digest(v)))
        return out

    rules.fused_adam = logged
    real_apply = rules.adam_apply

    def apply(p, g, state, **kw):
        mine.entry = {"thread": threading.current_thread().name}
        out = real_apply(p, g, state, **kw)
        t = state["t"]
        mine.entry.update(t=int(t), t_shape=tuple(t.shape), t_dtype=str(t.dtype))
        sink["log"].append(mine.entry)
        return out

    rules._RULES["adam"] = (rules._RULES["adam"][0], apply)


def adam_ft(runs: int) -> dict:
    import numpy as np

    import test_torch_ft as T

    fails = 0
    first_parts = []
    sink: dict = {"log": []}
    _k3_log(sink)
    for i in range(runs):
        clean_log, faulty_log = [], []
        sink["log"] = clean_log
        case = T.TestRetryDedupEndToEnd()
        clean, cstats = case._final_params(None, None, rule="adam")
        sink["log"] = faulty_log
        plans = {j: T.FaultPlan(seed=j, drop_every=3, dup_every=4, tags=T.DATA_TAGS)
                 for j in range(2)}
        faulty, fstats = case._final_params(
            plans, T.FaultPlan(seed=9, drop_every=3, tags=T.REPLY_TAGS), rule="adam")
        if clean.tobytes() != faulty.tobytes():
            fails += 1
            print(f"FAIL run {i}: stats {cstats} vs {fstats}", file=sys.stderr)
            key = lambda r: (r["n"], r["t"])  # noqa: E731 — per-shard, per-t
            a = sorted(clean_log, key=key)
            b = sorted(faulty_log, key=key)
            for x, y in zip(a, b):
                if {k: x[k] for k in x if k != "thread"} != \
                        {k: y[k] for k in y if k != "thread"}:
                    first_parts.append((x, y))
                    print(f"  first parting call:\n  clean  {x}\n  faulty {y}",
                          file=sys.stderr)
                    break
            else:
                print(f"  every K3 call equal ({len(a)} vs {len(b)} calls)",
                      file=sys.stderr)
    return {"fails": fails, "parted_at_a_call": len(first_parts)}


def rejoin_read(runs: int) -> dict:
    import numpy as np

    import test_torch_ft as T
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.ps import ParamClient

    read_zero = errors = 0
    for i in range(runs):
        servers, (c1, c2), threads, transports, w0, bufs = T._two_clients_one_server()
        try:
            bufs[1][1][:] = 1.0
            c2.async_send_grad()
            c2.wait()
            T._beat_until_seen(servers[0], c2)
            transports[1].sever(0)
            T._silence_until_evicted(servers[0], c2.rank, c1)
            c2b = ParamClient(c2.rank, [0], transports[1].inner,
                              ft=FTConfig(heartbeat_s=0.02, op_deadline_s=0.5,
                                          max_retries=4, backoff_base_s=0.005, epoch=1))
            p2b, g2b = np.zeros_like(w0), np.zeros_like(w0)
            starter = threading.Thread(target=c2b.start, args=(p2b, g2b), daemon=True)
            starter.start()
            starter.join(10)
            if servers[0].rejoins != 1:
                read_zero += 1
            c2b.async_recv_param()
            c2b.wait()
            if not (p2b == w0 + 1.0).all():
                raise AssertionError("the rejoined client read another state")
            c1.stop()
            c2b.stop()
            T.join_all(threads)
        except Exception as exc:  # noqa: BLE001 — counted and reported
            errors += 1
            print(f"ERROR run {i}: {exc!r}", file=sys.stderr)
            for s in servers:
                s.live.stop()
    return {"rejoins_read_0": read_zero, "errors": errors}


CASES = {"adam_server": adam_server, "adam_ft": adam_ft, "rejoin_read": rejoin_read}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("case", choices=sorted(CASES))
    parser.add_argument("--runs", type=int, default=40)
    args = parser.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    t0 = time.monotonic()
    counts = CASES[args.case](args.runs)
    print(json.dumps({"case": args.case, "runs": args.runs, **counts,
                      "seconds": round(time.monotonic() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
