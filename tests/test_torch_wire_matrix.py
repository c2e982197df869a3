"""The port server's INIT negotiation against the wire-schema oracle: the
twin of ``tests/test_wire_matrix.py``'s ``TestNegotiationMatrix`` at the
plain posture (no readers, no cells), for INIT v1-v3 and all 128 v3 flag
sets.

For every cell the port's ``ParamServer._negotiate`` must agree with
``mpit_tpu.analysis.schema.negotiate``:

- a cell the oracle accepts is accepted, with the oracle's effective
  per-pair posture (framed, heartbeat, staleness, timing; the readonly,
  subscribe, chunked and shardctl postures of later slices are off);
- a cell the oracle refuses is refused — loudly, with a ValueError as the
  JAX server refuses it, or with a NotImplementedError that names the
  slice of the port its flag belongs to.

INIT v4 (shard control) and v5 (chunked streaming) widen the twin with
their slices.
"""

import numpy as np
import pytest

import mpit_tpu.ft.wire as jftw
from mpit_tpu.analysis import schema
from mpit_tpu_torch.ps import ParamServer

SIZE = 1024


def _announce_bytes(version: int, flags: int) -> bytes:
    if version == 1:
        return np.asarray([0, SIZE], np.int64).tobytes()
    if version == 2:
        return np.asarray([0, SIZE, 0], np.int64).tobytes()
    if version == 3:
        return jftw.init_v3(0, SIZE, 0, 0, flags).tobytes()
    raise AssertionError(version)


def _verdicts(version):
    """(flags, oracle outcome, port verdict, port posture or refusal)."""
    out = []
    for flags in (range(128) if version == 3 else [0]):
        want = schema.negotiate(version, flags)
        # client_ranks=[2] keeps the announcing rank 1 out of the gang's
        # clients, as the reference matrix does.
        server = ParamServer(0, [2], None, rule="add", device="cpu")
        try:
            server._negotiate(1, _announce_bytes(version, flags))
        except NotImplementedError as exc:
            out.append((flags, want, "later", str(exc)))
            continue
        except (ValueError, AssertionError) as exc:
            out.append((flags, want, "refused", str(exc)))
            continue
        posture = {
            "framed": server._framed.get(1, False),
            "heartbeat": server._hb.get(1, False),
            "staleness": server._stale_track.get(1, False),
            "timing": server._timing.get(1, False),
            "readonly": False, "subscribe": False, "chunked": False,
            "shardctl": False,
        }
        out.append((flags, want, "accepted", posture))
    return out


@pytest.mark.parametrize("version", [1, 2, 3])
def test_matrix_matches_oracle(version):
    mismatches = []
    for flags, want, verdict, detail in _verdicts(version):
        ctx = f"v{version} flags={flags:#04x}"
        if verdict == "later":
            if want.accepted:
                mismatches.append(f"{ctx}: the oracle accepts, the port refuses "
                                  f"as a later slice ({detail})")
            elif "slice" not in detail:
                mismatches.append(f"{ctx}: a later-slice refusal names no slice")
            continue
        if (verdict == "accepted") != want.accepted:
            mismatches.append(f"{ctx}: port {verdict}, oracle "
                              f"{'accepts' if want.accepted else 'refuses'} "
                              f"({want.reason or detail})")
            continue
        if verdict == "accepted":
            exp = {k: bool(getattr(want, k)) for k in detail}
            if detail != exp:
                mismatches.append(f"{ctx}: posture drift (oracle, port) = "
                                  f"{ {k: (exp[k], detail[k]) for k in exp if exp[k] != detail[k]} }")
    assert not mismatches, "\n".join(mismatches)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_the_timing_cells_are_accepted(version):
    """The cells this slice turns on: the 8 oracle-accepted cells that
    carry FLAG_TIMING are accepted, and timing negotiates on in the framed
    ones only (no frame, no stamp slot); no accepted cell of the port is
    one the oracle refuses."""
    rows = _verdicts(version)
    timing_bit = [f for f, w, v, _d in rows if v == "accepted" and f & 8]
    timing_on = [f for f, w, v, d in rows if v == "accepted" and d["timing"]]
    if version == 3:
        assert timing_bit == [f for f, w, _v, _d in rows if w.accepted and f & 8]
        assert len(timing_bit) == 8
        assert timing_on == [f for f, w, _v, _d in rows if w.accepted and w.timing]
        assert timing_on == [f for f in timing_bit if f & 1]
    else:
        assert timing_bit == timing_on == []
    assert not [f for f, w, v, _d in rows if v == "accepted" and not w.accepted]
    counts = {v: sum(1 for r in rows if r[2] == v) for v in ("accepted", "refused", "later")}
    assert counts == ({"accepted": 1, "refused": 0, "later": 0} if version < 3
                      else {"accepted": 16, "refused": 0, "later": 112})
