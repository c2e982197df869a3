"""The port server's INIT negotiation against the wire-schema oracle: the
twin of ``tests/test_wire_matrix.py``'s ``TestNegotiationMatrix`` at its
three server postures — plain (no readers, no cells), ``reader`` (the
announcing rank is in ``reader_ranks``) and ``cell`` (it is in
``cell_ranks``) — for INIT v1-v5 and all 128 flag sets of v3, v4 and v5,
plus every legacy cell (v1-v3) announced to a plain server that already
speaks shard control.

For every cell the port's ``ParamServer._negotiate`` must agree with
``mpit_tpu.analysis.schema.negotiate`` (``reader_rank``/``serves_readers``,
``cell_rank``/``serves_cells``):

- a cell the oracle accepts is accepted, with the oracle's effective
  per-pair posture (framed, heartbeat, staleness, timing, readonly,
  subscribe, chunked, shardctl);
- a cell the oracle refuses is refused — loudly, with a ValueError as the
  JAX server refuses it, or with a NotImplementedError that names the
  slice of the port its flag belongs to.

The cells (counted by ``test_cell_counts``), as (accepted, refused,
refused as a later slice):

- plain: v1 and v2 (1, 0, 0); v3 (16, 112, 0): the 64 with FLAG_CHUNKED
  are refused as malformed (the chunk cut travels in INIT v5), and the 48
  others with FLAG_READONLY or FLAG_SUBSCRIBE as the reference refuses a
  non-reader's posture; v4 (64, 64, 0): the 64 with FLAG_FRAMED accepted as
  shard control (staleness and timing off, whatever the bits); v5 (8, 120,
  0): the 8 framed chunked writer sets, staleness off; a legacy
  announcement to a shard-control server, 130 cells, all refused;
- reader: v1 and v2 (0, 1, 0); v3 (8, 120, 0): the 8 READ-ONLY framed sets
  accepted with staleness and timing negotiated off; v4 (0, 128, 0), shard
  control excludes the serving tier; v5 (0, 128, 0): a reader does not
  stream;
- cell: v1 and v2 (0, 1, 0); v3 (8, 120, 0): the 8 READ-ONLY SUBSCRIBE
  framed sets, staleness and timing off; v4 (0, 128, 0); v5 (8, 120, 0):
  the chunk-framed subscriptions.

No cell is refused as a later slice's any more: the third count is 0.
"""

import numpy as np
import pytest

import mpit_tpu.ft.wire as jftw
import mpit_tpu.shardctl.wire as jscw
from mpit_tpu.analysis import schema
from mpit_tpu.shardctl.shardmap import ShardMap as JaxShardMap
from mpit_tpu_torch.ft import wire as ftw
from mpit_tpu_torch.ps import ParamServer
from mpit_tpu_torch.shardctl import ShardMap
from mpit_tpu_torch.shardctl import wire as scwire

SIZE = 1024
CHUNK_ELEMS = 1024  # one codec block: the smallest legal chunk cut

#: (name, ParamServer kwargs, oracle kwargs) — the announcing rank is 1
CONFIGS = {
    "plain": ({}, {}),
    "reader": ({"reader_ranks": [1]}, {"reader_rank": True, "serves_readers": True}),
    "cell": ({"cell_ranks": [1]}, {"cell_rank": True, "serves_cells": True}),
}


def _announce_bytes(version: int, flags: int) -> bytes:
    if version == 1:
        return np.asarray([0, SIZE], np.int64).tobytes()
    if version == 2:
        return np.asarray([0, SIZE, 0], np.int64).tobytes()
    if version == 3:
        return jftw.init_v3(0, SIZE, 0, 0, flags).tobytes()
    if version == 5:
        got = ftw.init_v5(0, SIZE, 0, 0, flags, CHUNK_ELEMS)
        assert got.tobytes() == jftw.init_v5(0, SIZE, 0, 0, flags, CHUNK_ELEMS).tobytes()
        return got.tobytes()
    if version == 4:
        got = scwire.init_v4(0, 0, flags, ShardMap.initial(SIZE, [0]))
        assert got.tobytes() == jscw.init_v4(
            0, 0, flags, JaxShardMap.initial(SIZE, [0])).tobytes()
        return got.tobytes()
    raise AssertionError(version)


def _verdicts(version, sc_server=False, config="plain"):
    """(flags, oracle outcome, port verdict, port posture or refusal);
    ``sc_server``: the server already negotiated shard control (a framed
    v4 client came first); ``config``: the server's serving posture."""
    server_kw, oracle_kw = CONFIGS[config]
    out = []
    for flags in (range(128) if version in (3, 4, 5) else [0]):
        want = schema.negotiate(version, flags, sc_server=sc_server, **oracle_kw)
        # client_ranks=[2] keeps the announcing rank 1 out of the gang's
        # clients, as the reference matrix does.
        server = ParamServer(0, [2], None, rule="add", device="cpu", **server_kw)
        if sc_server:
            server._negotiate(3, _announce_bytes(4, 1))
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
            "readonly": server._readonly.get(1, False),
            "subscribe": server._subscribe.get(1, False),
            "chunked": server._chunk.get(1, 0) > 0,
            "shardctl": server._sc,
        }
        out.append((flags, want, "accepted", posture))
    return out


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_matrix_matches_oracle(version):
    mismatches = _mismatches(version)
    assert not mismatches, "\n".join(mismatches)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_legacy_on_a_shardctl_server_matches_oracle(version):
    """A legacy announcement to a server that already speaks shard control
    is refused, as the oracle's ``sc_server`` posture says."""
    mismatches = _mismatches(version, sc_server=True)
    assert not mismatches, "\n".join(mismatches)
    assert all(v == "refused" for _f, _w, v, _d in _verdicts(version, sc_server=True))


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("config", ["reader", "cell"])
def test_reader_and_cell_postures_match_oracle(config, version):
    """The serving postures: a reader rank's and a cell rank's
    announcements to a server that serves them."""
    mismatches = _mismatches(version, config=config)
    assert not mismatches, "\n".join(mismatches)


def _mismatches(version, sc_server=False, config="plain"):
    mismatches = []
    for flags, want, verdict, detail in _verdicts(version, sc_server, config):
        ctx = f"{config} v{version} flags={flags:#04x}"
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
    return mismatches


def test_cell_counts():
    """The matrix's cells by version: accepted, refused, refused as a later
    slice (the module docstring's table)."""
    def counts(version, sc_server=False, config="plain"):
        rows = _verdicts(version, sc_server, config)
        return tuple(sum(1 for r in rows if r[2] == v)
                     for v in ("accepted", "refused", "later"))

    assert [counts(v) for v in (1, 2, 3, 4, 5)] == [(1, 0, 0), (1, 0, 0), (16, 112, 0),
                                                    (64, 64, 0), (8, 120, 0)]
    assert [counts(v, True) for v in (1, 2, 3)] == [(0, 1, 0), (0, 1, 0), (0, 128, 0)]
    assert [counts(v, config="reader") for v in (1, 2, 3, 4, 5)] == \
        [(0, 1, 0), (0, 1, 0), (8, 120, 0), (0, 128, 0), (0, 128, 0)]
    assert [counts(v, config="cell") for v in (1, 2, 3, 4, 5)] == \
        [(0, 1, 0), (0, 1, 0), (8, 120, 0), (0, 128, 0), (8, 120, 0)]
    v5 = [d for f, w, v, d in _verdicts(5) if v == "accepted"]
    assert all(d["chunked"] and d["framed"] and not d["staleness"] for d in v5)
    v5_cells = [d for f, w, v, d in _verdicts(5, config="cell") if v == "accepted"]
    assert all(d["chunked"] and d["subscribe"] and d["readonly"] for d in v5_cells)
    ro = [d for f, w, v, d in _verdicts(3, config="reader") if v == "accepted"]
    assert all(d["readonly"] and d["framed"] and not d["subscribe"]
               and not d["staleness"] and not d["timing"] for d in ro)
    sub = [d for f, w, v, d in _verdicts(3, config="cell") if v == "accepted"]
    assert all(d["readonly"] and d["subscribe"] and d["framed"]
               and not d["staleness"] and not d["timing"] for d in sub)
    v4 = [d for f, w, v, d in _verdicts(4) if v == "accepted"]
    assert all(d["shardctl"] and d["framed"] and not d["staleness"]
               and not d["timing"] for d in v4)


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
                      else {"accepted": 16, "refused": 112, "later": 0})
