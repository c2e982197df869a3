"""The port's worker pool (``mpit_tpu_torch/comm/pool.py`` over the port's
native ``mt_pool_*``): twins of ``tests/test_pool.py``.

* **Pooled-vs-serial bitwise parity.**  Every kernel the pool runs (codec
  encode/decode, XOR, chunk gather/scatter) gives the serial
  fallback's bytes — per codec, per chunk geometry (block-aligned and
  tailed shards), per thread count, across seeds — and those bytes are the
  JAX package's (its serial pool, which starts no thread and leaves its
  process-global pool alone).  Includes int8 error-feedback exactness under
  a chunk retry.
* **Lifecycle.**  ``close()`` drains queued jobs, a submit after close
  raises :class:`PoolClosedError` (serial pools too), 32 open/close cycles
  leak no OS thread, ``done()`` polls, and ``configure`` replaces and
  closes the previous process-wide pool (the test puts the process's pool
  back as it was).

The parity suite needs the compiled library; without a toolchain it skips.
"""

import numpy as np
import pytest

from mpit_tpu.comm import codec as jcodec
from mpit_tpu.comm import pool as jpool
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm import pool as pool_mod

HAVE_NATIVE = pool_mod._load_native() is not None

pooled = pytest.mark.skipif(
    not HAVE_NATIVE, reason="native pool library unavailable (serial fallback only)")

BLOCK = codec_mod.BLOCK
#: one block-aligned shard, one tailed (size % BLOCK != 0) shard
SIZES = [3 * BLOCK, 5 * BLOCK + 137]
SEEDS = range(5)
CODEC_NAMES = ["none", "bf16", "int8"]


def rnd(n, seed, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def chunk_bounds(size):
    """One interior block-aligned chunk plus the (possibly tailed) trailing
    chunk — the chunk geometry int8 frames require."""
    mid = max(BLOCK, (size // (2 * BLOCK)) * BLOCK)
    return [(0, mid), (mid, size)]


def _encode_chunks(pool, codec, x, residual):
    """Encode every chunk of ``x`` through ``pool``, collected in submission
    order; returns the per-chunk wire frames."""
    wires, jobs = [], []
    for lo, hi in chunk_bounds(x.size):
        wire = np.zeros(codec.wire_nbytes(hi - lo), np.uint8)
        res = residual[lo:hi] if residual is not None else None
        jobs.append(pool.submit_encode(codec, x[lo:hi], wire, res))
        wires.append(wire)
    for j in jobs:
        j.result()
    return wires


def test_constants_equal_the_jax_package():
    for name in ("ENV_THREADS", "KIND_INT8_ENC", "KIND_INT8_DEC", "KIND_BF16_ENC",
                 "KIND_BF16_DEC", "KIND_XOR", "KIND_FOLD_F32", "KIND_COPY",
                 "KIND_NAMES"):
        assert getattr(pool_mod, name) == getattr(jpool, name), name


@pytest.mark.parametrize("raw,expect", [("", None), ("0", 0), ("3", 3), ("-2", 0),
                                        ("x", None)])
def test_configured_threads_equals_the_jax_package(raw, expect, monkeypatch):
    monkeypatch.setenv("MPIT_POOL_THREADS", raw)
    got = pool_mod.configured_threads()
    assert got == jpool.configured_threads()
    assert got == (pool_mod.default_threads() if expect is None else expect)


@pooled
@pytest.mark.parametrize("threads", [1, 2, 4])
class TestPooledSerialParity:
    """Bitwise equality: pooled kernels vs the serial fallback vs the JAX
    package's serial bytes."""

    def test_codec_chunk_roundtrip_bitwise(self, threads):
        pool = pool_mod.WorkerPool(threads)
        serial = pool_mod.WorkerPool(0)
        jserial = jpool.WorkerPool(0)
        try:
            assert not pool.serial and pool.threads == threads and serial.serial
            for seed in SEEDS:
                for name in CODEC_NAMES:
                    codec, jc = codec_mod.get(name), jcodec.get(name)
                    for size in SIZES:
                        x = rnd(size, seed)
                        res = [np.zeros(size, np.float32) if codec.uses_residual
                               else None for _ in range(3)]
                        wp = _encode_chunks(pool, codec, x, res[0])
                        ws = _encode_chunks(serial, codec, x, res[1])
                        wj = _encode_chunks(jserial, jc, x, res[2])
                        for a, b, c in zip(wp, ws, wj):
                            assert a.tobytes() == b.tobytes() == c.tobytes(), (
                                seed, name, size)
                        if codec.uses_residual:
                            assert np.array_equal(res[0], res[1])
                            assert np.array_equal(res[1], res[2])
                        out_p = np.zeros(size, np.float32)
                        out_s = np.zeros(size, np.float32)
                        jobs = []
                        for (lo, hi), w in zip(chunk_bounds(size), ws):
                            jobs.append(pool.submit_decode(codec, w, out_p[lo:hi]))
                            serial.submit_decode(codec, w, out_s[lo:hi]).result()
                        for j in jobs:
                            j.result()
                        assert out_p.tobytes() == out_s.tobytes(), (seed, name, size)
        finally:
            pool.close()
            serial.close()
            jserial.close()

    def test_xor_bitwise(self, threads):
        """The XOR (the cells' deltas), pooled, serial and through the
        synchronous entry.  (The f32 fold is the aggregation tree's, a later
        slice.)"""
        pool = pool_mod.WorkerPool(threads)
        serial = pool_mod.WorkerPool(0)
        try:
            for seed in SEEDS:
                rng = np.random.default_rng(seed)
                n = int(rng.integers(BLOCK, 4 * BLOCK))
                a = rng.integers(0, 256, n).astype(np.uint8)
                b = rng.integers(0, 256, n).astype(np.uint8)
                out_p, out_s, out_y = (np.empty(n, np.uint8) for _ in range(3))
                pool.submit_xor(a, b, out_p).result()
                serial.submit_xor(a, b, out_s).result()
                pool.xor_sync(a, b, out_y)
                assert out_p.tobytes() == out_s.tobytes() == out_y.tobytes() \
                    == np.bitwise_xor(a, b).tobytes()
        finally:
            pool.close()
            serial.close()

    def test_gather_scatter_bitwise(self, threads):
        pool = pool_mod.WorkerPool(threads)
        serial = pool_mod.WorkerPool(0)
        try:
            for seed in SEEDS:
                for name in CODEC_NAMES:
                    codec, jc = codec_mod.get(name), jcodec.get(name)
                    for size in SIZES:
                        full = np.zeros(codec.wire_nbytes(size), np.uint8)
                        serial.submit_encode(
                            codec, rnd(size, seed), full,
                            np.zeros(size, np.float32) if codec.uses_residual
                            else None).result()
                        for lo, hi in chunk_bounds(size):
                            nb = codec.wire_nbytes(hi - lo)
                            c_p, c_s, c_j = (np.zeros(nb, np.uint8) for _ in range(3))
                            pool.submit_gather(codec, full, size, lo, hi, c_p).result()
                            serial.submit_gather(codec, full, size, lo, hi, c_s).result()
                            jcodec.gather_chunk(jc, full, size, lo, hi, c_j)
                            assert c_p.tobytes() == c_s.tobytes() == c_j.tobytes()
                            assert codec.chunk_regions(size, lo, hi) \
                                == jc.chunk_regions(size, lo, hi)
                            f_p, f_s = np.zeros_like(full), np.zeros_like(full)
                            pool.submit_scatter(codec, f_p, size, lo, hi, c_s).result()
                            serial.submit_scatter(codec, f_s, size, lo, hi, c_s).result()
                            assert f_p.tobytes() == f_s.tobytes()
        finally:
            pool.close()
            serial.close()

    def test_int8_residual_exact_under_chunk_retry(self, threads):
        """A chunk retry re-encodes from the pre-encode residual snapshot:
        the retried frame and the post-encode residual are bit-identical to
        the first attempt's, pooled and serial alike."""
        pool = pool_mod.WorkerPool(threads)
        serial = pool_mod.WorkerPool(0)
        codec = codec_mod.get("int8")
        try:
            for seed in SEEDS:
                size = 5 * BLOCK + 137
                x = rnd(size, seed)
                res0 = rnd(size, seed + 100, scale=0.01)  # warm EF state
                for lo, hi in chunk_bounds(size):
                    nb = codec.wire_nbytes(hi - lo)
                    frames, residuals = [], []
                    for p in (pool, serial):
                        for _attempt in range(2):  # original + retry
                            res = res0.copy()
                            wire = np.zeros(nb, np.uint8)
                            p.submit_encode(codec, x[lo:hi], wire, res[lo:hi]).result()
                            frames.append(wire.tobytes())
                            residuals.append(res.tobytes())
                    assert len(set(frames)) == 1, (seed, lo, hi)
                    assert len(set(residuals)) == 1, (seed, lo, hi)
        finally:
            pool.close()
            serial.close()


def _os_threads() -> int:
    """This process's OS thread count (native pool workers are pthreads the
    threading module does not see)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    raise AssertionError("no Threads: line in /proc/self/status")


@pytest.fixture
def global_pool_restored():
    """configure() replaces the process-wide pool and closes the one it
    replaces: close what the test made and leave the process without a pool
    (the next ``get_pool`` makes a fresh one), never with a closed one."""
    yield
    made, pool_mod._GLOBAL = pool_mod._GLOBAL, None
    if made is not None:
        made.close()


class TestLifecycle:
    def test_submit_after_close_raises_serial(self):
        pool = pool_mod.WorkerPool(0)
        pool.close()
        with pytest.raises(pool_mod.PoolClosedError):
            pool.submit_xor(np.zeros(8, np.uint8), np.zeros(8, np.uint8),
                            np.zeros(8, np.uint8))

    @pooled
    def test_close_drains_queued_jobs(self):
        pool = pool_mod.WorkerPool(1)
        n = 1 << 20
        a = np.random.default_rng(0).integers(0, 256, n).astype(np.uint8)
        b = np.random.default_rng(1).integers(0, 256, n).astype(np.uint8)
        outs = [np.zeros(n, np.uint8) for _ in range(8)]
        jobs = [pool.submit_xor(a, b, out) for out in outs]
        pool.close()  # must drain, not drop
        expect = np.bitwise_xor(a, b).tobytes()
        for out in outs:
            assert out.tobytes() == expect
        for j in jobs:  # collecting after close is a no-op, not a hang
            j.result()
            assert j.done()
        with pytest.raises(pool_mod.PoolClosedError):
            pool.submit_copy(a, outs[0])

    @pooled
    def test_no_thread_leak_across_open_close_cycles(self):
        a = np.arange(4096, dtype=np.uint8)
        b = a[::-1].copy()
        out = np.empty_like(a)
        p = pool_mod.WorkerPool(2)  # a first cycle warms lazy state
        p.submit_xor(a, b, out).result()
        p.close()
        before = _os_threads()
        for _ in range(32):
            p = pool_mod.WorkerPool(2)
            assert p.threads == 2
            p.submit_xor(a, b, out).result()
            p.close()
            p.close()  # idempotent
        assert _os_threads() == before

    @pooled
    def test_done_polls_without_blocking(self):
        pool = pool_mod.WorkerPool(1)
        try:
            n = 1 << 22
            a = np.zeros(n, np.uint8)
            b = np.ones(n, np.uint8)
            out = np.empty(n, np.uint8)
            job = pool.submit_xor(a, b, out)
            while not job.done():  # scheduler-style poll, no result()
                pass
            assert out.tobytes() == np.bitwise_xor(a, b).tobytes()
        finally:
            pool.close()

    def test_configure_replaces_and_closes_previous(self, global_pool_restored):
        first = pool_mod.configure(0)
        second = pool_mod.configure(0)
        assert second is pool_mod.get_pool()
        assert second is not first
        assert pool_mod.current_pool() is second
        with pytest.raises(pool_mod.PoolClosedError):
            first.submit_copy(np.zeros(4, np.uint8), np.zeros(4, np.uint8))

    def test_status_section_shape(self, global_pool_restored):
        """The /status ``pool`` section and ``top``'s source: the JAX keys."""
        p = pool_mod.configure(2 if HAVE_NATIVE else 0)
        status = p.status()
        assert set(status) == {"threads", "serial", "depth", "jobs_total",
                               "busy_seconds"}
        assert status["serial"] == (not HAVE_NATIVE)
