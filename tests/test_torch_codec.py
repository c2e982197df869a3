"""The port's wire codecs against the JAX package's, byte for byte.

For ``none``, ``bf16`` and ``int8`` the same float32 input, made with
numpy from a seed, is encoded by ``mpit_tpu.comm.codec`` and by
``mpit_tpu_torch.comm.codec``: the frames must be identical bytes,
including the int8 codec's error-feedback residual over three rounds
(the residual of round k feeds round k+1).  Decoding a frame must give
the same floats on the host (``decode_into``) and on the server's device
path (``split_wire`` + ``decode_parts`` in torch), bit for bit: the
reference pins these bytes on its host path, and decode is one multiply
or a bit shift per element.

Only ``encode_into``/``decode_into`` of the JAX codec are called, never a
JAX server: a JAX server encoding a non-``none`` snapshot starts the JAX
package's process-global worker pool, which other test files of the
reference do not expect.
"""

import numpy as np
import pytest
import torch

from mpit_tpu.comm import codec as jax_codec
from mpit_tpu_torch.comm import codec

torch.set_num_threads(1)

# Lengths: under one int8 block, a whole number of blocks, and a ragged
# tail after several blocks.
SIZES = [5, 2048, 3000 + 7]


def _x(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    x[::7] = 0.0  # some exact zeros
    return x


def test_registry_matches_reference():
    assert codec.names() == jax_codec.names()
    for name in codec.names():
        port, ref = codec.get(name), jax_codec.get(name)
        assert (port.wire_id, port.identity, port.uses_residual) == (
            ref.wire_id, ref.identity, ref.uses_residual)
        assert codec.by_wire_id(port.wire_id) is port
        for n in SIZES:
            assert port.wire_nbytes(n) == ref.wire_nbytes(n)
    with pytest.raises(ValueError, match="unknown PS codec"):
        codec.get("fp8")
    with pytest.raises(ValueError, match="unknown codec wire id"):
        codec.by_wire_id(99)


@pytest.mark.parametrize("name", ["none", "bf16", "int8"])
@pytest.mark.parametrize("n", SIZES)
def test_frames_identical_to_reference(name, n):
    port, ref = codec.get(name), jax_codec.get(name)
    x = _x(n, n, scale=3.0)
    a = np.zeros(port.wire_nbytes(n), np.uint8)
    b = np.zeros(ref.wire_nbytes(n), np.uint8)
    port.encode_into(x, a)
    ref.encode_into(x, b)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_int8_error_feedback_identical_over_three_rounds(n):
    port, ref = codec.get("int8"), jax_codec.get("int8")
    r_port = np.zeros(n, np.float32)
    r_ref = np.zeros(n, np.float32)
    for k in range(3):
        x = _x(100 * k + n, n, scale=10.0 ** (k - 1))
        a = np.zeros(port.wire_nbytes(n), np.uint8)
        b = np.zeros(ref.wire_nbytes(n), np.uint8)
        port.encode_into(x, a, residual=r_port)
        ref.encode_into(x, b, residual=r_ref)
        assert a.tobytes() == b.tobytes(), f"round {k}"
        assert r_port.tobytes() == r_ref.tobytes(), f"round {k}"
        assert np.any(r_port != 0)


@pytest.mark.parametrize("name", ["none", "bf16", "int8"])
@pytest.mark.parametrize("n", SIZES)
def test_decode_identical_on_host_and_device_path(name, n):
    port, ref = codec.get(name), jax_codec.get(name)
    wire = np.zeros(ref.wire_nbytes(n), np.uint8)
    ref.encode_into(_x(n + 1, n, scale=2.0), wire)
    want = np.zeros(n, np.float32)
    ref.decode_into(wire, want)
    host = np.zeros(n, np.float32)
    port.decode_into(wire, host)
    assert host.tobytes() == want.tobytes()
    parts = [torch.from_numpy(v.copy()) for v in port.split_wire(wire, n)]
    dev = port.decode_parts(parts, n)
    assert dev.dtype == torch.float32 and dev.shape == (n,)
    assert dev.numpy().tobytes() == want.tobytes()
