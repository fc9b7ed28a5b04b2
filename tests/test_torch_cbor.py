"""The port's CBOR containers (plonky_tpu_torch.protocol.cbor and the CBOR
half of protocol/serialization.py) on the CPU.

Mirrors tests/test_serialization.py's three CBOR tests (the primitives,
a proof's and a vk's round trip) on the port, and holds the port's CBOR
bytes to the JAX package's: every committed fixture proof and vk (the
Tweedle fixtures and the Pasta ones) read by both packages from the same
bytes and written by both as CBOR, which must be equal byte for byte and
read back by the other package.  Host code only; nothing reaches a
device.
"""

import os

import numpy as np
import pytest

from plonky_tpu.curves import PALLAS as J_PALLAS
from plonky_tpu.curves import TWEEDLEDEE as J_DEE
from plonky_tpu.curves import VESTA as J_VESTA
from plonky_tpu.protocol import serialization as jser
from plonky_tpu_torch.curves import PALLAS, TWEEDLEDEE, TWEEDLEDUM, VESTA
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.protocol import cbor
from plonky_tpu_torch.protocol import serialization as ser
from plonky_tpu_torch.protocol.proof import OpeningSet, Proof, SchnorrProof
from plonky_tpu_torch.protocol.verifier import VerificationKey

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CURVE = TWEEDLEDEE
SF = CURVE.scalar
# (fixture suffix, port curve, JAX curve)
FIXTURE_CURVES = [("", TWEEDLEDEE, J_DEE), ("_pallas", PALLAS, J_PALLAS),
                  ("_vesta", VESTA, J_VESTA)]


@pytest.fixture
def rng():
    return np.random.default_rng(99)


def rand_field(rng, spec):
    return int.from_bytes(rng.bytes(40), "little") % spec.p


def rand_points(rng, n):
    g = chost.generator(CURVE)
    return [chost.mul(g, int(rng.integers(1, 1 << 62))) for _ in range(n)]


def rand_opening_set(rng, n_old):
    f = lambda k: [rand_field(rng, SF) for _ in range(k)]
    return OpeningSet(o_constants=f(6), o_plonk_sigmas=f(6), o_wires=f(9),
                      o_plonk_z=f(1)[0], o_plonk_t=f(7), o_old_proofs=f(n_old),
                      o_pi_quotient=f(1)[0])


def test_cbor_primitives():
    """tests/test_serialization.py:test_cbor_primitives on the port, and
    each value's bytes equal to the JAX package's encoder's."""
    from plonky_tpu.protocol import cbor as jcbor
    values = [0, 23, 24, 255, 256, 1 << 32, b"", b"\x01\x02", "hi",
              [1, b"x", "y", []], {"b": 1, "a": [2, 3]}]
    for v in values:
        assert cbor.decode(cbor.encode(v)) == v
        assert cbor.encode(v) == jcbor.encode(v)
    # RFC 8949 appendix A spot checks
    assert cbor.encode(0) == bytes([0x00])
    assert cbor.encode(24) == bytes([0x18, 24])
    assert cbor.encode(1000) == bytes([0x19, 0x03, 0xE8])
    assert cbor.encode("a") == bytes([0x61, 0x61])
    assert cbor.encode([1, 2]) == bytes([0x82, 0x01, 0x02])
    # canonical: map key order does not affect the encoding
    assert cbor.encode({"x": 1, "a": 2}) == cbor.encode({"a": 2, "x": 1})
    with pytest.raises(ValueError):
        cbor.decode(cbor.encode(5) + b"\x00")   # trailing bytes


def test_proof_cbor_roundtrip(rng):
    proof = Proof(
        c_wires=rand_points(rng, 9), c_plonk_z=rand_points(rng, 1)[0],
        c_plonk_t=rand_points(rng, 7), c_pis_quotient=rand_points(rng, 1)[0],
        o_local=rand_opening_set(rng, 1), o_right=rand_opening_set(rng, 1),
        o_below=rand_opening_set(rng, 1), halo_l=rand_points(rng, 4),
        halo_r=rand_points(rng, 4), halo_g=rand_points(rng, 1)[0],
        schnorr_proof=SchnorrProof(rand_points(rng, 1)[0], rand_field(rng, SF),
                                   rand_field(rng, SF)))
    data = ser.proof_to_cbor(CURVE, proof)
    assert ser.proof_from_cbor(CURVE, data) == proof
    obj = cbor.decode(data)
    assert obj["format"] == "plonky_tpu.proof"
    assert obj["curve"] == CURVE.name
    assert ser.proof_to_cbor(CURVE, proof) == data
    with pytest.raises(ValueError):
        ser.proof_from_cbor(TWEEDLEDUM, data)


def test_vk_cbor_roundtrip(rng):
    vk = VerificationKey(
        c_constants=rand_points(rng, 6), c_s_sigmas=rand_points(rng, 6),
        degree=1 << 10, num_public_inputs=3, num_gates_without_pis=1000,
        security_bits=128, curve=CURVE)
    data = ser.vk_to_cbor(vk)
    back = ser.vk_from_cbor(CURVE, data)
    assert back.c_constants == vk.c_constants
    assert back.c_s_sigmas == vk.c_s_sigmas
    assert (back.degree, back.num_public_inputs, back.num_gates_without_pis,
            back.security_bits) == (1 << 10, 3, 1000, 128)
    assert cbor.decode(data)["format"] == "plonky_tpu.vk"
    with pytest.raises(ValueError):
        ser.vk_from_cbor(TWEEDLEDUM, data)


def _hex(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return bytes.fromhex(f.read().strip())


@pytest.mark.parametrize("suffix,curve,jcurve", FIXTURE_CURVES,
                         ids=[c.name for _s, c, _j in FIXTURE_CURVES])
def test_fixture_cbor_bytes_match_jax(suffix, curve, jcurve):
    """The committed fixtures as CBOR, by each package: equal bytes, and
    each package reads the other's CBOR back to the same proof and vk
    bytes."""
    names = ["trivial", "sum_pi"] + (["curve_add"] if not suffix else [])
    for name in names:
        raw = _hex(f"proof_{name}{suffix}.hex")
        data = ser.proof_to_cbor(curve, ser.proof_from_bytes(curve, raw))
        assert data == jser.proof_to_cbor(jcurve, jser.proof_from_bytes(jcurve, raw))
        assert ser.proof_to_bytes(curve, ser.proof_from_cbor(curve, data)) == raw
        assert jser.proof_to_bytes(jcurve, jser.proof_from_cbor(jcurve, data)) == raw

        raw = _hex(f"vk_{name}{suffix}.hex")
        data = ser.vk_to_cbor(ser.vk_from_bytes(curve, raw))
        assert data == jser.vk_to_cbor(jser.vk_from_bytes(jcurve, raw))
        assert ser.vk_to_bytes(ser.vk_from_cbor(curve, data)) == raw
        assert jser.vk_to_bytes(jser.vk_from_cbor(jcurve, data)) == raw
