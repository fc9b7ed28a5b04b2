"""Canonical serialization (reference: src/serialization.rs).

Field elements: canonical little-endian, BYTES = ceil(bits/8) wide
(reference: serialization.rs:17-30).
Curve points: compressed -- a parity byte (y's low bit) followed by x's
bytes; the zero point uses parity byte 2 (the reference recovers y via a
square root on read, reference: serialization.rs:32-72).
Proof / VerificationKey: a deterministic tagged byte stream with u32-LE
length prefixes (the reference uses serde/CBOR as the container; the
byte-level field/point encodings match its canonical primitives)."""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..curves import host as chost
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..fields.spec import FieldSpec
from .proof import OpeningSet, Proof, SchnorrProof
from .verifier import VerificationKey


def field_to_bytes(spec: FieldSpec, x: int) -> bytes:
    return int(x % spec.p).to_bytes(spec.bytes_, "little")


def field_from_bytes(spec: FieldSpec, b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= spec.p:
        raise ValueError("field element out of range")
    return v


def point_to_bytes(curve: CurveSpec, pt: chost.AffinePoint) -> bytes:
    if pt.zero:
        return bytes([2]) + bytes(curve.base.bytes_)
    return bytes([pt.y & 1]) + field_to_bytes(curve.base, pt.x)


def point_from_bytes(curve: CurveSpec, b: bytes) -> chost.AffinePoint:
    parity = b[0]
    if parity == 2:
        return chost.zero_point(curve)
    x = field_from_bytes(curve.base, b[1:])
    p = curve.base.p
    y = fhost.square_root(curve.base, (x * x % p * x + curve.b) % p)
    if y is None:
        raise ValueError("invalid compressed point")
    if y & 1 != parity:
        y = (-y) % p
    return chost.AffinePoint(curve, x, y)


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def field(self, spec, x):
        self.parts.append(field_to_bytes(spec, x))

    def fields(self, spec, xs):
        self.u32(len(xs))
        for x in xs:
            self.field(spec, x)

    def point(self, curve, pt):
        self.parts.append(point_to_bytes(curve, pt))

    def points(self, curve, pts):
        self.u32(len(pts))
        for pt in pts:
            self.point(curve, pt)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.off)[0]
        self.off += 4
        return v

    def field(self, spec) -> int:
        b = self.data[self.off:self.off + spec.bytes_]
        self.off += spec.bytes_
        return field_from_bytes(spec, b)

    def fields(self, spec):
        return [self.field(spec) for _ in range(self.u32())]

    def point(self, curve):
        nb = 1 + curve.base.bytes_
        b = self.data[self.off:self.off + nb]
        self.off += nb
        return point_from_bytes(curve, b)

    def points(self, curve):
        return [self.point(curve) for _ in range(self.u32())]


def _write_opening_set(w: _Writer, spec, os_: OpeningSet):
    w.fields(spec, os_.o_constants)
    w.fields(spec, os_.o_plonk_sigmas)
    w.fields(spec, os_.o_wires)
    w.field(spec, os_.o_plonk_z)
    w.fields(spec, os_.o_plonk_t)
    w.fields(spec, os_.o_old_proofs)
    w.field(spec, os_.o_pi_quotient)


def _read_opening_set(r: _Reader, spec) -> OpeningSet:
    return OpeningSet(
        o_constants=r.fields(spec),
        o_plonk_sigmas=r.fields(spec),
        o_wires=r.fields(spec),
        o_plonk_z=r.field(spec),
        o_plonk_t=r.fields(spec),
        o_old_proofs=r.fields(spec),
        o_pi_quotient=r.field(spec),
    )


def proof_to_bytes(curve: CurveSpec, proof: Proof) -> bytes:
    sf = curve.scalar
    w = _Writer()
    w.points(curve, proof.c_wires)
    w.point(curve, proof.c_plonk_z)
    w.points(curve, proof.c_plonk_t)
    w.point(curve, proof.c_pis_quotient)
    for os_ in proof.all_opening_sets():
        _write_opening_set(w, sf, os_)
    w.points(curve, proof.halo_l)
    w.points(curve, proof.halo_r)
    w.point(curve, proof.halo_g)
    w.point(curve, proof.schnorr_proof.r)
    w.field(sf, proof.schnorr_proof.z1)
    w.field(sf, proof.schnorr_proof.z2)
    return w.bytes()


def proof_from_bytes(curve: CurveSpec, data: bytes) -> Proof:
    sf = curve.scalar
    r = _Reader(data)
    c_wires = r.points(curve)
    c_plonk_z = r.point(curve)
    c_plonk_t = r.points(curve)
    c_pis_quotient = r.point(curve)
    o_local = _read_opening_set(r, sf)
    o_right = _read_opening_set(r, sf)
    o_below = _read_opening_set(r, sf)
    halo_l = r.points(curve)
    halo_r = r.points(curve)
    halo_g = r.point(curve)
    sp_r = r.point(curve)
    z1 = r.field(sf)
    z2 = r.field(sf)
    return Proof(c_wires=c_wires, c_plonk_z=c_plonk_z, c_plonk_t=c_plonk_t,
                 c_pis_quotient=c_pis_quotient, o_local=o_local,
                 o_right=o_right, o_below=o_below, halo_l=halo_l,
                 halo_r=halo_r, halo_g=halo_g,
                 schnorr_proof=SchnorrProof(sp_r, z1, z2))


def vk_to_bytes(vk: VerificationKey) -> bytes:
    """Serializes the commitment data (the reference's VerificationKey also
    optionally carries FFT/MSM precomputations, which it strips for size --
    reference: verifier.rs:35-46; ours are recomputed on load)."""
    curve = vk.curve
    w = _Writer()
    w.points(curve, vk.c_constants)
    w.points(curve, vk.c_s_sigmas)
    w.u32(vk.degree)
    w.u32(vk.num_public_inputs)
    w.u32(vk.num_gates_without_pis)
    w.u32(vk.security_bits)
    return w.bytes()


def vk_from_bytes(curve: CurveSpec, data: bytes) -> VerificationKey:
    r = _Reader(data)
    c_constants = r.points(curve)
    c_s_sigmas = r.points(curve)
    degree = r.u32()
    num_public_inputs = r.u32()
    num_gates_without_pis = r.u32()
    security_bits = r.u32()
    return VerificationKey(c_constants=c_constants, c_s_sigmas=c_s_sigmas,
                           degree=degree, num_public_inputs=num_public_inputs,
                           num_gates_without_pis=num_gates_without_pis,
                           security_bits=security_bits, curve=curve)
