"""Plookup proof containers + transcript replay
(reference: plookup/src/proof.rs, openings.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..curves import host as chost
from ..fields import host as fhost
from ..hashing.challenger import Challenger
from ..protocol.halo import OpeningProof
from ..protocol.plonk_util import halo_n, scalar_to_bits_le, try_convert
from ..protocol.serialization import field_to_bytes, point_to_bytes

SECURITY_BITS = 128


@dataclass
class Opening:
    local: int
    right: int

    def to_vec(self):
        return [self.local, self.right]


@dataclass
class PlookupOpenings:
    f: Opening
    t: Opening
    h1: Opening
    h2: Opening
    z: Opening
    quotient: Opening

    def to_vec(self) -> List[int]:
        out = []
        for o in (self.f, self.t, self.h1, self.h2, self.z, self.quotient):
            out.extend(o.to_vec())
        return out

    def local(self) -> List[int]:
        return [o.local for o in
                (self.f, self.t, self.h1, self.h2, self.z, self.quotient)]

    def right(self) -> List[int]:
        return [o.right for o in
                (self.f, self.t, self.h1, self.h2, self.z, self.quotient)]


@dataclass
class PlookupChallenge:
    beta: int
    gamma: int
    alpha: int
    zeta: int
    v: int
    u: int
    u_scaling: int
    halo_us: List[int]
    schnorr_challenge: int


@dataclass
class PlookupProof:
    c_f: chost.AffinePoint
    c_t: chost.AffinePoint
    c_h1: chost.AffinePoint
    c_h2: chost.AffinePoint
    c_z: chost.AffinePoint
    c_quotient: chost.AffinePoint
    openings: PlookupOpenings
    halo_proof: OpeningProof
    n: int

    def to_bytes(self, curve) -> bytes:
        """A canonical encoding, in the order of the fields above: each
        point by point_to_bytes, each scalar by field_to_bytes (the
        openings as to_vec orders them; the Halo proof's L and R points,
        G, then the Schnorr proof's R, z1 and z2), n as 4 bytes, little
        endian."""
        sf = curve.scalar
        pts = [self.c_f, self.c_t, self.c_h1, self.c_h2, self.c_z,
               self.c_quotient]
        out = [point_to_bytes(curve, q) for q in pts]
        out += [field_to_bytes(sf, x) for x in self.openings.to_vec()]
        hp = self.halo_proof
        out += [point_to_bytes(curve, q)
                for q in (*hp.halo_l, *hp.halo_r, hp.halo_g,
                          hp.schnorr_proof.r)]
        out += [field_to_bytes(sf, hp.schnorr_proof.z1),
                field_to_bytes(sf, hp.schnorr_proof.z2),
                self.n.to_bytes(4, "little")]
        return b"".join(out)

    def get_challenges(self, curve) -> PlookupChallenge:
        """reference: plookup/src/proof.rs:67-130."""
        bf, sf = curve.base, curve.scalar
        challenger = Challenger(bf, SECURITY_BITS)
        challenger.observe_affine_points([self.c_f, self.c_t, self.c_h1,
                                          self.c_h2])
        beta_bf, gamma_bf = challenger.get_2_challenges()
        beta = try_convert(beta_bf, sf)
        gamma = try_convert(gamma_bf, sf)
        challenger.observe_affine_point(self.c_z)
        alpha = try_convert(challenger.get_challenge(), sf)
        challenger.observe_affine_point(self.c_quotient)
        zeta = try_convert(challenger.get_challenge(), sf)
        challenger.observe_elements(
            [try_convert(x, bf) for x in self.openings.to_vec()])
        v_bf, u_bf, us_bf = challenger.get_3_challenges()
        v = try_convert(v_bf, sf)
        u = try_convert(u_bf, sf)
        u_scaling = try_convert(us_bf, sf)
        halo_us = []
        for l, r in zip(self.halo_proof.halo_l, self.halo_proof.halo_r):
            challenger.observe_affine_points([l, r])
            r_sf = try_convert(challenger.get_challenge(), sf)
            u_j_sq = halo_n(curve, scalar_to_bits_le(r_sf, SECURITY_BITS))
            u_j = fhost.canonical_square_root(sf, u_j_sq)
            if u_j is None:   # an honest prover retries until it is a square
                raise ValueError("Invalid IPA proof: n(r) is not a square")
            halo_us.append(u_j)
        challenger.observe_affine_point(self.halo_proof.schnorr_proof.r)
        schnorr_challenge = try_convert(challenger.get_challenge(), sf)
        return PlookupChallenge(beta=beta, gamma=gamma, alpha=alpha,
                                zeta=zeta, v=v, u=u, u_scaling=u_scaling,
                                halo_us=halo_us,
                                schnorr_challenge=schnorr_challenge)
