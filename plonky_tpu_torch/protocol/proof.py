"""Proof containers and transcript replay (reference: src/plonk_proof.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..curves import host as chost
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..hashing.challenger import Challenger
from .plonk_util import halo_g, halo_n, halo_s, scalar_to_bits_le, try_convert

SECURITY_BITS = 128


@dataclass
class SchnorrProof:
    r: chost.AffinePoint
    z1: int
    z2: int


@dataclass
class OpeningSet:
    """Openings of all polynomials at one point (reference: plonk_proof.rs:282-312)."""
    o_constants: List[int]
    o_plonk_sigmas: List[int]
    o_wires: List[int]
    o_plonk_z: int
    o_plonk_t: List[int]
    o_old_proofs: List[int]
    o_pi_quotient: int

    def to_vec(self) -> List[int]:
        """Canonical transcript ordering (reference: :299-312)."""
        return (list(self.o_constants) + list(self.o_plonk_sigmas)
                + list(self.o_wires) + [self.o_plonk_z]
                + list(self.o_plonk_t) + list(self.o_old_proofs)
                + [self.o_pi_quotient])


@dataclass
class OldProof:
    """Deferred G-point check data (reference: plonk_proof.rs:141-160)."""
    halo_g: chost.AffinePoint
    halo_us: List[int]

    def coeffs(self, spec) -> List[int]:
        return halo_s(spec, self.halo_us)

    def evaluate_g(self, spec, x: int) -> int:
        return halo_g(spec, x, self.halo_us)


@dataclass
class ProofChallenge:
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
class Proof:
    c_wires: List[chost.AffinePoint]
    c_plonk_z: chost.AffinePoint
    c_plonk_t: List[chost.AffinePoint]
    c_pis_quotient: chost.AffinePoint
    o_local: OpeningSet
    o_right: OpeningSet
    o_below: OpeningSet
    halo_l: List[chost.AffinePoint]
    halo_r: List[chost.AffinePoint]
    halo_g: chost.AffinePoint
    schnorr_proof: SchnorrProof

    def all_opening_sets(self):
        return [self.o_local, self.o_right, self.o_below]

    def get_challenges(self, curve: CurveSpec, public_inputs: List[int],
                       old_proofs: List[OldProof]) -> ProofChallenge:
        """Full transcript replay (reference: plonk_proof.rs:59-126)."""
        bf = curve.base
        sf = curve.scalar
        challenger = Challenger(bf, SECURITY_BITS)
        challenger.observe_affine_points(self.c_wires)
        beta_bf, gamma_bf = challenger.get_2_challenges()
        beta = try_convert(beta_bf, sf)
        gamma = try_convert(gamma_bf, sf)
        challenger.observe_affine_point(self.c_plonk_z)
        alpha = try_convert(challenger.get_challenge(), sf)
        challenger.observe_affine_points(self.c_plonk_t)
        challenger.observe_affine_point(self.c_pis_quotient)
        challenger.observe_elements(
            [try_convert(pi, bf) for pi in public_inputs])
        for old in old_proofs:
            challenger.observe_affine_point(old.halo_g)
        zeta = try_convert(challenger.get_challenge(), sf)
        for os_ in self.all_opening_sets():
            for f in os_.to_vec():
                challenger.observe_element(try_convert(f, bf))
        v_bf, u_bf, us_bf = challenger.get_3_challenges()
        v = try_convert(v_bf, sf)
        u = try_convert(u_bf, sf)
        u_scaling = try_convert(us_bf, sf)

        halo_us = []
        for l, r in zip(self.halo_l, self.halo_r):
            challenger.observe_affine_points([l, r])
            r_bf = challenger.get_challenge()
            r_sf = try_convert(r_bf, sf)
            u_j_sq = halo_n(curve, scalar_to_bits_le(r_sf, SECURITY_BITS))
            u_j = fhost.canonical_square_root(sf, u_j_sq)
            if u_j is None:
                raise ValueError(
                    "Invalid transcript. Prover should have ensured n(r) square")
            halo_us.append(u_j)

        challenger.observe_affine_point(self.schnorr_proof.r)
        schnorr_challenge = try_convert(challenger.get_challenge(), sf)

        return ProofChallenge(beta=beta, gamma=gamma, alpha=alpha, zeta=zeta,
                              v=v, u=u, u_scaling=u_scaling, halo_us=halo_us,
                              schnorr_challenge=schnorr_challenge)
