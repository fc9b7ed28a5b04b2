"""Halo inner-product argument: batched opening proof and verification
(reference: src/halo.rs).

The host drives the sequential log(n) rounds and the transcript / retry loop
(blinding until n(r) is a square, reference: halo.rs:82-114); the vector
work of each round runs on the circuit's device.

Weight-tracked rounds: the basis G never folds.  Original index k carries
a running weight w_k (the product of the u_j / u_j^-1 factors picked by
bit j-1 of k, the halo_s structure), and each round's
    L_j = <a_lo, G'_hi>,  R_j = <a_hi, G'_lo>
is ONE K=2 multi-MSM over the original points with scalars
    s_L[k] = w_k a[k mod half] bit_{j-1}(k)
    s_R[k] = w_k a[(k mod half) + half] (1 - bit_{j-1}(k)).
a and b stay full width (live entries in the first n_j positions, folded
by a roll and a mask), and the final halo_g is one more MSM with the final
weights (= halo_s(us)).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List

import torch

from ..curves import host as chost
from ..curves import msm as cmsm
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import require_eight_limbs
from ..poly.fft import powers_dyn
from .plonk_util import halo_n, halo_n_mul, powers, scalar_to_bits_le, try_convert
from .proof import SchnorrProof

# Deterministic-test hook (blinding factors + schnorr nonces), looked up at
# call time.
RANDOM_SOURCE = lambda p: secrets.randbelow(p)


@dataclass
class OpeningProof:
    halo_l: List[chost.AffinePoint]
    halo_r: List[chost.AffinePoint]
    halo_g: chost.AffinePoint
    schnorr_proof: SchnorrProof


def _ipa_round_scalars(sf, w, a, b, idx_lo, idx_hi, bit, mask_lo, half):
    """MSM scalars s_L, s_R and the inner products <a_lo, b_hi>,
    <a_hi, b_lo> over the live entries."""
    zero = torch.zeros_like(w)
    s_l = fops.select(bit, fops.mul(sf, w, a[:, idx_lo]), zero)
    s_r = fops.select(~bit, fops.mul(sf, w, a[:, idx_hi]), zero)
    b_roll = torch.roll(b, -half, dims=-1)
    a_roll = torch.roll(a, -half, dims=-1)
    ip_lo_hi = fops.sum_reduce(
        sf, fops.select(mask_lo, fops.mul(sf, a, b_roll), zero), 0)
    ip_hi_lo = fops.sum_reduce(
        sf, fops.select(mask_lo, fops.mul(sf, a_roll, b), zero), 0)
    return s_l, s_r, ip_lo_hi, ip_hi_lo


def _ipa_fold(sf, w, a, b, u_col, u_inv_col, bit, mask_lo, half):
    """a' = u_inv a_hi + u a_lo ; b' = u_inv b_lo + u b_hi (live < half);
    w_k *= u if bit_{j-1}(k) else u_inv."""
    zero = torch.zeros_like(w)
    a_new, b_new = fops.product_sums(sf, [
        [(u_inv_col, torch.roll(a, -half, dims=-1), 1), (u_col, a, 1)],
        [(u_inv_col, b, 1), (u_col, torch.roll(b, -half, dims=-1), 1)]])
    factor = fops.select(bit, u_col, u_inv_col)
    return (fops.mul(sf, w, factor), fops.select(mask_lo, a_new, zero),
            fops.select(mask_lo, b_new, zero))


def batch_opening_proof(
    polynomials_coeffs: torch.Tensor,   # [LIMBS, K, n]
    commitments_randomness: List[int],
    opening_points: List[int],
    pedersen_g: cmsm.MsmBasis,
    pedersen_h: chost.AffinePoint,
    u_curve: chost.AffinePoint,
    u: int,
    v: int,
    u_scaling: int,
    degree: int,
    security_bits: int,
    challenger,
    curve: CurveSpec,
) -> OpeningProof:
    """reference: src/halo.rs:16-141."""
    sf = curve.scalar
    require_eight_limbs(sf, "batch_opening_proof")
    p = sf.p
    dev = polynomials_coeffs.device
    K = polynomials_coeffs.shape[1]

    # n(u^i) scalars (reference: halo.rs:33-38)
    actual_scalars = [
        halo_n(curve, scalar_to_bits_le(ui, security_bits))
        for ui in powers(sf, u, K)
    ]

    # reduce all coefficient vectors into one: sum_i n(u^i) * coeffs_i
    halo_a = fops.product_sum(sf, [
        (fops.column(sf, s, dev), polynomials_coeffs[:, i], 1)
        for i, s in enumerate(actual_scalars)])

    u_prime = halo_n_mul(curve, scalar_to_bits_le(u_scaling, security_bits),
                         u_curve)

    # halo_b: v-weighted combination of powers of the opening points
    # (reference: halo.rs:143-155)
    halo_b = _build_halo_b(sf, degree, opening_points, v, dev)

    halo_l: List[chost.AffinePoint] = []
    halo_r: List[chost.AffinePoint] = []
    randomness = 0
    for s, r in zip(actual_scalars, commitments_randomness):
        randomness = (randomness + s * r) % p

    degree_pow = degree.bit_length() - 1
    from .circuit import (commit_window_bits, device_point_to_host,
                          device_points_to_host)
    window = commit_window_bits(degree)

    k_idx = torch.arange(degree, device=dev)
    w_dev = fops.constant(sf, 1, (degree,), dev).contiguous()
    a_dev = halo_a
    b_dev = halo_b

    for j in range(degree_pow, 0, -1):
        half = 1 << (j - 1)
        bit = ((k_idx >> (j - 1)) & 1).to(torch.bool)
        idx_lo = k_idx % half
        idx_hi = idx_lo + half
        mask_lo = k_idx < half

        s_l, s_r, ip_lo_d, ip_hi_d = _ipa_round_scalars(
            sf, w_dev, a_dev, b_dev, idx_lo, idx_hi, bit, mask_lo, half)
        both = cmsm.msm(curve, pedersen_g, torch.stack([s_l, s_r], dim=1),
                        window)
        l_msm, r_msm = device_points_to_host(curve, both)
        ip_lo_hi = fops.to_ints(sf, ip_lo_d)
        ip_hi_lo = fops.to_ints(sf, ip_hi_d)

        while True:
            l_blind = RANDOM_SOURCE(p)
            r_blind = RANDOM_SOURCE(p)
            halo_l_j = chost.add(chost.add(l_msm, chost.mul(pedersen_h, l_blind)),
                                 chost.mul(u_prime, ip_lo_hi))
            halo_r_j = chost.add(chost.add(r_msm, chost.mul(pedersen_h, r_blind)),
                                 chost.mul(u_prime, ip_hi_lo))
            fork = _clone_challenger(challenger)
            fork.observe_affine_points([halo_l_j, halo_r_j])
            r_bf = fork.get_challenge()
            r_sf = try_convert(r_bf, sf)
            u_j_squared = halo_n(curve, scalar_to_bits_le(r_sf, security_bits))
            u_j = fhost.canonical_square_root(sf, u_j_squared)
            if u_j is not None:
                u_sq_inv = pow(u_j_squared, -1, p)
                halo_l.append(halo_l_j)
                halo_r.append(halo_r_j)
                randomness = (randomness + u_j_squared * l_blind
                              + u_sq_inv * r_blind) % p
                _copy_challenger(fork, challenger)
                break

        u_j_inv = pow(u_j, -1, p)
        w_dev, a_dev, b_dev = _ipa_fold(
            sf, w_dev, a_dev, b_dev, fops.column(sf, u_j, dev),
            fops.column(sf, u_j_inv, dev), bit, mask_lo, half)

    # halo_g = <w_final, G>
    gpt = cmsm.msm(curve, pedersen_g, w_dev[:, None], window)
    halo_g_pt = device_point_to_host(curve, tuple(t[..., 0] for t in gpt))
    a0 = fops.to_ints(sf, a_dev[:, 0])
    b0 = fops.to_ints(sf, b_dev[:, 0])

    schnorr = schnorr_protocol(curve, a0, b0, halo_g_pt, randomness,
                               u_prime, pedersen_h, challenger)
    return OpeningProof(halo_g=halo_g_pt, halo_l=halo_l, halo_r=halo_r,
                        schnorr_proof=schnorr)


def _build_halo_b(spec, degree, opening_points, v, device):
    """b_i = sum_j v^j point_j^i (reference: halo.rs:143-155)."""
    vp = powers_dyn(spec, fops.column(spec, v, device), len(opening_points))
    return fops.product_sum(spec, [
        (vp[:, j:j + 1], powers_dyn(spec, fops.column(spec, pt, device), degree), 1)
        for j, pt in enumerate(opening_points)])


def schnorr_protocol(curve, halo_a: int, halo_b: int,
                     halo_g: chost.AffinePoint, randomness: int,
                     u_prime: chost.AffinePoint, pedersen_h: chost.AffinePoint,
                     challenger) -> SchnorrProof:
    """reference: halo.rs:157-182."""
    sf = curve.scalar
    p = sf.p
    d = RANDOM_SOURCE(p)
    s = RANDOM_SOURCE(p)
    r_curve = chost.add(
        chost.mul(chost.add(halo_g, chost.mul(u_prime, halo_b)), d),
        chost.mul(pedersen_h, s))
    challenger.observe_affine_point(r_curve)
    chall = try_convert(challenger.get_challenge(), sf)
    z1 = (halo_a * chall + d) % p
    z2 = (randomness * chall + s) % p
    return SchnorrProof(r=r_curve, z1=z1, z2=z2)


def verify_ipa(curve, halo_l, halo_r, halo_g, commitment, value, halo_b,
               halo_us, u_prime, pedersen_h, schnorr_challenge,
               schnorr_proof) -> bool:
    """reference: halo.rs:186-223 (host: the point count is ~2 log n)."""
    sf = curve.scalar
    p = sf.p
    p_prime = chost.add(commitment, chost.mul(u_prime, value))
    q = p_prime
    for l, u_j in zip(halo_l, halo_us):
        q = chost.add(q, chost.mul(l, u_j * u_j % p))
    for r, u_j in zip(halo_r, halo_us):
        inv = pow(u_j, -1, p)
        q = chost.add(q, chost.mul(r, inv * inv % p))
    lhs = chost.add(chost.mul(q, schnorr_challenge), schnorr_proof.r)
    rhs = chost.add(
        chost.mul(chost.add(halo_g, chost.mul(u_prime, halo_b)),
                  schnorr_proof.z1),
        chost.mul(pedersen_h, schnorr_proof.z2))
    return lhs == rhs


def _clone_challenger(ch):
    from ..hashing.challenger import Challenger
    fork = Challenger(ch.spec, ch.security_bits)
    fork.sponge_state = list(ch.sponge_state)
    fork.input_buffer = list(ch.input_buffer)
    fork.output_buffer = list(ch.output_buffer)
    return fork


def _copy_challenger(src, dst):
    dst.sponge_state = list(src.sponge_state)
    dst.input_buffer = list(src.input_buffer)
    dst.output_buffer = list(src.output_buffer)
