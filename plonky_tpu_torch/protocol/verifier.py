"""The verifier (reference: src/verifier.rs).

Verification is scalar-dominated (openings at one point), so it runs on host
python ints except the optional O(n) G-point check, which is an MSM on
`device` (the card unless the caller passes "cpu").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..circuit.algebra import HostAlgebra
from ..circuit.gates import GateCtx, evaluate_all_constraints
from ..circuit.partition import get_subgroup_shift
from ..circuit.target import (
    GRID_WIDTH,
    NUM_ROUTED_WIRES,
    NUM_WIRES,
)
from ..curves import host as chost
from ..curves import msm as cmsm
from ..curves.spec import CurveSpec
from ..device import resolve
from ..fields import host as fhost
from ..fields.spec import require_eight_limbs
from ..utils import ceil_div, log2_strict
from . import halo as halo_mod
from .circuit import (commit_window_bits, device_point_to_host,
                      ints_to_device_matrix, pedersen_bases, points_to_device)
from .plonk_util import (
    eval_l_1,
    eval_zero_poly,
    halo_g,
    halo_n,
    halo_n_mul,
    halo_s,
    powers,
    reduce_with_powers,
    scalar_to_bits_le,
)
from .proof import OldProof, Proof


class VerificationError(Exception):
    pass


@dataclass
class VerificationKey:
    """reference: verifier.rs:16-46."""
    c_constants: List[chost.AffinePoint]
    c_s_sigmas: List[chost.AffinePoint]
    degree: int
    num_public_inputs: int
    num_gates_without_pis: int
    security_bits: int
    curve: CurveSpec


def verify_proof(public_inputs: List[int], proof: Proof,
                 old_proofs: List[OldProof], vk: VerificationKey,
                 inner_curve: CurveSpec, verify_g: bool,
                 device=None) -> Optional[OldProof]:
    """reference: verifier.rs:52-193.  Returns an OldProof when verify_g is
    False (deferring the linear-time G check), else None.  Raises
    VerificationError on an invalid proof."""
    dev = resolve(device)
    curve = vk.curve
    sf = curve.scalar
    require_eight_limbs(sf, "verify_proof")
    p = sf.p

    check_proof_parameters(proof)

    challs = proof.get_challenges(curve, public_inputs, old_proofs)

    verify_old_proof_evaluation(sf, old_proofs, proof, challs.zeta)

    degree = vk.degree
    alg = HostAlgebra(sf)
    ctx = GateCtx(sf, inner_curve)
    constraint_terms = evaluate_all_constraints(
        alg, ctx, proof.o_local.o_constants, proof.o_local.o_wires,
        proof.o_right.o_wires, proof.o_below.o_wires)

    zeta_power_d = pow(challs.zeta, degree, p)
    zero_of_zeta = (zeta_power_d - 1) % p
    lagrange_1_eval = eval_l_1(sf, degree, challs.zeta)

    z_x = proof.o_local.o_plonk_z
    z_gx = proof.o_right.o_plonk_z
    vanishing_z_1_term = lagrange_1_eval * ((z_x - 1) % p) % p

    f_prime = 1
    g_prime = 1
    for i in range(NUM_ROUTED_WIRES):
        k_i = get_subgroup_shift(sf, i)
        s_id = k_i * challs.zeta % p
        beta_s_id = challs.beta * s_id % p
        beta_s_sigma = challs.beta * proof.o_local.o_plonk_sigmas[i] % p
        f_prime = f_prime * ((proof.o_local.o_wires[i] + beta_s_id
                              + challs.gamma) % p) % p
        g_prime = g_prime * ((proof.o_local.o_wires[i] + beta_s_sigma
                              + challs.gamma) % p) % p
    vanishing_v_shift_term = (f_prime * z_x - g_prime * z_gx) % p

    vanishing_terms = ([vanishing_z_1_term, vanishing_v_shift_term]
                       + constraint_terms)
    computed_t_opening = reduce_with_powers(sf, vanishing_terms, challs.alpha) \
        * pow(zero_of_zeta, -1, p) % p
    purported_t_opening = reduce_with_powers(sf, proof.o_local.o_plonk_t,
                                             zeta_power_d)
    if computed_t_opening != purported_t_opening:
        raise VerificationError("Incorrect opening of the t polynomial.")

    subgroup_generator_n = fhost.primitive_root_of_unity(sf, log2_strict(degree))

    # public-input quotient check (verifier.rs:127-148)
    num_pi_gates = ceil_div(vk.num_public_inputs, NUM_WIRES)
    pis_quotient_denominator = 1
    for i in range(num_pi_gates):
        x_i = pow(subgroup_generator_n, vk.num_gates_without_pis + 2 * i, p)
        pis_quotient_denominator = pis_quotient_denominator * \
            ((challs.zeta - x_i) % p) % p
    inner = 0
    for w, a in zip(proof.o_local.o_wires, powers(sf, challs.alpha, NUM_WIRES)):
        inner = (inner + w * a) % p
    pis_poly_eval = _public_inputs_poly_eval(
        sf, public_inputs, challs.alpha, degree, vk.num_gates_without_pis,
        subgroup_generator_n, challs.zeta)
    pis_quotient_numerator = (inner - pis_poly_eval) % p
    computed_pi_quotient = pis_quotient_numerator * \
        pow(pis_quotient_denominator, -1, p) % p
    if computed_pi_quotient != proof.o_local.o_pi_quotient:
        raise VerificationError(
            "Incorrect opening of the public inputs quotient polynomial.")

    # IPA verification (verifier.rs:150-171)
    pedersen_g, pedersen_h, u_curve = pedersen_bases(curve, vk.degree)
    if not verify_all_ipas(curve, vk, subgroup_generator_n, u_curve,
                           pedersen_h, proof, old_proofs, challs):
        raise VerificationError("Invalid IPA proof.")

    if verify_g:
        # O(n) check: halo_g == <s, G> (verifier.rs:173-186) -- a device MSM
        s_vec = halo_s(sf, challs.halo_us)
        basis = cmsm.precompute_base(
            curve, points_to_device(curve, pedersen_g, dev))
        scal = ints_to_device_matrix(sf, [s_vec], dev)[:, 0]
        pt = cmsm.msm(curve, basis, scal, commit_window_bits(vk.degree))
        if proof.halo_g != device_point_to_host(curve, pt):
            raise VerificationError("Invalid G point.")
        return None
    return OldProof(halo_g=proof.halo_g, halo_us=challs.halo_us)


def verify_all_ipas(curve, vk, subgroup_generator_n, u_curve, pedersen_h,
                    proof: Proof, old_proofs, challs) -> bool:
    """Reduce all commitments + openings to a single IPA claim
    (reference: verifier.rs:197-268)."""
    sf = curve.scalar
    p = sf.p
    c_all = (list(vk.c_constants) + list(vk.c_s_sigmas) + list(proof.c_wires)
             + [proof.c_plonk_z] + list(proof.c_plonk_t)
             + [op.halo_g for op in old_proofs] + [proof.c_pis_quotient])
    powers_of_u = powers(sf, challs.u, len(c_all))
    actual_scalars = [halo_n(curve, scalar_to_bits_le(pu, vk.security_bits))
                      for pu in powers_of_u]
    c_reduction = chost.zero_point(curve)
    for c, s in zip(c_all, actual_scalars):
        c_reduction = chost.add(c_reduction, chost.mul(c, s))

    opening_set_reductions = []
    for os_ in proof.all_opening_sets():
        acc = 0
        for x, s in zip(os_.to_vec(), actual_scalars):
            acc = (acc + x * s) % p
        opening_set_reductions.append(acc)
    reduced_opening = reduce_with_powers(sf, opening_set_reductions, challs.v)

    u_prime = halo_n_mul(
        curve, scalar_to_bits_le(challs.u_scaling, vk.security_bits), u_curve)

    points = [challs.zeta,
              challs.zeta * subgroup_generator_n % p,
              challs.zeta * pow(subgroup_generator_n, GRID_WIDTH, p) % p]
    halo_bs = [halo_g(sf, pt, challs.halo_us) for pt in points]
    halo_b = reduce_with_powers(sf, halo_bs, challs.v)

    return halo_mod.verify_ipa(
        curve, proof.halo_l, proof.halo_r, proof.halo_g, c_reduction,
        reduced_opening, halo_b, challs.halo_us, u_prime, pedersen_h,
        challs.schnorr_challenge, proof.schnorr_proof)


def verify_old_proof_evaluation(sf, old_proofs, proof: Proof, zeta: int):
    """reference: verifier.rs:271-286."""
    if len(old_proofs) != len(proof.o_local.o_old_proofs):
        raise VerificationError("Incorrect number of old proofs opening.")
    for i, op in enumerate(old_proofs):
        if halo_g(sf, zeta, op.halo_us) != proof.o_local.o_old_proofs[i]:
            raise VerificationError(f"{i}-th old proof opening is incorrect")


def check_proof_parameters(proof: Proof):
    """Points on curve, elements in range (reference: verifier.rs:291-355)."""
    all_points = (list(proof.c_wires) + [proof.c_plonk_z]
                  + list(proof.c_plonk_t) + list(proof.halo_l)
                  + list(proof.halo_r) + [proof.halo_g,
                                          proof.schnorr_proof.r])
    for pt in all_points:
        if not pt.is_valid():
            raise VerificationError("A proof point is not on the curve.")
    if len(proof.halo_l) != len(proof.halo_r):
        raise VerificationError("Halo L and R lengths differ.")


def _public_inputs_poly_eval(sf, public_inputs, alpha, degree,
                             num_gates_without_pis, subgroup_generator_n,
                             zeta) -> int:
    """Evaluate the PI interpolation polynomial at zeta
    (reference: verifier.rs:360-398).  The polynomial interpolates
    sum_j alpha^j * pi_wire_j at the PI-gate subgroup points and 0 elsewhere;
    we evaluate via barycentric-style direct interpolation over the full
    subgroup (host; the support is sparse so this is O(#PI * 1) plus the
    standard L_i(zeta) form)."""
    p = sf.p
    # Build the sparse values: index -> value
    n_pis = len(public_inputs)
    num_pi_gates = ceil_div(n_pis, NUM_WIRES)
    values = {}
    for g_idx in range(num_pi_gates):
        acc = 0
        ap = 1
        for j in range(NUM_WIRES):
            i = g_idx * NUM_WIRES + j
            pi = public_inputs[i] if i < n_pis else 0
            acc = (acc + pi * ap) % p
            ap = ap * alpha % p
        values[num_gates_without_pis + 2 * g_idx] = acc

    # P(zeta) = sum_i v_i L_i(zeta), L_i(zeta) = (zeta^n - 1) g^i /
    #           (n (zeta - g^i))
    zn1 = (pow(zeta, degree, p) - 1) % p
    n_inv = pow(degree, -1, p)
    total = 0
    for idx, v in values.items():
        gi = pow(subgroup_generator_n, idx, p)
        denom = (zeta - gi) % p
        li = zn1 * gi % p * pow(denom * degree % p, -1, p) % p
        total = (total + v * li) % p
    return total
