"""The prover: generate_proof (reference: src/plonk.rs:84-456).

Host transcript <-> device bulk math: FFTs and LDEs, MSM commitments, the
permutation product, the 8n-point vanishing-polynomial evaluation (every
gate through BatchAlgebra), the t and public-input quotients, openings and
the Halo IPA.  The phase names match the JAX package's prover so that the
per-phase seconds compare.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from ..circuit.algebra import BatchAlgebra
from ..circuit.gates import evaluate_all_constraints
from ..circuit.partition import get_subgroup_shift
from ..circuit.target import GRID_WIDTH, NUM_ROUTED_WIRES, NUM_WIRES
from ..circuit.witness import Witness
from ..fields import ops as fops
from ..fields.spec import LIMBS, require_eight_limbs
from ..hashing.challenger import Challenger
from ..poly.fft import (coset_fft, coset_ifft, fft, ifft, lde, pad_to,
                        powers_dyn)
from ..poly.polynomial import divide_by_z_h, eval_at_dyn
from ..utils import ceil_div
from ..utils.timing import phase
from . import halo as halo_mod
from .circuit import Circuit, ints_to_device_matrix
from .plonk_util import try_convert
from .proof import OpeningSet, Proof

QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER = 7


def generate_proof(circuit: Circuit, witness: Witness,
                   old_proofs: List = (), blinding: bool = True) -> Proof:
    curve = circuit.curve
    sf = circuit.spec
    require_eight_limbs(sf, "generate_proof")
    bf = curve.base
    p = sf.p
    n = circuit.degree()
    dev = circuit.device
    challenger = Challenger(bf, circuit.security_bits)

    # --- wires -> polynomials -> 8n LDE (plonk.rs:93-97) -----------------
    with phase("prover.wire_ldes"):
        wire_values = witness.transpose()          # host [9][n]
        wires_dev = ints_to_device_matrix(sf, wire_values, dev)   # [L, 9, n]
        wire_polys = ifft(circuit.fft_n, wires_dev)
        wires_8n = lde(circuit.fft_8n, wire_polys)

    # --- commit wires (plonk.rs:100-105) ----------------------------------
    with phase("prover.commit_wires"):
        c_wires = circuit.commit_engine.commit_many(
            wire_polys, blinding, halo_mod.RANDOM_SOURCE)

    num_pi_gates = ceil_div(circuit.num_public_inputs, NUM_WIRES)
    # wire polynomials with PI-gate rows zeroed (plonk.rs:109-118)
    wire_values_no_pis = [list(col) for col in wire_values]
    for w in wire_values_no_pis:
        for i in range(num_pi_gates):
            w[circuit.num_gates_without_pis + 2 * i] = 0
    wire_polys_no_pis = ifft(
        circuit.fft_n, ints_to_device_matrix(sf, wire_values_no_pis, dev))

    # --- beta, gamma -------------------------------------------------------
    challenger.observe_affine_points([c.commitment for c in c_wires])
    beta_bf, gamma_bf = challenger.get_2_challenges()
    beta = try_convert(beta_bf, sf)
    gamma = try_convert(gamma_bf, sf)

    # --- permutation polynomial Z (plonk_util.rs:234-262) ------------------
    with phase("prover.z_poly"):
        z_values = _permutation_polynomial(circuit, wires_dev, beta, gamma)
        z_poly = ifft(circuit.fft_n, z_values)
        c_z = circuit.commit_engine.commit_many(
            z_poly[:, None], blinding, halo_mod.RANDOM_SOURCE)[0]

    challenger.observe_affine_point(c_z.commitment)
    alpha = try_convert(challenger.get_challenge(), sf)

    # --- vanishing polynomial at 8n points (plonk.rs:375-456) --------------
    with phase("prover.vanishing_poly"):
        vanishing_coeffs = _vanishing_poly(circuit, wires_8n, z_poly,
                                           alpha, beta, gamma)

    # --- t = vanishing / Z_H, split into 7 chunks (plonk.rs:170-197) --------
    with phase("prover.t_quotient"):
        t_coeffs = divide_by_z_h(sf, vanishing_coeffs, n)
        # split into 7 degree-n chunks (the quotient has degree < 7n)
        t_chunks = t_coeffs[:, :QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER * n
                            ].reshape(LIMBS, QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER,
                                      n)
        c_t = circuit.commit_engine.commit_many(
            t_chunks, blinding, halo_mod.RANDOM_SOURCE)

    # --- public-input quotient (plonk.rs:200-235) ---------------------------
    with phase("prover.pi_quotient"):
        pi_quotient_poly = _pi_quotient(circuit, wire_polys_no_pis, alpha,
                                        num_pi_gates)
        c_pi_quotient = circuit.commit_engine.commit_many(
            pi_quotient_poly[:, None], blinding, halo_mod.RANDOM_SOURCE)[0]

    public_inputs = circuit.get_public_inputs(witness)

    # --- zeta ---------------------------------------------------------------
    challenger.observe_affine_points([c.commitment for c in c_t])
    challenger.observe_affine_point(c_pi_quotient.commitment)
    challenger.observe_elements([try_convert(pi, bf) for pi in public_inputs])
    for old in old_proofs:
        challenger.observe_affine_point(old.halo_g)
    zeta = try_convert(challenger.get_challenge(), sf)

    # --- open all polynomials at zeta, g zeta, g^65 zeta (plonk.rs:260-284) -
    g = circuit.subgroup_generator_n
    opening_points = [
        zeta,
        zeta * g % p,
        zeta * pow(g, GRID_WIDTH, p) % p,
    ]
    old_g_polys = [ints_to_device_matrix(sf, [op.coeffs(sf)], dev)[:, 0]
                   for op in old_proofs]
    all_polys = _stack_polys(circuit, wire_polys, z_poly, t_chunks,
                             old_g_polys, pi_quotient_poly)
    with phase("prover.openings"):
        opening_sets = [
            _open_all(circuit, all_polys, old_proofs, pt)
            for pt in opening_points
        ]
    o_local, o_right, o_below = opening_sets

    all_opened_bf = []
    for os_ in opening_sets:
        for f in os_.to_vec():
            all_opened_bf.append(try_convert(f, bf))
    challenger.observe_elements(all_opened_bf)
    v_bf, u_bf, u_scaling_bf = challenger.get_3_challenges()
    v = try_convert(v_bf, sf)
    u = try_convert(u_bf, sf)
    u_scaling = try_convert(u_scaling_bf, sf)

    # commitment randomness in OpeningSet::to_vec order
    all_randomness = ([c.randomness for c in circuit.c_constants]
                      + [c.randomness for c in circuit.c_s_sigmas]
                      + [c.randomness for c in c_wires]
                      + [c_z.randomness]
                      + [c.randomness for c in c_t]
                      + [0] * len(old_proofs)
                      + [c_pi_quotient.randomness])

    with phase("prover.ipa"):
        opening_proof = halo_mod.batch_opening_proof(
            all_polys, all_randomness, opening_points,
            circuit.commit_engine.g_dev, circuit.pedersen_h, circuit.u,
            u, v, u_scaling, n, circuit.security_bits, challenger, curve)

    return Proof(
        c_wires=[c.commitment for c in c_wires],
        c_plonk_z=c_z.commitment,
        c_plonk_t=[c.commitment for c in c_t],
        c_pis_quotient=c_pi_quotient.commitment,
        o_local=o_local,
        o_right=o_right,
        o_below=o_below,
        halo_l=opening_proof.halo_l,
        halo_r=opening_proof.halo_r,
        halo_g=opening_proof.halo_g,
        schnorr_proof=opening_proof.schnorr_proof,
    )


def _col(spec, v: int, device) -> torch.Tensor:
    return fops.column(spec, v % spec.p, device)


@functools.lru_cache(maxsize=None)
def _circuit_perm_consts(circuit: Circuit):
    """Per-circuit device constants for Z: the subgroup [LIMBS, n] and the
    sigma values [LIMBS, 6, n]."""
    sf, dev = circuit.spec, circuit.device
    subgroup = ints_to_device_matrix(sf, [circuit.subgroup_n], dev)[:, 0]
    sigma_dev = ints_to_device_matrix(sf, circuit.sigma_values_n, dev)
    return subgroup, sigma_dev


def prefix_product(spec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the last axis, by log2(n) doubling
    steps (Hillis-Steele): step d multiplies x[i] by x[i - d] for i >= d."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], fops.mul(spec, x[..., d:], x[..., :n - d])],
                      dim=-1)
        d *= 2
    return x


def _permutation_parts(sf, wires, subgroup, sigma, beta, beta_col, gamma_col):
    """The permutation argument's per-wire factors, in one product-sum
    launch: f_j = k_j beta x + w_j + gamma and g_j = beta sigma_j + w_j +
    gamma over the routed wires j (reference: plonk_util.rs:242-261).
    Each strided wire slice is made contiguous once, for both sums."""
    w = [wires[:, j].contiguous() for j in range(NUM_ROUTED_WIRES)]
    sums = []
    for j in range(NUM_ROUTED_WIRES):
        kb = _col(sf, get_subgroup_shift(sf, j) * beta, wires.device)
        sums.append([(kb, subgroup, 1), (w[j], None, 1), (gamma_col, None, 1)])
    for j in range(NUM_ROUTED_WIRES):
        sums.append([(beta_col, sigma[:, j], 1), (w[j], None, 1),
                     (gamma_col, None, 1)])
    parts = fops.product_sums(sf, sums)
    return parts[:NUM_ROUTED_WIRES], parts[NUM_ROUTED_WIRES:]


def _permutation_polynomial(circuit: Circuit, wires: torch.Tensor,
                            beta: int, gamma: int) -> torch.Tensor:
    """Z running product (the reference's sequential loop,
    plonk_util.rs:242-261): per-point numerator / denominator over the 6
    routed wires, a batched inverse, an exclusive prefix product."""
    sf, dev = circuit.spec, circuit.device
    subgroup, sigma_d = _circuit_perm_consts(circuit)
    beta_col, gamma_col = _col(sf, beta, dev), _col(sf, gamma, dev)
    f_terms, g_terms = _permutation_parts(
        sf, wires, subgroup, sigma_d, beta, beta_col, gamma_col)
    num = den = None
    for f_term, g_term in zip(f_terms, g_terms):
        num = f_term if num is None else fops.mul(sf, num, f_term)
        den = g_term if den is None else fops.mul(sf, den, g_term)
    ratio = fops.mul(sf, num, fops.inverse(sf, den))
    inclusive = prefix_product(sf, ratio)
    return torch.cat([_col(sf, 1, dev), inclusive[:, :-1]], dim=-1)


@functools.lru_cache(maxsize=None)
def _circuit_vanishing_consts(circuit: Circuit):
    """Per-circuit tensors on the 8n domain: the subgroup, x^n - 1 and
    L_1(x) = (x^n - 1) / (n (x - 1)).  inverse(0) = 0 makes L_1 vanish at
    x = 1 (index 0), where an indicator then sets L_1(1) = 1."""
    sf, dev = circuit.spec, circuit.device
    p = sf.p
    n = circuit.degree()
    n8 = 8 * n
    g8 = circuit.subgroup_generator_8n
    subgroup_8n = [0] * n8
    cur = 1
    for i in range(n8):
        subgroup_8n[i] = cur
        cur = cur * g8 % p
    sub8 = ints_to_device_matrix(sf, [subgroup_8n], dev)[:, 0]
    # x^n over the 8n subgroup is 8-periodic: (g8^i)^n = (g8^n)^i
    g8n = pow(g8, n, p)
    xn_m1 = ints_to_device_matrix(
        sf, [[(pow(g8n, i % 8, p) - 1) % p for i in range(n8)]], dev)[:, 0]
    one = _col(sf, 1, dev)
    denom = fops.mul_small(sf, fops.sub(sf, sub8, one), n)
    l1 = fops.mul(sf, xn_m1, fops.inverse(sf, denom))
    indicator = torch.zeros_like(l1)
    indicator[0, 0] = 1
    l1 = fops.add(sf, l1, indicator)
    return sub8, l1


def _vanishing_poly(circuit: Circuit, wires8: torch.Tensor,
                    z_coeffs: torch.Tensor, alpha: int, beta: int,
                    gamma: int) -> torch.Tensor:
    """Evaluate all filtered gate constraints + permutation terms at all 8n
    points, fold by powers of alpha, interpolate (reference:
    plonk.rs:375-456)."""
    sf, dev = circuit.spec, circuit.device
    n8 = 8 * circuit.degree()
    sub8, l1 = _circuit_vanishing_consts(circuit)
    consts8 = circuit.constants_8n
    sigma8 = circuit.s_sigma_values_8n
    # z on the 8n domain, plus its g-shifted version (shift by 8)
    z8 = fft(circuit.fft_8n, pad_to(z_coeffs, n8))
    z8_right = torch.roll(z8, -8, dims=-1)
    wires_right = torch.roll(wires8, -8, dims=-1)
    wires_below = torch.roll(wires8, -8 * GRID_WIDTH, dims=-1)

    alg = BatchAlgebra(sf, dev)
    lc = [consts8[:, j] for j in range(consts8.shape[1])]
    lw = [wires8[:, j] for j in range(NUM_WIRES)]
    rw = [wires_right[:, j] for j in range(NUM_WIRES)]
    bw = [wires_below[:, j] for j in range(NUM_WIRES)]
    constraint_terms = evaluate_all_constraints(alg, circuit.ctx,
                                                lc, lw, rw, bw)

    one = alg.one()
    z_term = alg.mul(l1, alg.sub(z8, one))

    # permutation f'/g' terms
    beta_col, gamma_col = _col(sf, beta, dev), _col(sf, gamma, dev)
    f_prime = g_prime = None
    f_parts, g_parts = _permutation_parts(
        sf, wires8, sub8, sigma8, beta, beta_col, gamma_col)
    for f_part, g_part in zip(f_parts, g_parts):
        f_prime = f_part if f_prime is None else alg.mul(f_prime, f_part)
        g_prime = g_part if g_prime is None else alg.mul(g_prime, g_part)
    v_shift = fops.product_sum(sf, [(f_prime, z8, 1), (g_prime, z8_right, -1)])

    terms = [z_term, v_shift] + constraint_terms
    # fold by powers of alpha: one product sum per 32 terms
    ap = powers_dyn(sf, _col(sf, alpha, dev), len(terms))   # [LIMBS, T]
    vanishing_values = fops.product_sum(
        sf, [(ap[:, i:i + 1], t, 1) for i, t in enumerate(terms)])
    vanishing_values = vanishing_values.expand(LIMBS, n8)
    return ifft(circuit.fft_8n, vanishing_values)


@functools.lru_cache(maxsize=None)
def _circuit_pi_denom_inv(circuit: Circuit, num_pi_gates: int) -> torch.Tensor:
    """1 / prod_k (s h_i - x_k) over the coset, per circuit (the PI gate
    positions are fixed at build time)."""
    from ..fields import host as fhost
    sf = circuit.spec
    p = sf.p
    n = circuit.degree()
    pi_points = [circuit.subgroup_n[circuit.num_gates_without_pis + 2 * i]
                 for i in range(num_pi_gates)]
    shift = sf.generator
    denom_vals = [1] * n
    cur_pts = [shift * h % p for h in circuit.subgroup_n]
    for xk in pi_points:
        for i in range(n):
            denom_vals[i] = denom_vals[i] * ((cur_pts[i] - xk) % p) % p
    denom_inv = fhost.batch_inverse(sf, denom_vals) if pi_points else [1] * n
    return ints_to_device_matrix(sf, [denom_inv], circuit.device)[:, 0]


def _pi_quotient(circuit: Circuit, wire_polys_no_pis: torch.Tensor,
                 alpha: int, num_pi_gates: int) -> torch.Tensor:
    """alpha-combination of no-PI wire polys, divided exactly by
    prod_k (X - x_k) over the PI gate points, via coset evaluate/divide
    (reference: plonk.rs:200-235)."""
    sf = circuit.spec
    shift = sf.generator
    dinv = _circuit_pi_denom_inv(circuit, num_pi_gates)
    ap = powers_dyn(sf, _col(sf, alpha, circuit.device), NUM_WIRES)
    vanishing_pis = fops.product_sum(sf, [
        (ap[:, j:j + 1], wire_polys_no_pis[:, j], 1)
        for j in range(NUM_WIRES)])
    vals = coset_fft(circuit.fft_n, vanishing_pis, shift)
    return coset_ifft(circuit.fft_n, fops.mul(sf, vals, dinv), shift)


def _stack_polys(circuit: Circuit, wire_polys, z_poly, t_chunks, old_g_polys,
                 pi_quotient_poly) -> torch.Tensor:
    """All committed polynomials in OpeningSet::to_vec order: [LIMBS, K, n]."""
    cols = [circuit.constant_polynomials, circuit.s_sigma_polynomials,
            wire_polys, z_poly[:, None], t_chunks]
    if old_g_polys:
        cols.append(torch.stack(old_g_polys, dim=1))
    cols.append(pi_quotient_poly[:, None])
    return torch.cat(cols, dim=1)


def _open_all(circuit: Circuit, all_polys: torch.Tensor, old_proofs,
              zeta: int) -> OpeningSet:
    """Evaluate every polynomial at zeta (reference: plonk.rs:458-482)."""
    sf = circuit.spec
    vals = eval_at_dyn(sf, all_polys, _col(sf, zeta, circuit.device))
    ints = fops.to_ints(sf, vals)
    K = all_polys.shape[1]
    idx = 0

    def take(k):
        nonlocal idx
        out = [int(v) for v in ints[idx:idx + k]]
        idx += k
        return out

    o_constants = take(6)
    o_sigmas = take(6)
    o_wires = take(NUM_WIRES)
    o_z = take(1)[0]
    o_t = take(QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER)
    o_old = take(len(old_proofs))
    o_pi = take(1)[0]
    assert idx == K
    return OpeningSet(o_constants=o_constants, o_plonk_sigmas=o_sigmas,
                      o_wires=o_wires, o_plonk_z=o_z, o_plonk_t=o_t,
                      o_old_proofs=o_old, o_pi_quotient=o_pi)
