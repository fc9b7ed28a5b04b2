"""Plookup protocol (reference: plookup/src/plookup.rs; protocol of
ia.cr/2020/315): proves a multiset `f` is contained in a table `t`.

The polynomial work runs on the device: the iFFTs of f, t, h1, h2 and z
(K3), the commitments (K4 and the Horner, one MSM each), the vanishing
identity on the 4(n+1) domain (one batched LDE, K1's elementwise products
and one product-sum fold, the iFFT back), the quotient by Z_H (a coset
FFT pair), the openings and the Halo opening proof (two-column MSMs a
round).  The sort, the grand product and the Lagrange evaluations of the
4(n+1) domain are host work.

prove and verify run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from ..curves import host as chost
from ..curves.spec import CurveSpec
from ..device import resolve
from ..fields import host as fhost
from ..fields import ops as fops
from ..hashing.challenger import Challenger
from ..poly.fft import FftPrecomputation, fft, ifft, pad_to, powers_dyn
from ..poly.polynomial import divide_by_z_h, eval_at_dyn
from ..protocol import halo as halo_mod
from ..protocol.circuit import (CommitmentEngine, ints_to_device_matrix,
                                pedersen_bases)
from ..protocol.plonk_util import (halo_g, halo_n, halo_n_mul, powers,
                                   reduce_with_powers, scalar_to_bits_le,
                                   try_convert)
from ..utils import log2_strict
from ..utils.timing import phase
from .proof import Opening, PlookupOpenings, PlookupProof

SECURITY_BITS = 128


def padded(s: List[int], n: int) -> List[int]:
    return list(s) + [0] * (n - len(s))


def pad_inputs(f: List[int], t: List[int]) -> Tuple[int, List[int], List[int]]:
    """n = next_power_of_two(len(f)) - 1 (f first padded to len(t) - 1),
    f padded to n and t to n + 1 (reference: plookup.rs:157-167)."""
    d = len(t)
    f = padded(f, d - 1) if len(f) + 1 < d else list(f)
    npow = 1
    while npow < max(len(f), 1):
        npow *= 2
    n = npow - 1
    return n, padded(f, n), padded(t, n + 1)


def sort_by(f: List[int], t: List[int]) -> List[int]:
    """Sort f by the order its elements appear in t (reference: :170-177)."""
    pos = {}
    for i, x in enumerate(t):
        if x not in pos:
            pos[x] = i
    return sorted(f, key=lambda a: pos[a])


def grand_polynomial(p: int, f, t, s, beta: int, gamma: int) -> List[int]:
    """The Plookup grand product Z (reference: :180-202)."""
    n = len(f)
    values = [1]
    beta1 = (beta + 1) % p
    gamma_beta1 = gamma * beta1 % p
    beta1_pow = beta1
    prod_a = (gamma + f[0]) % p
    prod_b = (gamma_beta1 + t[0] + beta * t[1]) % p
    prod_c = (gamma_beta1 + s[0] + beta * s[1]) % p \
        * ((gamma_beta1 + s[n] + beta * s[n + 1]) % p) % p
    for i in range(1, n):
        values.append(beta1_pow * prod_a % p * prod_b % p
                      * pow(prod_c, -1, p) % p)
        beta1_pow = beta1_pow * beta1 % p
        prod_a = prod_a * ((gamma + f[i]) % p) % p
        prod_b = prod_b * ((gamma_beta1 + t[i] + beta * t[i + 1]) % p) % p
        prod_c = prod_c * ((gamma_beta1 + s[i] + beta * s[i + 1]) % p) % p \
            * ((gamma_beta1 + s[n + i] + beta * s[n + i + 1]) % p) % p
    values.append(1)
    return values


def eval_l_i(spec, n: int, i: int, generator: int, x: int) -> int:
    """L_i(x) = w^i (x^n - 1) / (n (x - w^i)) (reference: :275-284)."""
    p = spec.p
    g = pow(generator, i, p)
    if x % p == g:
        return 0
    num = g * ((pow(x, n, p) - 1) % p) % p
    den = n % p * ((x - g) % p) % p
    return num * pow(den, -1, p) % p


def prove(curve: CurveSpec, f: List[int], t: List[int],
          device=None) -> PlookupProof:
    """reference: plookup.rs:16-153."""
    dev = resolve(device)
    sf = curve.scalar
    bf = curve.base
    p = sf.p
    n, f, t = pad_inputs(f, t)

    with phase("plookup.sort"):
        s = sort_by(list(f) + list(t), t)

    challenger = Challenger(bf, SECURITY_BITS)
    pre = FftPrecomputation(sf, n + 1)

    with phase("plookup.bases"):
        # the bases are blake_hash_usize_to_curve(i), i < 2n + 2, H =
        # hash(2n + 2) and U = hash(2n + 3) (reference: plookup.rs:120-122)
        gs, h, u_curve = pedersen_bases(curve, 2 * n + 2)
        engine_big = CommitmentEngine(curve, gs, h, dev)
        engine_small = engine_big.prefix(n + 1)

    with phase("plookup.commit_f_t_h"):
        polys = ifft(pre, ints_to_device_matrix(
            sf, [padded(f, n + 1), t, s[:n + 1], s[n:]], dev))   # [L, 4, n+1]
        rand = halo_mod.RANDOM_SOURCE
        c_f = engine_small.commit_many(polys[:, 0:1], True, rand)[0]
        c_t = engine_small.commit_many(polys[:, 1:2], False, rand)[0]
        c_h1 = engine_small.commit_many(polys[:, 2:3], True, rand)[0]
        c_h2 = engine_small.commit_many(polys[:, 3:4], True, rand)[0]

    challenger.observe_affine_points([c_f.commitment, c_t.commitment,
                                      c_h1.commitment, c_h2.commitment])
    beta_bf, gamma_bf = challenger.get_2_challenges()
    beta = try_convert(beta_bf, sf)
    gamma = try_convert(gamma_bf, sf)

    with phase("plookup.grand_product"):
        z_values = grand_polynomial(p, f, t, s, beta, gamma)
    with phase("plookup.commit_z"):
        z_poly = ifft(pre, ints_to_device_matrix(sf, [z_values], dev))[:, 0]
        c_z = engine_small.commit_many(z_poly[:, None], True, rand)[0]

    challenger.observe_affine_point(c_z.commitment)
    alpha = try_convert(challenger.get_challenge(), sf)

    with phase("plookup.vanishing_consts"):
        consts = vanishing_consts(sf, n, dev)
    with phase("plookup.vanishing"):
        vanishing = _vanishing_polynomial(sf, polys, z_poly, beta, gamma,
                                          alpha, n, consts)
    with phase("plookup.quotient"):
        # t = vanishing / (X^(n+1) - 1) (the reference's call at
        # plookup.rs:147 divides by Z_H of the (n+1)-point subgroup)
        quotient = divide_by_z_h(sf, vanishing, n + 1)[:, :2 * n + 2]
        c_quotient = engine_big.commit_many(quotient[:, None], True, rand)[0]

    challenger.observe_affine_point(c_quotient.commitment)
    zeta = try_convert(challenger.get_challenge(), sf)

    # the six polynomials, f, t, h1, h2, z and the quotient, at 2n + 2
    # coefficients
    six = torch.cat([pad_to(polys, 2 * n + 2),
                     pad_to(z_poly, 2 * n + 2)[:, None], quotient[:, None]],
                    dim=1)
    generator = fhost.primitive_root_of_unity(sf, log2_strict(n + 1))
    with phase("plookup.open"):
        openings = _open_all(sf, six, zeta, generator)

    challenger.observe_elements(
        [try_convert(x, bf) for x in openings.to_vec()])
    v_bf, u_bf, us_bf = challenger.get_3_challenges()
    v = try_convert(v_bf, sf)
    u = try_convert(u_bf, sf)
    u_scaling = try_convert(us_bf, sf)

    randomness = [c_f.randomness, c_t.randomness, c_h1.randomness,
                  c_h2.randomness, c_z.randomness, c_quotient.randomness]

    with phase("plookup.ipa"):
        halo_proof = halo_mod.batch_opening_proof(
            six, randomness, [zeta, zeta * generator % p],
            engine_big.g_dev, h, u_curve, u, v, u_scaling, 2 * n + 2,
            SECURITY_BITS, challenger, curve)

    return PlookupProof(
        c_f=c_f.commitment, c_t=c_t.commitment, c_h1=c_h1.commitment,
        c_h2=c_h2.commitment, c_z=c_z.commitment,
        c_quotient=c_quotient.commitment, openings=openings,
        halo_proof=halo_proof, n=n)


@functools.lru_cache(maxsize=4)
def vanishing_consts(sf, n: int, device):
    """The host constants of the 4(n+1) vanishing domain, on the device:
    L_0, L_n and X - g^n at each point, [L, 4(n+1)] each (reference:
    plookup.rs:205-271 evaluates them point by point; so does this, two
    modular inverses a point)."""
    p = sf.p
    order = 4 * (n + 1)
    g4 = fhost.primitive_root_of_unity(sf, log2_strict(order))
    gen = pow(g4, 4, p)  # generator of the (n+1) subgroup
    sub4 = fhost.cyclic_subgroup_known_order(sf, g4, order)
    l0 = [eval_l_i(sf, n + 1, 0, gen, x) for x in sub4]
    ln = [eval_l_i(sf, n + 1, n, gen, x) for x in sub4]
    gn = pow(gen, n, p)
    x_m_gn = [(x - gn) % p for x in sub4]
    return tuple(fops.from_ints(sf, vals, device) for vals in (l0, ln, x_m_gn))


def _vanishing_polynomial(sf, polys, z_poly, beta, gamma, alpha, n, consts):
    """The Plookup vanishing identity on the 4(n+1) domain, folded with the
    powers of alpha and interpolated back (reference: plookup.rs:205-271):
    one LDE of the five polynomials, K1's products and one product sum."""
    l0_d, ln_d, xg_d = consts
    dev = polys.device
    order = 4 * (n + 1)
    pre4 = FftPrecomputation(sf, order)
    lde = fft(pre4, pad_to(torch.cat([polys, z_poly[:, None]], dim=1), order))
    f4, t4, h14, h24, z4 = lde.unbind(1)

    def sh(a):  # shift by one subgroup step (4 on this domain)
        return torch.roll(a, -4, dims=-1)

    def add(a, b):
        return fops.add(sf, a, b)

    def mul(a, b):
        return fops.mul(sf, a, b)

    one = fops.constant(sf, 1, (order,), dev)
    beta_col = fops.column(sf, beta, dev)
    gamma_col = fops.column(sf, gamma, dev)
    beta1_col = fops.column(sf, beta + 1, dev)
    gb1_col = mul(gamma_col, beta1_col)

    z1_term = mul(l0_d, fops.sub(sf, z4, one))
    t_shift = add(gb1_col, add(t4, mul(beta_col, sh(t4))))
    lhs = mul(mul(mul(beta1_col, mul(xg_d, z4)), add(gamma_col, f4)), t_shift)
    h1_t = add(gb1_col, add(h14, mul(beta_col, sh(h14))))
    h2_t = add(gb1_col, add(h24, mul(beta_col, sh(h24))))
    rhs = mul(mul(mul(xg_d, sh(z4)), h1_t), h2_t)
    shift_term = fops.sub(sf, lhs, rhs)
    hs_term = mul(ln_d, fops.sub(sf, h14, sh(h24)))
    last_term = mul(ln_d, fops.sub(sf, z4, one))

    # fold with the powers of alpha
    terms = [z1_term, shift_term, hs_term, last_term]
    ap = powers_dyn(sf, fops.column(sf, alpha, dev), len(terms))
    vals = fops.product_sum(sf, [(ap[:, i:i + 1], tm, 1)
                                 for i, tm in enumerate(terms)])
    return ifft(pre4, vals)


def _open_all(sf, six, zeta, generator) -> PlookupOpenings:
    """The six polynomials [L, 6, 2n + 2] at zeta and zeta g (g the
    generator of the (n+1)-point subgroup), in PlookupOpenings' order."""
    dev = six.device
    right = zeta * generator % sf.p
    loc, rgt = (fops.to_ints(sf, eval_at_dyn(sf, six, fops.column(sf, pt, dev)))
                for pt in (zeta, right))
    return PlookupOpenings(*(Opening(int(a), int(b)) for a, b in zip(loc, rgt)))


def verify(curve: CurveSpec, t: List[int], proof: PlookupProof,
           device=None) -> None:
    """Raises ValueError unless the proof shows that its f lies in t
    (reference: plookup/src/verifier.rs)."""
    dev = resolve(device)
    sf = curve.scalar
    p = sf.p
    n = proof.n
    t = padded(t, n + 1)
    pre = FftPrecomputation(sf, n + 1)
    # the verifier commits to t over the first n + 1 bases
    gs, h, u_curve = pedersen_bases(curve, 2 * n + 2)

    t_coeffs = ifft(pre, ints_to_device_matrix(sf, [t], dev))
    engine = CommitmentEngine(curve, gs[:n + 1], h, dev)
    c_t = engine.commit_many(t_coeffs, False, None)[0]
    if c_t.commitment != proof.c_t:
        raise ValueError("Incorrect table commitment")

    ch = proof.get_challenges(curve)
    generator = fhost.primitive_root_of_unity(sf, log2_strict(n + 1))
    beta, gamma, alpha, zeta = ch.beta, ch.gamma, ch.alpha, ch.zeta
    beta1 = (beta + 1) % p
    gamma_beta1 = gamma * beta1 % p
    o = proof.openings

    z1_term = eval_l_i(sf, n + 1, 0, generator, zeta) * ((o.z.local - 1) % p) % p
    gn = pow(generator, n, p)
    lhs = (zeta - gn) % p * o.z.local % p * beta1 % p \
        * ((gamma + o.f.local) % p) % p \
        * ((gamma_beta1 + o.t.local + beta * o.t.right) % p) % p
    rhs = (zeta - gn) % p * o.z.right % p \
        * ((gamma_beta1 + o.h1.local + beta * o.h1.right) % p) % p \
        * ((gamma_beta1 + o.h2.local + beta * o.h2.right) % p) % p
    shift_term = (lhs - rhs) % p
    eval_last = eval_l_i(sf, n + 1, n, generator, zeta)
    hs_term = eval_last * ((o.h1.local - o.h2.right) % p) % p
    last_term = eval_last * ((o.z.local - 1) % p) % p

    numerator = reduce_with_powers(sf, [z1_term, shift_term, hs_term,
                                        last_term], alpha)
    denominator = (pow(zeta, n + 1, p) - 1) % p
    if numerator * pow(denominator, -1, p) % p != o.quotient.local:
        raise ValueError("Incorrect quotient opening")

    c_all = [proof.c_f, proof.c_t, proof.c_h1, proof.c_h2, proof.c_z,
             proof.c_quotient]
    actual_scalars = [halo_n(curve, scalar_to_bits_le(pu, SECURITY_BITS))
                      for pu in powers(sf, ch.u, len(c_all))]
    c_reduction = chost.zero_point(curve)
    for c, sc in zip(c_all, actual_scalars):
        c_reduction = chost.add(c_reduction, chost.mul(c, sc))
    red_local = sum(a * b for a, b in zip(actual_scalars, o.local())) % p
    red_right = sum(a * b for a, b in zip(actual_scalars, o.right())) % p
    reduced_opening = reduce_with_powers(sf, [red_local, red_right], ch.v)
    u_prime = halo_n_mul(curve, scalar_to_bits_le(ch.u_scaling, SECURITY_BITS),
                         u_curve)
    halo_bs = [halo_g(sf, pt, ch.halo_us)
               for pt in (zeta, zeta * generator % p)]
    halo_b = reduce_with_powers(sf, halo_bs, ch.v)
    ok = halo_mod.verify_ipa(curve, proof.halo_proof.halo_l, proof.halo_proof.halo_r,
                    proof.halo_proof.halo_g, c_reduction, reduced_opening,
                    halo_b, ch.halo_us, u_prime, h, ch.schnorr_challenge,
                    proof.halo_proof.schnorr_proof)
    if not ok:
        raise ValueError("Invalid IPA proof.")
