"""Polynomial operations in coefficient form (the reference's
src/polynomial.rs): a polynomial is a tensor [LIMBS, ..., n] with the
coefficient axis last."""

from __future__ import annotations

import functools

import torch

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMBS, FieldSpec, require_eight_limbs
from ..utils import log2_ceil
from .fft import FftPrecomputation, coset_fft, coset_ifft, powers_dyn


def eval_at_dyn(spec: FieldSpec, coeffs: torch.Tensor,
                point_col: torch.Tensor) -> torch.Tensor:
    """Evaluate [LIMBS, ..., n] polynomials at a [LIMBS, 1] point: the inner
    product with its powers (reference `eval_from_power`:
    src/polynomial.rs:130)."""
    require_eight_limbs(spec, "eval_at_dyn")
    n = coeffs.shape[-1]
    pw = powers_dyn(spec, point_col, n)
    pwb = pw.reshape((LIMBS,) + (1,) * (coeffs.dim() - 2) + (n,))
    prod = fops.mul(spec, coeffs, pwb)
    return fops.sum_reduce(spec, prod, prod.dim() - 2)


@functools.lru_cache(maxsize=None)
def z_h_inverses(spec: FieldSpec, n: int, big_n: int, device) -> torch.Tensor:
    """1 / ((s h)^n - 1) for h in H_{big_n}, s the field's generator, as a
    [LIMBS, big_n] tensor: (s h)^n takes only big_n / n values, so the
    host computes that period and tiles it."""
    require_eight_limbs(spec, "z_h_inverses")
    p = spec.p
    shift = spec.generator
    g_big = fhost.primitive_root_of_unity(spec, log2_ceil(big_n))
    period = big_n // n
    s_n = pow(shift, n, p)
    g_n = pow(g_big, n, p)
    vals = []
    h_n = 1
    for _ in range(period):
        vals.append(pow((s_n * h_n - 1) % p, -1, p))
        h_n = h_n * g_n % p
    col = fops.from_ints(spec, vals, device)
    return col.repeat(1, big_n // period)


def divide_by_z_h(spec: FieldSpec, coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Divide a polynomial (exactly divisible) by Z_H = X^n - 1: evaluate on
    the coset g*H_N (N = len(coeffs)), multiply by 1/Z_H, interpolate back
    (reference: src/polynomial.rs:330-380)."""
    require_eight_limbs(spec, "divide_by_z_h")
    N = coeffs.shape[-1]
    shift = spec.generator
    pre = FftPrecomputation(spec, N)
    values = coset_fft(pre, coeffs, shift)
    inv = z_h_inverses(spec, n, N, coeffs.device)
    invb = inv.reshape((LIMBS,) + (1,) * (coeffs.dim() - 2) + (N,))
    return coset_ifft(pre, fops.mul(spec, values, invb), shift)
