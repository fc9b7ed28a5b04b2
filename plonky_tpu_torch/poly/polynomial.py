"""Polynomial operations in coefficient form (the reference's
src/polynomial.rs): a polynomial is a tensor [L, ..., n] (L = spec.limbs,
8 or 12) with the coefficient axis last.  Evaluation (an inner product
with the point's powers), the division by Z_H on a coset, FFT products,
the power-series inverse by Newton iteration and the division with
remainder built on it (reference: src/polynomial.rs:130, 208-227, 262-327,
330-380)."""

from __future__ import annotations

import functools

import torch

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import FieldSpec
from ..utils import log2_ceil
from .fft import (FftPrecomputation, coset_fft, coset_ifft, fft, ifft,
                  pad_to, powers_dyn)


def eval_at(spec: FieldSpec, coeffs: torch.Tensor, point: int) -> torch.Tensor:
    """Evaluate [L, ..., n] polynomials at a host point."""
    return eval_at_dyn(spec, coeffs, fops.column(spec, point, coeffs.device))


def eval_at_dyn(spec: FieldSpec, coeffs: torch.Tensor,
                point_col: torch.Tensor) -> torch.Tensor:
    """Evaluate [L, ..., n] polynomials at a [L, 1] point: the inner
    product with its powers (reference `eval_from_power`:
    src/polynomial.rs:130)."""
    n = coeffs.shape[-1]
    pw = powers_dyn(spec, point_col, n)
    pwb = pw.reshape((spec.limbs,) + (1,) * (coeffs.dim() - 2) + (n,))
    prod = fops.mul(spec, coeffs, pwb)
    return fops.sum_reduce(spec, prod, prod.dim() - 2)


@functools.lru_cache(maxsize=None)
def z_h_inverses(spec: FieldSpec, n: int, big_n: int, device) -> torch.Tensor:
    """1 / ((s h)^n - 1) for h in H_{big_n}, s the field's generator, as a
    [L, big_n] tensor: (s h)^n takes only big_n / n values, so the
    host computes that period and tiles it."""
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
    N = coeffs.shape[-1]
    shift = spec.generator
    pre = FftPrecomputation(spec, N)
    values = coset_fft(pre, coeffs, shift)
    inv = z_h_inverses(spec, n, N, coeffs.device)
    invb = inv.reshape((spec.limbs,) + (1,) * (coeffs.dim() - 2) + (N,))
    return coset_ifft(pre, fops.mul(spec, values, invb), shift)


def mul_polys(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product by FFTs (reference: src/polynomial.rs:208-227), at the
    power of two at or above len(a) + len(b) coefficients."""
    n = 1 << log2_ceil(a.shape[-1] + b.shape[-1])
    pre = FftPrecomputation(spec, n)
    return ifft(pre, fops.mul(spec, fft(pre, pad_to(a, n)),
                              fft(pre, pad_to(b, n))))


def _const_poly(spec: FieldSpec, v: int, like: torch.Tensor, n: int) -> torch.Tensor:
    """The constant v as [L, ..., n] coefficients (batch axes of
    `like`)."""
    c = fops.constant(spec, v, tuple(like.shape[1:-1]) + (1,), like.device)
    return pad_to(c.contiguous(), n)


def inv_mod_xn(spec: FieldSpec, f: torch.Tensor, n: int) -> torch.Tensor:
    """g with f g = 1 (mod x^n); f's constant term must be invertible.
    Newton's iteration g <- g (2 - f g) mod x^(2k), log2(n) doubling steps
    of FFT products (reference: src/polynomial.rs:262-294 runs the same
    iteration coefficient by coefficient on the host)."""
    g = fops.inverse(spec, f[..., :1])
    k = 1
    while k < n:
        k = min(2 * k, n)
        fg = mul_polys(spec, f[..., :min(f.shape[-1], k)], g)[..., :k]
        t = fops.sub(spec, _const_poly(spec, 2, fg, k), fg)
        g = mul_polys(spec, g, t)[..., :k]
    return g[..., :n]


def degree_host(spec: FieldSpec, f: torch.Tensor) -> int:
    """The index of the last nonzero coefficient over the whole batch (-1
    for zero), read back to the host."""
    nz = (f != 0).reshape(spec.limbs, -1, f.shape[-1]).any(dim=0).any(dim=0)
    idx = torch.nonzero(nz)
    return int(idx[-1]) if idx.numel() else -1


def polynomial_division(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                        deg_a: int | None = None, deg_b: int | None = None):
    """(q, r) with a = q b + r, deg r < deg b (reference:
    src/polynomial.rs:299-327): rev(q) = rev(a) inv_mod_xn(rev(b), k) mod
    x^k, k = deg a - deg b + 1.  Degrees the caller knows skip a
    readback."""
    if deg_a is None:
        deg_a = degree_host(spec, a)
    if deg_b is None:
        deg_b = degree_host(spec, b)
    if deg_b < 0:
        raise ZeroDivisionError("division by zero polynomial")
    batch = tuple(a.shape[1:-1]) + (1,)
    if deg_a < deg_b:
        return fops.zeros(spec, batch, a.device), a
    k = deg_a - deg_b + 1
    rev_a = torch.flip(a[..., :deg_a + 1], dims=[-1])
    rev_b = torch.flip(b[..., :deg_b + 1], dims=[-1])
    inv_rb = inv_mod_xn(spec, rev_b, k)
    q = torch.flip(mul_polys(spec, rev_a[..., :k], inv_rb)[..., :k], dims=[-1])
    if not deg_b:
        return q, fops.zeros(spec, batch, a.device)
    qb = mul_polys(spec, q, b[..., :deg_b + 1])
    return q, fops.sub(spec, a[..., :deg_b], qb[..., :deg_b])


def poly_from_ints(spec: FieldSpec, coeffs, device=None) -> torch.Tensor:
    """Python-int coefficients as [L, n] on `device` (the card unless
    told "cpu")."""
    return fops.from_ints(spec, coeffs, device)


def eval_host(spec: FieldSpec, coeffs, x: int) -> int:
    """Horner's rule on python-int coefficients."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % spec.p
    return acc
