"""Transforms judged by random evaluations (Schwartz-Zippel), whole.

A transform of coefficients a_j (j < n_coeff, zero above) over the
n_dom-th roots w^k is v_k = sum_j a_j w^(jk).  For a point z drawn from
the seed,

    sum_k z^k v_k = sum_j a_j (1 - z^n_dom) / (1 - z w^j),

so one weighted sum of the n_dom values and one of the coefficients must
agree, and a single wrong value makes them disagree but with probability
n_dom / p.  The weights are Python-int powers and one batch inversion;
the sums run on `field.dot_mod`."""

from __future__ import annotations

import torch

from .field import dot_mod, ints_to_bytes


def powers(p: int, z: int, n: int) -> list:
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * z % p
    return out


def geometric_weights(p: int, z: int, omega: int, n_dom: int, n_coeff: int) -> list:
    """(1 - z^n_dom) / (1 - z omega^j) for j < n_coeff (one inversion)."""
    dens, cur = [], z % p
    for _ in range(n_coeff):
        d = (1 - cur) % p
        if d == 0:
            raise ValueError("z is a root of the domain")
        dens.append(d)
        cur = cur * omega % p
    prefix, acc = [], 1
    for d in dens:
        prefix.append(acc)
        acc = acc * d % p
    inv = pow(acc, -1, p)
    num = (1 - pow(z, n_dom, p)) % p
    out = [0] * n_coeff
    for j in range(n_coeff - 1, -1, -1):
        out[j] = num * inv * prefix[j] % p
        inv = inv * dens[j] % p
    return out


class TransformCheck:
    """The two weight vectors of one domain and one point z: `values`
    over the n_dom evaluations, `coeffs` over the first n_coeff
    coefficients (as bytes, on `device`)."""

    def __init__(self, p: int, z: int, omega: int, n_dom: int, n_coeff: int,
                 device, nbytes: int = 32):
        self.p = p
        self.values = torch.from_numpy(
            ints_to_bytes(powers(p, z, n_dom), nbytes).copy()).to(device)
        self.coeffs = torch.from_numpy(ints_to_bytes(
            geometric_weights(p, z, omega, n_dom, n_coeff), nbytes).copy()).to(device)

    def mismatches(self, coeffs: torch.Tensor, values: torch.Tensor) -> int:
        """Rows k of [L, K, n_coeff] coefficients and [L, K, n_dom] values
        where the values are not the transform of the coefficients."""
        lhs = dot_mod(self.values, values, self.p)
        rhs = dot_mod(self.coeffs, coeffs, self.p)
        return sum(a != b for a, b in zip(lhs, rhs))
