"""MSM results by discrete logarithms.

The benchmark's basis is a doubling chain of A = a G: C_j = 2^j A for
j < m + L, and point i = j + m u (j < m, u < 2^L) is C_j plus C_(m+t)
for every set bit t of u; so its discrete log to G is
a (2^j + sum_t bit_t(u) 2^(m+t)) mod r.  An MSM of scalars s_i over it is
e G with

    e = a (sum_j 2^j S_j + sum_t 2^(m+t) T_t) mod r,
    S_j = sum_u s_(j + m u),  T_t = sum over i with bit t of (i div m) set of s_i,

which takes sums of limbs and one host scalar multiplication, not 2^22.
"""

from __future__ import annotations

import torch

from . import curve as rcurve
from .field import MASK32


def chain_points(c: rcurve.Curve, a: int, count: int) -> list:
    """[2^j (a G), j < count] as affine points."""
    pt = rcurve.mul(c, c.generator, a)
    out = []
    for _ in range(count):
        out.append(pt)
        pt = rcurve.add(c, pt, pt)
    return out


def chain_shape(n: int, m: int) -> tuple:
    """(m, L) of an n-point chain basis: m points of the chain, doubled L
    times (n = m 2^L; n a power of two)."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"the chain basis needs a power of two, not {n}")
    m = min(m, n)
    return m, (n // m).bit_length() - 1


def point_log(a: int, m: int, i: int, r: int) -> int:
    """The discrete log to G of point i of the chain basis."""
    j, u = i % m, i // m
    e = 1 << j
    t = 0
    while u:
        if u & 1:
            e += 1 << (m + t)
        u >>= 1
        t += 1
    return a * e % r


def msm_logs(scalars: torch.Tensor, a: int, m: int, r: int) -> list:
    """e_k with sum_i s_(k,i) P_i = e_k G for canonical scalars [Ls, K, N]
    (int32 limbs) over the N-point chain basis of A = a G, one e a row k."""
    ls, k, n = scalars.shape
    m, levels = chain_shape(n, m)
    s = (scalars.to(torch.int64) & MASK32).reshape(ls, k, n // m, m)
    sums = s.sum(2).cpu().tolist()                       # [Ls, K, m], < 2^44
    u = torch.arange(n // m, device=s.device)
    tops = [s[:, :, ((u >> t) & 1).bool()].sum((2, 3)).cpu().tolist()
            for t in range(levels)]                      # [L][Ls, K], < 2^54
    out = []
    for row in range(k):
        e = 0
        for j in range(m):
            e += sum(sums[limb][row][j] << (32 * limb) for limb in range(ls)) << j
        for t in range(levels):
            e += sum(tops[t][limb][row] << (32 * limb) for limb in range(ls)) << (m + t)
        out.append(a * e % r)
    return out


def truncated(scalars: torch.Tensor, bits: int) -> torch.Tensor:
    """The scalars with every bit from `bits` up cleared (int32 limbs)."""
    out = scalars.clone()
    for limb in range(out.shape[0]):
        lo = 32 * limb
        if bits <= lo:
            out[limb] = 0
        elif bits < lo + 32:
            keep = (1 << (bits - lo)) - 1
            out[limb] = (out[limb].to(torch.int64) & keep).to(torch.int32)
    return out


def expected_points(c: rcurve.Curve, scalars: torch.Tensor, a: int, m: int,
                    keep_bits: int | None = None) -> list:
    """The affine MSM results (None: infinity) of scalars [Ls, K, N] over
    the chain basis of A = a G; with `keep_bits`, of the scalars cut to
    their low keep_bits bits (the control's lower precision)."""
    if keep_bits is not None:
        scalars = truncated(scalars, keep_bits)
    return [rcurve.mul(c, c.generator, e) for e in msm_logs(scalars, a, m, c.r)]


def wrong_points(c: rcurve.Curve, a: int, m: int, window: int, samples: list,
                 control: bool) -> int:
    """Answers of the sampled (j, scalars, points) calls that differ from
    the reference's points; with `control`, the reference with each
    scalar cut below its top c-bit window stands in for the program."""
    top = window * (-(-c.r.bit_length() // window) - 1)
    wrong = 0
    for _j, scalars, got in samples:
        want = expected_points(c, scalars, a, m)
        if control:
            got = expected_points(c, scalars, a, m, top)
        wrong += sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))
    return wrong
