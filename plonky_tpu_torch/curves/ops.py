"""Batched, branch-free curve arithmetic on canonical limb tensors.

A batched point is a tuple (X, Y, Z) of base-field tensors [L, *batch]
(L = curve.base.limbs: 8 on the Tweedle curves, 12 on BLS12-377) in
projective coordinates; the identity is (0 : 1 : 0).  Addition and
doubling are the COMPLETE formulas of Renes-Costello-Batina 2015
(Algorithms 7 and 9, a = 0), which have no exceptional cases.

K2, the curve kernel (csrc/curve_kernels.cu, built for 8 and for 12
limbs), computes `add` and `double` on CUDA tensors, one thread per point,
in Montgomery form inside the kernel (the MSM's Horner chain is K2's
`curve_horner`, curves/msm.py).
`add_plain` / `double_plain` are its plain PyTorch versions (the same
formulas over the plain field ops, with independent products stacked into
one call); a wrapper takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import _cuda
from ..device import resolve
from ..fields import ops as fops
from ..fields.spec import LIMB_BITS, int_to_limbs
from .spec import CurveSpec

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def identity(curve: CurveSpec, batch=(), device=None) -> Point:
    f = curve.base
    dev = resolve(device)
    return (fops.zeros(f, batch, dev),
            fops.constant(f, 1, batch, dev).contiguous(),
            fops.zeros(f, batch, dev))


def from_affine(curve: CurveSpec, x: torch.Tensor, y: torch.Tensor,
                zero_mask=None) -> Point:
    """Affine coords (+ optional zero mask over the batch) -> projective."""
    f = curve.base
    one = fops.constant(f, 1, x.shape[1:], x.device).contiguous()
    if zero_mask is None:
        return (x, y, one)
    keep = ~zero_mask.to(torch.bool)
    zero = torch.zeros_like(x)
    return (fops.select(keep, x, zero), fops.select(keep, y, one),
            fops.select(keep, one, zero))


@functools.lru_cache(maxsize=None)
def _consts_host(curve: CurveSpec) -> np.ndarray:
    """The point kernels' constant buffer (csrc/curve.cuh:curve_set_consts):
    the field constants (FieldSpec.kernel_consts), b3 = 3b mod p, and
    R^2 mod p with R = 2^(32 L), the factor into Montgomery form (all at
    the base field's L limbs)."""
    f = curve.base
    return np.concatenate([f.kernel_consts,
                           int_to_limbs(3 * curve.b % f.p, f.limbs),
                           int_to_limbs(pow(2, 2 * LIMB_BITS * f.limbs, f.p),
                                        f.limbs)])


def _broadcast(coords):
    batch = fops.batch_shape(*coords)
    return batch, [fops._expand(c, batch).reshape(c.shape[0], -1)
                   for c in coords]


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _split(x: torch.Tensor, k: int):
    return x.chunk(k, dim=1)


def add_plain(curve: CurveSpec, p1: Point, p2: Point) -> Point:
    """RCB15 Algorithm 7 (a = 0) in four plain field calls, each over the
    independent values of one layer stacked along the batch.  The values
    equal those of csrc/curve.cuh: t3 = X1 Y2 + X2 Y1 is what the kernel
    computes as (X1 + Y1)(X2 + Y2) - t0 - t1, and so on."""
    f = curve.base
    batch, (X1, Y1, Z1, X2, Y2, Z2) = _broadcast([*p1, *p2])
    n = X1.shape[1]

    def col(v):
        return fops.column(f, v, X1.device).expand(f.limbs, n)

    zero = torch.zeros_like(X1)
    b3 = 3 * curve.b
    t0, t1, t2, t3, t4, xz = _split(fops.product_sum_plain(f, [
        (_cat(X1, Y1, Z1, X1, Y1, X1), _cat(X2, Y2, Z2, Y2, Z2, Z2), 1),
        (_cat(zero, zero, zero, Y1, Z1, Z1), _cat(zero, zero, zero, X2, Y2, X2),
         1)]), 6)
    t0_3, t2b3, yb3 = _split(fops.mul_plain(
        f, _cat(t0, t2, xz), _cat(col(3), col(b3), col(b3))), 3)
    z3p, t1m, neg_yb3 = _split(fops.product_sum_plain(f, [
        (_cat(t1, t1, zero), None, 1),
        (_cat(t2b3, t2b3, yb3), _cat(col(1), col(-1), col(-1)), 1)]), 3)
    X3, Y3, Z3 = _split(fops.product_sum_plain(f, [
        (_cat(t3, yb3, z3p), _cat(t1m, t0_3, t4), 1),
        (_cat(t4, t1m, t0_3), _cat(neg_yb3, z3p, t3), 1)]), 3)
    return tuple(c.reshape(f.limbs, *batch) for c in (X3, Y3, Z3))


def double_plain(curve: CurveSpec, p: Point) -> Point:
    """RCB15 Algorithm 9 (a = 0) in four plain field calls (see add_plain);
    the values equal those of csrc/curve.cuh."""
    f = curve.base
    batch, (X, Y, Z) = _broadcast(list(p))
    n = X.shape[1]

    def col(v):
        return fops.column(f, v, X.device).expand(f.limbs, n)

    zero = torch.zeros_like(X)
    t0, t1, t2, txy = _split(fops.mul_plain(f, _cat(Y, Y, Z, X),
                                            _cat(Y, Z, Z, Y)), 4)
    z3p, t2b3 = _split(fops.mul_plain(f, _cat(t0, t2),
                                      _cat(col(8), col(3 * curve.b))), 2)
    x3p, Z3, y3p, t0m = _split(fops.product_sum_plain(f, [
        (_cat(t2b3, t1, t0, t0), _cat(z3p, z3p, col(1), col(1)), 1),
        (_cat(zero, zero, t2b3, t2b3), _cat(zero, zero, col(1), col(-3)), 1)]),
        4)
    Y3, X3 = _split(fops.product_sum_plain(f, [
        (_cat(t0m, t0m), _cat(y3p, txy), 1),
        (_cat(x3p, t0m), _cat(col(1), txy), 1)]), 2)
    return tuple(c.reshape(f.limbs, *batch) for c in (X3, Y3, Z3))


def _launch_point(kernel: str, curve: CurveSpec, coords) -> Point:
    nl = curve.base.limbs
    name, entry = _cuda.kernel(kernel, nl)
    batch = fops.batch_shape(*coords)
    dev = coords[0].device
    outs = [torch.empty((nl, *batch), dtype=torch.int32, device=dev)
            for _ in range(3)]
    n = outs[0][0].numel()
    if n == 0:
        return tuple(outs)
    ins = [fops._expand(c, batch).contiguous() for c in coords]
    for t in ins:
        _cuda.check(name, t, nl)
    _cuda.launch(name, entry, (*outs, *ins), *[t.data_ptr() for t in outs],
                 *[t.data_ptr() for t in ins], n,
                 _consts_host(curve).ctypes.data)
    return tuple(outs)


def add(curve: CurveSpec, p1: Point, p2: Point) -> Point:
    """Complete projective addition (K2 on the card)."""
    if not fops._dispatch(p1[0]):
        return add_plain(curve, p1, p2)
    return _launch_point("curve_add", curve, [*p1, *p2])


def double(curve: CurveSpec, p: Point) -> Point:
    """Complete projective doubling (K2 on the card)."""
    if not fops._dispatch(p[0]):
        return double_plain(curve, p)
    return _launch_point("curve_double", curve, list(p))


def neg(curve: CurveSpec, p: Point) -> Point:
    X, Y, Z = p
    return (X, fops.neg(curve.base, Y), Z)


def select(mask: torch.Tensor, p1: Point, p2: Point) -> Point:
    return tuple(fops.select(mask, a, b) for a, b in zip(p1, p2))


def is_identity(curve: CurveSpec, p: Point) -> torch.Tensor:
    return fops.is_zero(curve.base, p[2])


def to_affine(curve: CurveSpec, p: Point):
    """Projective -> (x, y, zero_mask), with one batched Fermat inversion
    (the identity maps to x = y = 0 and a set mask)."""
    f = curve.base
    X, Y, Z = p
    zinv = fops.inverse(f, Z)
    return (fops.mul(f, X, zinv), fops.mul(f, Y, zinv), fops.is_zero(f, Z))


def scalar_mul_bits(curve: CurveSpec, p: Point, bits: torch.Tensor) -> Point:
    """[e] p with e given on the device as little-endian bits [nbits,
    *batch] (0/1): right-to-left double and add (K2's add and double on
    the card), every bit's sum taken and kept where the bit is set."""
    acc = identity(curve, p[0].shape[1:], p[0].device)
    cur = p
    for i, bit in enumerate(bits):
        acc = select(bit, add(curve, acc, cur), acc)
        if i + 1 < len(bits):
            cur = double(curve, cur)
    return acc


def eq_points(curve: CurveSpec, p1: Point, p2: Point) -> torch.Tensor:
    """Projective equality over the batch: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1
    for two finite points, or both the identity."""
    f = curve.base
    x_eq = fops.eq(f, fops.mul(f, p1[0], p2[2]), fops.mul(f, p2[0], p1[2]))
    y_eq = fops.eq(f, fops.mul(f, p1[1], p2[2]), fops.mul(f, p2[1], p1[2]))
    z1z = fops.is_zero(f, p1[2])
    z2z = fops.is_zero(f, p2[2])
    return (x_eq & y_eq & ~z1z & ~z2z) | (z1z & z2z)
