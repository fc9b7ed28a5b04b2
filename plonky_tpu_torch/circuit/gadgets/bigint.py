"""In-circuit bigints with 86-bit limbs (reference: src/circuit_bigint.rs).

86-bit limbs (43 dibits): any ~256-bit element fits in 3 limbs, limb
products are ~172 bits, many can accumulate without overflowing the native
~254-bit field (reference doc at circuit_bigint.rs:5-10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ...utils import ceil_div, pad_to_multiple
from ..gates import Base4SumGate
from ..target import BoundedTarget
from ..witness import LambdaGenerator, PartialWitness
from .ordering import (
    OrderingTarget,
    add_ordering_generator,
    add_virtual_ordering_target,
)

LIMB_DIBITS = 43
LIMB_BITS = LIMB_DIBITS * 2


@dataclass
class BigIntTarget:
    limbs: List[object]
    max: int            # inclusive upper bound

    @staticmethod
    def zero() -> "BigIntTarget":
        return BigIntTarget([], 0)

    @staticmethod
    def new_unbounded(limbs) -> "BigIntTarget":
        return BigIntTarget(list(limbs), (1 << (LIMB_BITS * len(limbs))) - 1)

    def num_limbs(self) -> int:
        return len(self.limbs)

    def get_limb(self, i: int):
        return self.limbs[i]

    def get_bounded_limb(self, i: int) -> BoundedTarget:
        max_high = self.max >> (LIMB_BITS * i)
        max_any = (1 << LIMB_BITS) - 1
        return BoundedTarget(self.limbs[i], min(max_high, max_any))

    def get_bounded_limb_or_default(self, i: int, default: BoundedTarget):
        return self.get_bounded_limb(i) if i < self.num_limbs() else default

    def split_smallest_limb(self) -> Tuple[object, "BigIntTarget"]:
        return self.limbs[0], BigIntTarget(self.limbs[1:],
                                           self.max >> LIMB_BITS)


def biguint_to_limbs(value: int) -> List[int]:
    n = ceil_div(max(value.bit_length(), 1), LIMB_BITS) if value else 0
    base_mask = (1 << LIMB_BITS) - 1
    return [(value >> (i * LIMB_BITS)) & base_mask for i in range(n)]


def set_bigint_target(witness: PartialWitness, target: BigIntTarget, value: int):
    limbs = biguint_to_limbs(value)
    assert len(limbs) <= target.num_limbs(), "Not enough limbs for value"
    limbs += [0] * (target.num_limbs() - len(limbs))
    witness.set_targets(target.limbs, limbs)


def get_bigint_target(witness: PartialWitness, target: BigIntTarget) -> int:
    out = 0
    for i, limb in enumerate(target.limbs):
        out += witness.get_target(limb) << (i * LIMB_BITS)
    return out


def add_virtual_bigint_target(builder, max_: int, validate: bool) -> BigIntTarget:
    num_limbs = ceil_div(max(max_.bit_length(), 1), LIMB_BITS)
    limbs = builder.add_virtual_targets(num_limbs)
    if validate:
        for limb in limbs:
            builder.assert_dibit_length(limb, LIMB_DIBITS)
    return BigIntTarget(limbs, max_)


def constant_bigint(builder, value: int) -> BigIntTarget:
    limbs = [builder.constant_wire(l) for l in biguint_to_limbs(value)]
    return BigIntTarget(limbs, value)


def zero_bounded_target(builder) -> BoundedTarget:
    return BoundedTarget(builder.zero_wire(), 0)


def bigint_cmp(builder, x: BigIntTarget, y: BigIntTarget) -> OrderingTarget:
    """reference: circuit_bigint.rs:135-162."""
    num_limbs = max(x.num_limbs(), y.num_limbs())
    x = bigint_pad_limbs(builder, x, num_limbs)
    y = bigint_pad_limbs(builder, y, num_limbs)
    x_diff = builder.zero_wire()
    y_diff = builder.zero_wire()
    for i in range(num_limbs):
        equal = builder.is_equal(x.limbs[i], y.limbs[i])
        x_diff = builder.select(equal, x_diff, x.limbs[i])
        y_diff = builder.select(equal, y_diff, y.limbs[i])
    return _limb_cmp(builder, x_diff, y_diff)


def _limb_cmp(builder, x, y) -> OrderingTarget:
    ordering = add_virtual_ordering_target(builder, True)
    add_ordering_generator(builder, ordering, x, y)
    builder.copy(ordering.eq, builder.is_equal(x, y))
    delta = builder.sub(y, x)
    gt_delta = builder.mul(ordering.gt, delta)
    r = builder.mul_sub(ordering.lt, delta, gt_delta)
    max_dibits = pad_to_multiple(LIMB_DIBITS, Base4SumGate.NUM_LIMBS)
    builder.assert_dibit_length(r, max_dibits)
    return ordering


def bigint_add(builder, x: BigIntTarget, y: BigIntTarget) -> BigIntTarget:
    return bigint_add_many(builder, [x, y])


def bigint_add_many(builder, terms: List[BigIntTarget]) -> BigIntTarget:
    """Limbwise add with carries (reference: circuit_bigint.rs:199-252)."""
    num_limbs = max(t.num_limbs() for t in terms)
    carry = zero_bounded_target(builder)
    result_limbs = []
    for i in range(num_limbs):
        bounded = [carry]
        for t in terms:
            if t.num_limbs() > i:
                bounded.append(t.get_bounded_limb(i))
        s = _sum_limbs(builder, bounded)
        assert s.num_limbs() <= 2
        result_limbs.append(s.limbs[0] if s.limbs else builder.zero_wire())
        carry = s.get_bounded_limb_or_default(1, zero_bounded_target(builder))
    if carry.max != 0:
        result_limbs.append(carry.target)
    return BigIntTarget(result_limbs, sum(t.max for t in terms))


def _sum_limbs(builder, limbs: List[BoundedTarget]) -> BigIntTarget:
    nonzero = [l for l in limbs if l.max != 0]
    if not nonzero:
        return BigIntTarget.zero()
    if len(nonzero) == 1:
        return BigIntTarget([nonzero[0].target], nonzero[0].max)
    max_ = sum(l.max for l in limbs)
    s = builder.add_many([l.target for l in nonzero])
    return _target_to_bigint(builder, BoundedTarget(s, max_))


def _target_to_bigint(builder, input_: BoundedTarget) -> BigIntTarget:
    """Split a bounded native element into validated limbs
    (reference: circuit_bigint.rs:288-327)."""
    output = add_virtual_bigint_target(builder, input_.max, True)

    def gen(_cs, w):
        r = PartialWitness()
        set_bigint_target(r, output, w.get_target(input_.target))
        return r

    builder.add_generator(LambdaGenerator([input_.target], gen))
    joined = _bigint_to_target(builder, output)
    builder.copy(joined.target, input_.target)
    return output


def _bigint_to_target(builder, bigint: BigIntTarget) -> BoundedTarget:
    s = builder.zero_wire()
    mult = builder.constant_wire(1 << LIMB_BITS)
    for limb in reversed(bigint.limbs):
        s = builder.mul_add(s, mult, limb)
    return BoundedTarget(s, bigint.max)


def bigint_mul(builder, x: BigIntTarget, y: BigIntTarget) -> BigIntTarget:
    """Schoolbook with per-shift carry splitting (reference: :341-390)."""
    x_n, y_n = x.num_limbs(), y.num_limbs()
    result_digits = []
    carry = BigIntTarget.zero()
    for shift in range(x_n + y_n - 1):
        s = _bigint_to_target(builder, carry)
        for xi in range(x_n):
            yi = shift - xi
            if 0 <= yi < y_n:
                xl = x.get_bounded_limb(xi)
                yl = y.get_bounded_limb(yi)
                t = builder.mul_add(xl.target, yl.target, s.target)
                s = BoundedTarget(t, xl.max * yl.max + s.max)
        s_bigint = _target_to_bigint(builder, s)
        first, rest = s_bigint.split_smallest_limb()
        result_digits.append(first)
        carry = rest
    result_digits.extend(carry.limbs)
    return BigIntTarget(result_digits, x.max * y.max)


def bigint_div(builder, x, y):
    return bigint_div_rem(builder, x, y)[0]


def bigint_rem(builder, x, y):
    return bigint_div_rem(builder, x, y)[1]


def bigint_div_rem(builder, x: BigIntTarget, y: BigIntTarget):
    """Witnessed division verified by x = q y + r, r < y (reference: :404-457)."""
    div = add_virtual_bigint_target(builder, x.max, True)
    rem = add_virtual_bigint_target(builder, y.max - 1, True)

    def gen(_cs, w):
        xv = get_bigint_target(w, x)
        yv = get_bigint_target(w, y)
        q, r = divmod(xv, yv)
        out = PartialWitness()
        set_bigint_target(out, div, q)
        set_bigint_target(out, rem, r)
        return out

    builder.add_generator(LambdaGenerator(list(x.limbs) + list(y.limbs), gen))
    div_y = bigint_mul(builder, div, y)
    div_y_plus_rem = bigint_add(builder, div_y, rem)
    copy_bigint(builder, x, div_y_plus_rem)
    builder.assert_one(bigint_cmp(builder, rem, y).lt)
    return div, rem


def copy_bigint(builder, lhs: BigIntTarget, rhs: BigIntTarget):
    min_limbs = min(lhs.num_limbs(), rhs.num_limbs())
    for i in range(min_limbs):
        builder.copy(lhs.limbs[i], rhs.limbs[i])
    for i in range(min_limbs, lhs.num_limbs()):
        builder.assert_zero(lhs.limbs[i])
    for i in range(min_limbs, rhs.num_limbs()):
        builder.assert_zero(rhs.limbs[i])


def bigint_pad_limbs(builder, x: BigIntTarget, num_limbs: int) -> BigIntTarget:
    assert x.num_limbs() <= num_limbs
    limbs = list(x.limbs) + [builder.zero_wire()] * (num_limbs - x.num_limbs())
    return BigIntTarget(limbs, x.max)
