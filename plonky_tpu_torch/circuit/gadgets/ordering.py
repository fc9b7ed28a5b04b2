"""In-circuit ordering gadget (reference: src/circuit_ordering.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ..witness import LambdaGenerator, PartialWitness


@dataclass(frozen=True)
class OrderingTarget:
    lt: object
    eq: object
    gt: object


LT, EQ, GT = -1, 0, 1


def constant_ordering(builder, ordering: int) -> OrderingTarget:
    f = builder.zero_wire()
    t = builder.one_wire()
    if ordering == LT:
        return OrderingTarget(t, f, f)
    if ordering == EQ:
        return OrderingTarget(f, t, f)
    return OrderingTarget(f, f, t)


def add_virtual_ordering_target(builder, validate: bool) -> OrderingTarget:
    o = OrderingTarget(builder.add_virtual_target(),
                       builder.add_virtual_target(),
                       builder.add_virtual_target())
    if validate:
        ordering_assert_valid(builder, o)
    return o


def set_ordering_target(witness: PartialWitness, target: OrderingTarget,
                        value: int):
    vals = {LT: (1, 0, 0), EQ: (0, 1, 0), GT: (0, 0, 1)}[value]
    witness.set_target(target.lt, vals[0])
    witness.set_target(target.eq, vals[1])
    witness.set_target(target.gt, vals[2])


def get_ordering_target(witness: PartialWitness, target: OrderingTarget) -> int:
    v = (witness.get_target(target.lt), witness.get_target(target.eq),
         witness.get_target(target.gt))
    return {(1, 0, 0): LT, (0, 1, 0): EQ, (0, 0, 1): GT}[v]


def add_ordering_generator(builder, ordering: OrderingTarget, lhs, rhs):
    def gen(_cs, w):
        a = w.get_target(lhs)
        b = w.get_target(rhs)
        r = PartialWitness()
        set_ordering_target(r, ordering, LT if a < b else (EQ if a == b else GT))
        return r

    builder.add_generator(LambdaGenerator([lhs, rhs], gen))


def ordering_assert_valid(builder, ordering: OrderingTarget):
    """One-hot validation (reference: circuit_ordering.rs:100-118)."""
    lt, eq, gt = ordering.lt, ordering.eq, ordering.gt
    builder.assert_binary(lt)
    builder.assert_binary(eq)
    builder.assert_binary(gt)
    builder.assert_zero(builder.mul(lt, eq))
    builder.assert_zero(builder.mul(lt, gt))
    builder.assert_zero(builder.mul(eq, gt))
    builder.assert_one(builder.add_many([lt, eq, gt]))
