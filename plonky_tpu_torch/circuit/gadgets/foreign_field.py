"""Foreign-field arithmetic gadget (reference: src/circuit_foreign_field.rs):
elements of a non-native field Fq represented as in-circuit bigints, reduced
mod |Fq| after each operation."""

from __future__ import annotations

from dataclasses import dataclass

from ...fields.spec import FieldSpec
from ..witness import PartialWitness
from .bigint import (
    BigIntTarget,
    bigint_add_many,
    bigint_mul,
    bigint_rem,
    constant_bigint,
    get_bigint_target,
)


@dataclass
class ForeignFieldTarget:
    value: BigIntTarget
    field: FieldSpec


def constant_foreign_field(builder, spec: FieldSpec, constant: int) -> ForeignFieldTarget:
    return ForeignFieldTarget(constant_bigint(builder, constant % spec.p), spec)


def foreign_field_add_many(builder, terms) -> ForeignFieldTarget:
    spec = terms[0].field
    s = bigint_add_many(builder, [t.value for t in terms])
    return _reduce(builder, spec, s)


def foreign_field_add(builder, x: ForeignFieldTarget, y: ForeignFieldTarget):
    return foreign_field_add_many(builder, [x, y])


def foreign_field_mul(builder, x: ForeignFieldTarget, y: ForeignFieldTarget):
    product = bigint_mul(builder, x.value, y.value)
    return _reduce(builder, x.field, product)


def _reduce(builder, spec: FieldSpec, x: BigIntTarget) -> ForeignFieldTarget:
    order = constant_bigint(builder, spec.p)
    return ForeignFieldTarget(bigint_rem(builder, x, order), spec)


def get_foreign_field_target(witness: PartialWitness,
                             target: ForeignFieldTarget) -> int:
    return get_bigint_target(witness, target.value) % target.field.p
