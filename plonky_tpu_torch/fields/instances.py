"""The two fields of each 2-cycle (Tweedledee/Tweedledum, Pallas/Vesta),
and BLS12-377's two.

Mathematical constants match the reference exactly (canonical values derived
from the Montgomery-form constants in src/field/*.rs):

* TweedledeeBase  (reference: src/field/tweedledee_base.rs)  -- scalar field
  of Tweedledum, base field of Tweedledee.
* TweedledumBase  (reference: src/field/tweedledum_base.rs)
* PallasBase / VestaBase (reference: src/field/pallas_base.rs, vesta_base.rs)
* Bls12377Base (377 bits, 12 limbs) and Bls12377Scalar (253 bits, 8 limbs)
  (reference: src/field/bls12_377_base.rs, bls12_377_scalar.rs)
"""

from __future__ import annotations

import functools

from . import host, ops
from .spec import FieldSpec

# p = 2^254 + 4707489545178046908921067385359695873
# (reference: src/field/tweedledee_base.rs:21-27)
TWEEDLEDEE_BASE = FieldSpec(
    name="TweedledeeBase",
    p=0x40000000000000000000000000000000038AA127696286C9842CAFD400000001,
    generator=5,
    alpha=5,
    two_adicity=34,
)

# p = 2^254 + 4707489544292117082687961190295928833
# (reference: src/field/tweedledum_base.rs:21-27)
TWEEDLEDUM_BASE = FieldSpec(
    name="TweedledumBase",
    p=0x40000000000000000000000000000000038AA1276C3F59B9A14064E200000001,
    generator=5,
    alpha=5,
    two_adicity=33,
)

# Pasta curves' Fp (reference: src/field/pallas_base.rs:21-27)
PALLAS_BASE = FieldSpec(
    name="PallasBase",
    p=0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    generator=5,
    alpha=5,
    two_adicity=32,
)

# Pasta curves' Fq (reference: src/field/vesta_base.rs:21-27)
VESTA_BASE = FieldSpec(
    name="VestaBase",
    p=0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    generator=5,
    alpha=5,
    two_adicity=32,
)

# BLS12-377 G1 base field, 377 bits
# (reference: src/field/bls12_377_base.rs:26-27, generator/alpha :198-200)
BLS12_377_BASE = FieldSpec(
    name="Bls12377Base",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=5,
    alpha=5,
    two_adicity=46,
)

# BLS12-377 scalar field, 253 bits
# (reference: src/field/bls12_377_scalar.rs:26, generator/alpha :166-169,
#  canonical value of the Montgomery-form constant = 11)
BLS12_377_SCALAR = FieldSpec(
    name="Bls12377Scalar",
    p=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=11,
    alpha=11,
    two_adicity=47,
)

ALL_FIELDS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, PALLAS_BASE, VESTA_BASE,
              BLS12_377_BASE, BLS12_377_SCALAR]


class Field:
    """A FieldSpec with its device ops (tensors [L, *batch], the kernels on
    the card) and its host ops on python ints bound to it.  The port's
    device values are always canonical, so it has no `canonicalize`."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p

    # -- device ops -------------------------------------------------------
    def add(self, a, b):
        return ops.add(self.spec, a, b)

    def sub(self, a, b):
        return ops.sub(self.spec, a, b)

    def neg(self, a):
        return ops.neg(self.spec, a)

    def mul(self, a, b):
        return ops.mul(self.spec, a, b)

    def square(self, a):
        return ops.square(self.spec, a)

    def inverse(self, a):
        return ops.inverse(self.spec, a)

    def exp_const(self, x, e: int):
        return ops.exp_const(self.spec, x, e)

    def kth_root(self, x, k: int):
        return ops.kth_root(self.spec, x, k)

    # -- conversions (the card unless device="cpu") -------------------------
    def from_ints(self, values, device=None):
        return ops.from_ints(self.spec, values, device)

    def to_ints(self, x):
        return ops.to_ints(self.spec, x)

    def constant(self, v: int, batch=(), device=None):
        return ops.constant(self.spec, v, batch, device)

    # -- host ops ---------------------------------------------------------
    def h_inverse(self, x: int) -> int:
        return host.inverse(self.spec, x)

    def h_exp(self, x: int, e: int) -> int:
        return host.exp(self.spec, x, e)

    def h_sqrt(self, x: int):
        return host.square_root(self.spec, x)

    def h_kth_root(self, x: int, k: int) -> int:
        return host.kth_root(self.spec, x, k)

    def h_root_of_unity(self, n_power: int) -> int:
        return host.primitive_root_of_unity(self.spec, n_power)

    def __repr__(self):
        return f"Field({self.spec.name})"


@functools.lru_cache(maxsize=None)
def get_field(spec: FieldSpec) -> Field:
    return Field(spec)
