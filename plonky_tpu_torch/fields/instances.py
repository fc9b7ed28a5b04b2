"""The two fields of the Tweedledee/Tweedledum cycle, and BLS12-377's two.

Mathematical constants match the reference exactly (canonical values derived
from the Montgomery-form constants in src/field/*.rs):

* TweedledeeBase  (reference: src/field/tweedledee_base.rs)  -- scalar field
  of Tweedledum, base field of Tweedledee.
* TweedledumBase  (reference: src/field/tweedledum_base.rs)
* Bls12377Base (377 bits, 12 limbs) and Bls12377Scalar (253 bits, 8 limbs)
  (reference: src/field/bls12_377_base.rs, bls12_377_scalar.rs)
"""

from __future__ import annotations

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

ALL_FIELDS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_BASE,
              BLS12_377_SCALAR]
