"""The two fields of the Tweedledee/Tweedledum cycle.

Mathematical constants match the reference exactly (canonical values derived
from the Montgomery-form constants in src/field/*.rs):

* TweedledeeBase  (reference: src/field/tweedledee_base.rs)  -- scalar field
  of Tweedledum, base field of Tweedledee.
* TweedledumBase  (reference: src/field/tweedledum_base.rs)
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

ALL_FIELDS = [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE]
