from .spec import LIMBS, FieldSpec
from .instances import (ALL_FIELDS, BLS12_377_BASE, BLS12_377_SCALAR,
                        TWEEDLEDEE_BASE, TWEEDLEDUM_BASE)
from . import host, ops
