from .spec import LIMBS, FieldSpec
from .instances import (ALL_FIELDS, BLS12_377_BASE, BLS12_377_SCALAR,
                        PALLAS_BASE, TWEEDLEDEE_BASE, TWEEDLEDUM_BASE,
                        VESTA_BASE, Field, get_field)
from . import host, ops
