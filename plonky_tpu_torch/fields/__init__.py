from .spec import LIMBS, FieldSpec
from .instances import ALL_FIELDS, TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
from . import host, ops
