from .spec import CurveSpec
from .instances import (ALL_CURVES, BLS12_377, HALO_CURVES, PALLAS,
                        TWEEDLEDEE, TWEEDLEDUM, VESTA)
from . import host, msm, ops
from .host import AffinePoint, generator, zero_point
