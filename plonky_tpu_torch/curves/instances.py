"""The Tweedledee/Tweedledum 2-cycle (the recursion pair).

Constants converted to canonical form from the reference's Montgomery-form
curve files (reference: src/curve/tweedledee_curve.rs,
tweedledum_curve.rs).
"""

from ..fields.instances import TWEEDLEDEE_BASE, TWEEDLEDUM_BASE
from .spec import CurveSpec

# reference: src/curve/tweedledee_curve.rs:7-38
TWEEDLEDEE = CurveSpec(
    name="Tweedledee",
    base=TWEEDLEDEE_BASE,
    scalar=TWEEDLEDUM_BASE,
    b=5,
    generator_affine=(TWEEDLEDEE_BASE.p - 1, 2),
    zeta=0x36C66D3A1E049A5887AD8B5FF9731FFE69CF8DE720E52EC14394C2BD148FA4FD,
    zeta_scalar=0x1508415AB5E97C949BEBC9146EF83D9A7881FB239BA41A268598ABB3A410C9C8,
)

# reference: src/curve/tweedledum_curve.rs:7-52
TWEEDLEDUM = CurveSpec(
    name="Tweedledum",
    base=TWEEDLEDUM_BASE,
    scalar=TWEEDLEDEE_BASE,
    b=7,
    generator_affine=(
        1,
        0x236E10FB7436B6ACA9F89AD5C97B08C68AAC09FBCE9F8A5B7B62A28B459AF8EB,
    ),
    zeta=0x2AF7BEA54A16836B641436EB9107C2658B08A603D09B3F931BA7B92E5BEF3638,
    zeta_scalar=0x093992C5E1FB65A7785274A0068CE00199BB1340487D58084097ED16EB705B03,
)

ALL_CURVES = [TWEEDLEDEE, TWEEDLEDUM]
