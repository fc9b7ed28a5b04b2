"""The Tweedledee/Tweedledum 2-cycle (the recursion pair), the
Pallas/Vesta 2-cycle, and BLS12-377's G1 (no endomorphism constants: it
is not a Halo curve).

Constants converted to canonical form from the reference's Montgomery-form
curve files (reference: src/curve/tweedledee_curve.rs,
tweedledum_curve.rs, pallas_curve.rs, vesta_curve.rs).
"""

from ..fields.instances import (BLS12_377_BASE, BLS12_377_SCALAR,
                                PALLAS_BASE, TWEEDLEDEE_BASE,
                                TWEEDLEDUM_BASE, VESTA_BASE)
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

# reference: src/curve/pallas_curve.rs:7-35
PALLAS = CurveSpec(
    name="Pallas",
    base=PALLAS_BASE,
    scalar=VESTA_BASE,
    b=5,
    generator_affine=(PALLAS_BASE.p - 1, 2),
    zeta=0x2D33357CB532458ED3552A23A8554E5005270D29D19FC7D27B7FD22F0201B547,
    zeta_scalar=0x397E65A7D7C1AD71AEE24B27E308F0A61259527EC1D4752E619D1840AF55F1B1,
)

# reference: src/curve/vesta_curve.rs:7-33
VESTA = CurveSpec(
    name="Vesta",
    base=VESTA_BASE,
    scalar=PALLAS_BASE,
    b=5,
    generator_affine=(VESTA_BASE.p - 1, 2),
    zeta=0x397E65A7D7C1AD71AEE24B27E308F0A61259527EC1D4752E619D1840AF55F1B1,
    zeta_scalar=0x2D33357CB532458ED3552A23A8554E5005270D29D19FC7D27B7FD22F0201B547,
)

# reference: src/curve/bls12_377_curve.rs:13-33 (decimal constants in comments)
BLS12_377 = CurveSpec(
    name="Bls12377",
    base=BLS12_377_BASE,
    scalar=BLS12_377_SCALAR,
    b=1,
    generator_affine=(
        81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
        241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    ),
)

ALL_CURVES = [TWEEDLEDEE, TWEEDLEDUM, PALLAS, VESTA, BLS12_377]
HALO_CURVES = [TWEEDLEDEE, TWEEDLEDUM, PALLAS, VESTA]
