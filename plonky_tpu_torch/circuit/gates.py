"""The ten gate types (reference: src/gates/*).

Each gate defines:
* NAME, PREFIX (the binary selector prefix packed into the constant
  polynomials; reference prefix tree at src/gates/mod.rs:1-17),
* `constraints(alg, ctx, local_constants, local_wires, right_wires,
  below_wires)` -- the unfiltered constraint polynomials, written once
  against an algebra (see algebra.py) and reused for the prover's batched
  8n-point evaluation, the verifier's scalar evaluation at zeta, and the
  recursive circuit,
* witness-generator behavior (dependencies/generate on host python ints;
  reference's WitnessGenerator impls).

`ctx` carries the scalar field spec and the inner curve (for the curve
gates' A/ZETA constants; reference gates are generic over InnerC).

NOTE on CurveEndoGate: the reference's witness generator writes its scalar
accumulators to the wrong wires and swaps the roles of the two scalar bits
(src/gates/curve_endo.rs:217-232 vs the constraints at :49-87).  We
implement the generator to MATCH THE CONSTRAINTS (SURVEY.md flags the
constraints as ground truth); the reference's recursive e2e test is ignored
("Fails for the moment") precisely because of such issues.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..fields import host as fhost
from ..hashing.rescue import RESCUE_SPONGE_WIDTH, mds_matrix
from .target import GRID_WIDTH, NUM_ROUTED_WIRES, NUM_WIRES, Wire
from .witness import PartialWitness


@dataclass(frozen=True)
class GateCtx:
    """Evaluation context: the constraint field and the inner curve."""
    spec: object            # FieldSpec of the circuit's scalar field
    inner_curve: object     # CurveSpec whose points the curve gates add


class Gate:
    NAME: str = ""
    PREFIX: tuple = ()

    def __init__(self, index: int):
        self.index = index

    # -- constraint evaluation ------------------------------------------
    @classmethod
    def constraints(cls, alg, ctx: GateCtx, local_constants, local_wires,
                    right_wires, below_wires) -> list:
        return []

    @classmethod
    def evaluate_filtered(cls, alg, ctx, local_constants, local_wires,
                          right_wires, below_wires) -> list:
        """filter = prod over prefix bits of c_i or (1 - c_i)
        (reference: src/gates/mod.rs:287-298)."""
        f = alg.one()
        for i, bit in enumerate(cls.PREFIX):
            c = local_constants[i]
            f = alg.mul(f, c if bit else alg.sub(alg.one(), c))
        unfiltered = cls.constraints(alg, ctx, local_constants, local_wires,
                                     right_wires, below_wires)
        return [alg.mul(f, u) for u in unfiltered]

    # -- witness generation (host) --------------------------------------
    def dependencies(self) -> list:
        return []

    def generate(self, ctx: GateCtx, constants, witness: PartialWitness) -> PartialWitness:
        return PartialWitness()

    def w(self, input_: int, gate_offset: int = 0) -> Wire:
        return Wire(self.index + gate_offset, input_)


class ArithmeticGate(Gate):
    """out = c0 * m0 * m1 + c1 * addend (reference: src/gates/arithmetic.rs)."""
    NAME = "ArithmeticGate"
    PREFIX = (True, False, False, True)
    WIRE_MULTIPLICAND_0 = 0
    WIRE_MULTIPLICAND_1 = 1
    WIRE_ADDEND = 2
    WIRE_OUTPUT = 3

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        c0 = lc[len(cls.PREFIX)]
        c1 = lc[len(cls.PREFIX) + 1]
        computed = alg.add(alg.mul(alg.mul(c0, lw[0]), lw[1]),
                           alg.mul(c1, lw[2]))
        return [alg.sub(computed, lw[cls.WIRE_OUTPUT])]

    def dependencies(self):
        return [self.w(0), self.w(1), self.w(2)]

    def generate(self, ctx, constants, witness):
        p = ctx.spec.p
        c0 = constants[self.index][len(self.PREFIX)]
        c1 = constants[self.index][len(self.PREFIX) + 1]
        m0 = witness.get_wire(self.w(0))
        m1 = witness.get_wire(self.w(1))
        addend = witness.get_wire(self.w(2))
        out = (c0 * m0 % p * m1 + c1 * addend) % p
        r = PartialWitness()
        r.set_wire(self.w(self.WIRE_OUTPUT), out)
        return r


class Base4SumGate(Gate):
    """acc_new = fold(acc_old, limbs: 4*acc + limb), limbs in [0, 4)
    (reference: src/gates/base_4_sum.rs)."""
    NAME = "Base4SumGate"
    PREFIX = (True, False, False, False)
    WIRE_ACC_OLD = 0
    WIRE_ACC_NEW = 1
    NUM_LIMBS = NUM_WIRES - 2
    NUM_ROUTED_LIMBS = NUM_ROUTED_WIRES - 2

    @staticmethod
    def wire_limb(i: int) -> int:
        return 2 + i

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        acc_old = lw[cls.WIRE_ACC_OLD]
        acc_new = lw[cls.WIRE_ACC_NEW]
        limbs = [lw[cls.wire_limb(i)] for i in range(cls.NUM_LIMBS)]
        computed = acc_old
        for limb in limbs:
            computed = alg.add(alg.mul_const(4, computed), limb)
        constraints = [alg.sub(computed, acc_new)]
        for limb in limbs:
            prod = alg.one()
            for j in range(4):
                prod = alg.mul(prod, alg.sub(limb, alg.constant(j)))
            constraints.append(prod)
        return constraints

    def dependencies(self):
        return [self.w(self.WIRE_ACC_OLD)] + \
            [self.w(self.wire_limb(i)) for i in range(self.NUM_LIMBS)]

    def generate(self, ctx, constants, witness):
        """Compute acc_new from acc_old and the limbs.  (The reference has
        no generator here and relies on copy propagation, which leaves the
        accumulator wires unpopulated -- zero-filled rows then violate the
        gate's own constraint.)"""
        p = ctx.spec.p
        acc = witness.get_wire(self.w(self.WIRE_ACC_OLD))
        for i in range(self.NUM_LIMBS):
            limb = witness.get_wire(self.w(self.wire_limb(i)))
            acc = (4 * acc + limb) % p
        r = PartialWitness()
        r.set_wire(self.w(self.WIRE_ACC_NEW), acc)
        return r


class BufferGate(Gate):
    """No constraints (reference: src/gates/buffer.rs)."""
    NAME = "BufferGate"
    PREFIX = (True, False, True, False, False, False)


class ConstantGate(Gate):
    """out = c0 (reference: src/gates/constant.rs)."""
    NAME = "ConstantGate"
    PREFIX = (True, False, True, True, False)
    WIRE_OUTPUT = 0

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        c = lc[len(cls.PREFIX)]
        return [alg.sub(c, lw[cls.WIRE_OUTPUT])]

    def generate(self, ctx, constants, witness):
        c = constants[self.index][len(self.PREFIX)]
        r = PartialWitness()
        r.set_wire(self.w(self.WIRE_OUTPUT), c)
        return r


class PublicInputGate(Gate):
    """Copies its 3 advice wires to the next BufferGate's routed wires
    (reference: src/gates/public_input.rs)."""
    NAME = "PublicInputGate"
    PREFIX = (True, False, True, False, False, True)

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        from .target import NUM_ADVICE_WIRES
        return [alg.sub(lw[NUM_ROUTED_WIRES + i], rw[i])
                for i in range(NUM_ADVICE_WIRES)]

    def generate(self, ctx, constants, witness):
        from .target import NUM_ADVICE_WIRES
        r = PartialWitness()
        for i in range(NUM_ADVICE_WIRES):
            wire = self.w(NUM_ROUTED_WIRES + i)
            if witness.contains_wire(wire):
                r.set_wire(Wire(self.index + 1, i), witness.get_wire(wire))
        return r


class CurveAddGate(Gate):
    """Conditional incomplete affine add + scalar-bit accumulator
    (reference: src/gates/curve_add.rs)."""
    NAME = "CurveAddGate"
    PREFIX = (True, False, True, False, True)
    WIRE_GROUP_ACC_X = 0
    WIRE_GROUP_ACC_Y = 1
    WIRE_SCALAR_ACC_OLD = 2
    WIRE_SCALAR_ACC_NEW = 3
    WIRE_ADDEND_X = 4
    WIRE_ADDEND_Y = 5
    WIRE_SCALAR_BIT = 6
    WIRE_INVERSE = 7
    WIRE_LAMBDA = 8

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        x1, y1 = lw[cls.WIRE_GROUP_ACC_X], lw[cls.WIRE_GROUP_ACC_Y]
        x4, y4 = rw[cls.WIRE_GROUP_ACC_X], rw[cls.WIRE_GROUP_ACC_Y]
        sa_old = lw[cls.WIRE_SCALAR_ACC_OLD]
        sa_new = lw[cls.WIRE_SCALAR_ACC_NEW]
        x2, y2 = lw[cls.WIRE_ADDEND_X], lw[cls.WIRE_ADDEND_Y]
        bit = lw[cls.WIRE_SCALAR_BIT]
        inverse = lw[cls.WIRE_INVERSE]
        lam = lw[cls.WIRE_LAMBDA]

        computed_lambda = alg.mul(alg.sub(y1, y2), inverse)
        x3 = alg.sub(alg.mul(lam, lam), alg.add(x1, x2))
        # y3 uses x4 instead of x3 to keep degree low (see reference comment)
        y3 = alg.sub(alg.mul(lam, alg.sub(x1, x4)), y1)
        not_bit = alg.sub(alg.one(), bit)
        computed_x4 = alg.add(alg.mul(bit, x3), alg.mul(not_bit, x1))
        computed_y4 = alg.add(alg.mul(bit, y3), alg.mul(not_bit, y1))
        return [
            alg.sub(computed_lambda, lam),
            alg.sub(computed_x4, x4),
            alg.sub(computed_y4, y4),
            alg.sub(sa_new, alg.add(alg.mul_const(2, sa_old), bit)),
            alg.mul(bit, not_bit),
            alg.sub(alg.mul(inverse, alg.sub(x1, x2)), alg.one()),
        ]

    def dependencies(self):
        return [self.w(self.WIRE_GROUP_ACC_X), self.w(self.WIRE_GROUP_ACC_Y),
                self.w(self.WIRE_SCALAR_ACC_OLD), self.w(self.WIRE_ADDEND_X),
                self.w(self.WIRE_ADDEND_Y), self.w(self.WIRE_SCALAR_BIT)]

    def generate(self, ctx, constants, witness):
        p = ctx.spec.p
        x1 = witness.get_wire(self.w(self.WIRE_GROUP_ACC_X))
        y1 = witness.get_wire(self.w(self.WIRE_GROUP_ACC_Y))
        sa_old = witness.get_wire(self.w(self.WIRE_SCALAR_ACC_OLD))
        x2 = witness.get_wire(self.w(self.WIRE_ADDEND_X))
        y2 = witness.get_wire(self.w(self.WIRE_ADDEND_Y))
        bit = witness.get_wire(self.w(self.WIRE_SCALAR_BIT))
        assert bit in (0, 1)
        sa_new = (2 * sa_old + bit) % p
        dx = (x1 - x2) % p
        dy = (y1 - y2) % p
        inverse = pow(dx, -1, p)
        lam = dy * inverse % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        x4, y4 = (x3, y3) if bit == 1 else (x1, y1)
        r = PartialWitness()
        r.set_wire(Wire(self.index + 1, self.WIRE_GROUP_ACC_X), x4)
        r.set_wire(Wire(self.index + 1, self.WIRE_GROUP_ACC_Y), y4)
        r.set_wire(self.w(self.WIRE_SCALAR_ACC_NEW), sa_new)
        r.set_wire(self.w(self.WIRE_INVERSE), inverse)
        r.set_wire(self.w(self.WIRE_LAMBDA), lam)
        return r


class CurveDblGate(Gate):
    """Affine doubling with witnessed inverse of 2y
    (reference: src/gates/curve_dbl.rs)."""
    NAME = "CurveDblGate"
    PREFIX = (True, False, True, True, True)
    WIRE_X_OLD = 0
    WIRE_Y_OLD = 1
    WIRE_X_NEW = 2
    WIRE_Y_NEW = 3
    WIRE_INVERSE = 4
    WIRE_LAMBDA = 5

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        x_old, y_old = lw[cls.WIRE_X_OLD], lw[cls.WIRE_Y_OLD]
        x_new, y_new = lw[cls.WIRE_X_NEW], lw[cls.WIRE_Y_NEW]
        inverse, lam = lw[cls.WIRE_INVERSE], lw[cls.WIRE_LAMBDA]
        # A = 0 for all five curves
        lam_num = alg.mul_const(3, alg.mul(x_old, x_old))
        computed_lambda = alg.mul(lam_num, inverse)
        computed_x_new = alg.sub(alg.mul(lam, lam), alg.mul_const(2, x_old))
        computed_y_new = alg.sub(alg.mul(lam, alg.sub(x_old, x_new)), y_old)
        return [
            alg.sub(computed_lambda, lam),
            alg.sub(computed_x_new, x_new),
            alg.sub(computed_y_new, y_new),
            alg.sub(alg.mul(alg.mul_const(2, y_old), inverse), alg.one()),
        ]

    def dependencies(self):
        return [self.w(self.WIRE_X_OLD), self.w(self.WIRE_Y_OLD)]

    def generate(self, ctx, constants, witness):
        p = ctx.spec.p
        x_old = witness.get_wire(self.w(self.WIRE_X_OLD))
        y_old = witness.get_wire(self.w(self.WIRE_Y_OLD))
        inverse = pow(2 * y_old % p, -1, p)
        lam = 3 * x_old * x_old % p * inverse % p
        x_new = (lam * lam - 2 * x_old) % p
        y_new = (lam * (x_old - x_new) - y_old) % p
        r = PartialWitness()
        r.set_wire(self.w(self.WIRE_INVERSE), inverse)
        r.set_wire(self.w(self.WIRE_LAMBDA), lam)
        r.set_wire(self.w(self.WIRE_X_NEW), x_new)
        r.set_wire(self.w(self.WIRE_Y_NEW), y_new)
        return r


class CurveEndoGate(Gate):
    """One step of Halo's endomorphism double-and-add over 2 scalar bits
    (reference: src/gates/curve_endo.rs; constraints at :49-87 are ground
    truth -- see module docstring about the reference generator's bug)."""
    NAME = "CurveEndoGate"
    PREFIX = (True, True)
    WIRE_GROUP_ACC_X = 0
    WIRE_GROUP_ACC_Y = 1
    WIRE_SCALAR_ACC_UNSIGNED = 2
    WIRE_SCALAR_ACC_SIGNED = 3
    WIRE_ADDEND_X = 4
    WIRE_ADDEND_Y = 5
    WIRE_SCALAR_BIT_0 = 6
    WIRE_SCALAR_BIT_1 = 7
    WIRE_INVERSE = 8

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        zeta = ctx.inner_curve.zeta
        x1, y1 = lw[cls.WIRE_GROUP_ACC_X], lw[cls.WIRE_GROUP_ACC_Y]
        x_in, y_in = lw[cls.WIRE_ADDEND_X], lw[cls.WIRE_ADDEND_Y]
        x3, y3 = rw[cls.WIRE_GROUP_ACC_X], rw[cls.WIRE_GROUP_ACC_Y]
        su_old = lw[cls.WIRE_SCALAR_ACC_UNSIGNED]
        su_new = bw[cls.WIRE_SCALAR_ACC_UNSIGNED]
        ss_old = lw[cls.WIRE_SCALAR_ACC_SIGNED]
        ss_new = bw[cls.WIRE_SCALAR_ACC_SIGNED]
        b0 = lw[cls.WIRE_SCALAR_BIT_0]
        b1 = lw[cls.WIRE_SCALAR_BIT_1]
        inverse = lw[cls.WIRE_INVERSE]
        one = alg.one()

        # x2 = ((zeta - 1) b1 + 1) x_in ; y2 = (2 b0 - 1) y_in
        x_mult = alg.add(alg.mul_const(zeta - 1, b1), one)
        x2 = alg.mul(x_mult, x_in)
        y2 = alg.mul(alg.sub(alg.mul_const(2, b0), one), y_in)

        lam = alg.mul(alg.sub(y1, y2), inverse)
        computed_x3 = alg.sub(alg.mul(lam, lam), alg.add(x1, x2))
        computed_y3 = alg.sub(alg.mul(lam, alg.sub(x1, x3)), y1)

        signed_mult = alg.add(alg.mul_const(zeta - 1, b1), one)
        signed_limb = alg.mul(alg.sub(alg.mul_const(2, b0), one), signed_mult)

        return [
            alg.sub(computed_x3, x3),
            alg.sub(computed_y3, y3),
            alg.sub(su_new, alg.add(alg.mul_const(4, su_old),
                                    alg.add(alg.mul_const(2, b1), b0))),
            alg.sub(ss_new, alg.add(alg.mul_const(2, ss_old), signed_limb)),
            alg.mul(b0, alg.sub(b0, one)),
            alg.mul(b1, alg.sub(b1, one)),
            alg.sub(alg.mul(inverse, alg.sub(x1, x2)), one),
        ]

    def dependencies(self):
        return [self.w(self.WIRE_GROUP_ACC_X), self.w(self.WIRE_GROUP_ACC_Y),
                self.w(self.WIRE_SCALAR_ACC_UNSIGNED),
                self.w(self.WIRE_SCALAR_ACC_SIGNED),
                self.w(self.WIRE_ADDEND_X), self.w(self.WIRE_ADDEND_Y),
                self.w(self.WIRE_SCALAR_BIT_0), self.w(self.WIRE_SCALAR_BIT_1)]

    def generate(self, ctx, constants, witness):
        p = ctx.spec.p
        zeta = ctx.inner_curve.zeta
        x1 = witness.get_wire(self.w(self.WIRE_GROUP_ACC_X))
        y1 = witness.get_wire(self.w(self.WIRE_GROUP_ACC_Y))
        su_old = witness.get_wire(self.w(self.WIRE_SCALAR_ACC_UNSIGNED))
        ss_old = witness.get_wire(self.w(self.WIRE_SCALAR_ACC_SIGNED))
        px = witness.get_wire(self.w(self.WIRE_ADDEND_X))
        py = witness.get_wire(self.w(self.WIRE_ADDEND_Y))
        b0 = witness.get_wire(self.w(self.WIRE_SCALAR_BIT_0))
        b1 = witness.get_wire(self.w(self.WIRE_SCALAR_BIT_1))
        assert b0 in (0, 1) and b1 in (0, 1)

        # Matches the CONSTRAINTS: endo applied when b1 = 1, negate when b0 = 0.
        s_x = px * zeta % p if b1 == 1 else px
        s_y = py if b0 == 1 else (-py) % p
        dx = (x1 - s_x) % p
        if dx == 0:
            raise ValueError(
                f"CurveEndoGate {self.index}: exceptional addition "
                f"(acc.x == addend.x): x1={x1:#x} b0={b0} b1={b1} "
                f"px={px:#x} py={py:#x} y1={y1:#x} s_y={s_y:#x}")
        inverse = pow(dx, -1, p)
        lam = (y1 - s_y) * inverse % p
        x3 = (lam * lam - x1 - s_x) % p
        y3 = (lam * (x1 - x3) - y1) % p

        su_new = (4 * su_old + 2 * b1 + b0) % p
        limb = 1 if b0 == 1 else p - 1
        if b1 == 1:
            limb = limb * zeta % p
        ss_new = (2 * ss_old + limb) % p

        r = PartialWitness()
        r.set_wire(Wire(self.index + 1, self.WIRE_GROUP_ACC_X), x3)
        r.set_wire(Wire(self.index + 1, self.WIRE_GROUP_ACC_Y), y3)
        r.set_wire(Wire(self.index + GRID_WIDTH, self.WIRE_SCALAR_ACC_UNSIGNED), su_new)
        r.set_wire(Wire(self.index + GRID_WIDTH, self.WIRE_SCALAR_ACC_SIGNED), ss_new)
        r.set_wire(self.w(self.WIRE_INVERSE), inverse)
        return r


class RescueStepAGate(Gate):
    """Rescue step A: roots^alpha = in; out = MDS * roots + const
    (reference: src/gates/rescue_a.rs)."""
    NAME = "RescueStepAGate"
    PREFIX = (False, False)

    @staticmethod
    def wire_acc(i: int) -> int:
        return i

    @staticmethod
    def wire_root(i: int) -> int:
        return RESCUE_SPONGE_WIDTH + i

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        W = RESCUE_SPONGE_WIDTH
        alpha = ctx.spec.alpha
        mds = mds_matrix(ctx.spec, W)
        ins = [lw[cls.wire_acc(i)] for i in range(W)]
        outs = [rw[cls.wire_acc(i)] for i in range(W)]
        roots = [lw[cls.wire_root(i)] for i in range(W)]
        constraints = []
        for i in range(W):
            acc = roots[i]
            for _ in range(alpha - 1):
                acc = alg.mul(acc, roots[i])
            constraints.append(alg.sub(acc, ins[i]))
            out_i = lc[len(cls.PREFIX) + i]
            for j in range(W):
                out_i = alg.add(out_i, alg.mul_const(mds[i][j], roots[j]))
            constraints.append(alg.sub(out_i, outs[i]))
        return constraints

    def dependencies(self):
        return [self.w(self.wire_acc(i)) for i in range(RESCUE_SPONGE_WIDTH)]

    def generate(self, ctx, constants, witness):
        W = RESCUE_SPONGE_WIDTH
        p = ctx.spec.p
        cs = constants[self.index]
        mds = mds_matrix(ctx.spec, W)
        ins = [witness.get_wire(self.w(self.wire_acc(i))) for i in range(W)]
        roots = [fhost.kth_root(ctx.spec, v, ctx.spec.alpha) for v in ins]
        r = PartialWitness()
        for i in range(W):
            r.set_wire(self.w(self.wire_root(i)), roots[i])
            out_i = cs[len(self.PREFIX) + i]
            for j in range(W):
                out_i = (out_i + mds[i][j] * roots[j]) % p
            r.set_wire(Wire(self.index + 1, self.wire_acc(i)), out_i)
        return r


class RescueStepBGate(Gate):
    """Rescue step B: out = MDS * in^alpha + const
    (reference: src/gates/rescue_b.rs; the native evaluation is ground
    truth -- the reference's recursive version indexes exps[i] where the
    native uses exps[j], an evident transcription bug)."""
    NAME = "RescueStepBGate"
    PREFIX = (False, True)

    @staticmethod
    def wire_acc(i: int) -> int:
        return i

    @classmethod
    def constraints(cls, alg, ctx, lc, lw, rw, bw):
        W = RESCUE_SPONGE_WIDTH
        alpha = ctx.spec.alpha
        mds = mds_matrix(ctx.spec, W)
        ins = [lw[cls.wire_acc(i)] for i in range(W)]
        outs = [rw[cls.wire_acc(i)] for i in range(W)]
        exps = []
        for v in ins:
            acc = v
            for _ in range(alpha - 1):
                acc = alg.mul(acc, v)
            exps.append(acc)
        constraints = []
        for i in range(W):
            out_i = lc[len(cls.PREFIX) + i]
            for j in range(W):
                out_i = alg.add(out_i, alg.mul_const(mds[i][j], exps[j]))
            constraints.append(alg.sub(out_i, outs[i]))
        return constraints

    def dependencies(self):
        return [self.w(self.wire_acc(i)) for i in range(RESCUE_SPONGE_WIDTH)]

    def generate(self, ctx, constants, witness):
        W = RESCUE_SPONGE_WIDTH
        p = ctx.spec.p
        cs = constants[self.index]
        mds = mds_matrix(ctx.spec, W)
        ins = [witness.get_wire(self.w(self.wire_acc(i))) for i in range(W)]
        exps = [pow(v, ctx.spec.alpha, p) for v in ins]
        r = PartialWitness()
        for i in range(W):
            out_i = cs[len(self.PREFIX) + i]
            for j in range(W):
                out_i = (out_i + mds[i][j] * exps[j]) % p
            r.set_wire(Wire(self.index + 1, self.wire_acc(i)), out_i)
        return r


# Order matters: evaluate_all_constraints sums the per-gate filtered
# constraint lists elementwise in THIS order (reference: src/gates/mod.rs:46-126).
ALL_GATES = [
    CurveAddGate,
    CurveDblGate,
    CurveEndoGate,
    Base4SumGate,
    PublicInputGate,
    BufferGate,
    ConstantGate,
    ArithmeticGate,
    RescueStepAGate,
    RescueStepBGate,
]


def evaluate_all_constraints(alg, ctx: GateCtx, local_constants, local_wires,
                             right_wires, below_wires) -> list:
    """Sum of all gates' filtered constraints, padded elementwise
    (reference: src/gates/mod.rs:46-126)."""
    unified: list = []
    for gate in ALL_GATES:
        cs = gate.evaluate_filtered(alg, ctx, local_constants, local_wires,
                                    right_wires, below_wires)
        while len(unified) < len(cs):
            unified.append(alg.zero())
        for i, c in enumerate(cs):
            unified[i] = alg.add(unified[i], c)
    return unified
