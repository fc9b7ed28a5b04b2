"""In-circuit curve gadgets (reference: src/circuit_curve.rs).

NOTE on `curve_msm_endo`: the CurveEndoGate's scalar accumulators live
GRID_WIDTH (=65) rows below the gate (reference: curve_endo.rs:55-58), so
each scalar's endo gates must be spaced exactly 65 rows apart -- i.e. 64
parts + 1 doubling gate per iteration.  The reference's gadget neither pads
parts to 64 nor reserves the below-rows after the last iteration (its
recursive test is #[ignore]d "Fails for the moment").  We pad the parts
list to exactly 64 with dummy zero-scalar ops and append a row of
BufferGates after the loop so the final below-targets land on
unconstrained wires, then subtract the dummies' [n(0)]*P contribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ...curves import host as chost
from ...hashing.hash_to_curve import blake_hash_base_field_to_curve
from ...protocol.plonk_util import halo_n, scalar_to_bits_le
from ..gates import (
    Base4SumGate,
    BufferGate,
    CurveAddGate,
    CurveDblGate,
    CurveEndoGate,
)
from ..target import GRID_WIDTH, Wire
from ..witness import LambdaGenerator, PartialWitness

ENDO_MSM_PARTS = 64  # (GRID_WIDTH - 1): parts per endo-MSM iteration


def _filler_point(inner_curve):
    """Exceptional-case filler accumulator seed.  MUST be domain-separated
    from the Pedersen family: pedersen_g[i] = hash(i), and a constant-1
    polynomial commits to exactly 1*G_0 = hash(0), so seeding the filler
    with hash(0) collides the very first MSM addition (the reference dodges
    this by drawing a random filler per build, circuit_curve.rs:299-304; we
    keep builds deterministic and hash from the top of the field instead,
    far outside any protocol index)."""
    return blake_hash_base_field_to_curve(inner_curve,
                                          inner_curve.base.p - 1)


def _dummy_point(inner_curve):
    """Zero-scalar padding point for endo-MSMs; domain-separated like
    _filler_point."""
    return blake_hash_base_field_to_curve(inner_curve,
                                          inner_curve.base.p - 2)


@dataclass(frozen=True)
class AffinePointTarget:
    x: object
    y: object
    curve: object = None

    def to_vec(self):
        return [self.x, self.y]


@dataclass
class CurveMulOp:
    scalar: object
    point: AffinePointTarget


@dataclass
class CurveMulEndoResult:
    mul_result: AffinePointTarget
    actual_scalar: object


@dataclass
class CurveMsmEndoResult:
    msm_result: AffinePointTarget
    actual_scalars: List[object]


def constant_affine_point(builder, point: chost.AffinePoint) -> AffinePointTarget:
    assert not point.zero
    return AffinePointTarget(builder.constant_wire(point.x),
                             builder.constant_wire(point.y), point.curve)


def add_virtual_point_target(builder, curve=None) -> AffinePointTarget:
    return AffinePointTarget(builder.add_virtual_target(),
                             builder.add_virtual_target(), curve)


def copy_curve(builder, a: AffinePointTarget, b: AffinePointTarget):
    builder.copy(a.x, b.x)
    builder.copy(a.y, b.y)


def curve_assert_valid(builder, inner_curve, p: AffinePointTarget):
    """y^2 = x^3 + b (A = 0) (reference: circuit_curve.rs:62-77)."""
    a = builder.constant_wire(0)
    b = builder.constant_wire(inner_curve.b)
    y_squared = builder.square(p.y)
    x_cubed = builder.exp_constant(p.x, 3)
    a_x_plus_b = builder.mul_add(a, p.x, b)
    rhs = builder.add(x_cubed, a_x_plus_b)
    builder.copy(y_squared, rhs)


def curve_neg(builder, p: AffinePointTarget) -> AffinePointTarget:
    return AffinePointTarget(p.x, builder.neg(p.y), p.curve)


def curve_add(builder, p1: AffinePointTarget, p2: AffinePointTarget) -> AffinePointTarget:
    """One CurveAddGate + BufferGate (reference: circuit_curve.rs:87-151)."""
    add_index = builder.num_gates()
    builder.add_gate_no_constants(CurveAddGate(add_index))
    buffer_index = builder.num_gates()
    builder.add_gate_no_constants(BufferGate(buffer_index))

    builder.copy(Wire(add_index, CurveAddGate.WIRE_GROUP_ACC_X), p1.x)
    builder.copy(Wire(add_index, CurveAddGate.WIRE_GROUP_ACC_Y), p1.y)
    builder.copy(Wire(add_index, CurveAddGate.WIRE_ADDEND_X), p2.x)
    builder.copy(Wire(add_index, CurveAddGate.WIRE_ADDEND_Y), p2.y)
    builder.generate_constant(Wire(add_index, CurveAddGate.WIRE_SCALAR_BIT), 1)
    builder.copy(Wire(add_index, CurveAddGate.WIRE_SCALAR_ACC_OLD),
                 builder.zero_wire())
    builder.copy(Wire(add_index, CurveAddGate.WIRE_SCALAR_ACC_NEW),
                 builder.one_wire())
    return AffinePointTarget(
        Wire(buffer_index, CurveAddGate.WIRE_GROUP_ACC_X),
        Wire(buffer_index, CurveAddGate.WIRE_GROUP_ACC_Y), p1.curve)


def curve_double(builder, p: AffinePointTarget) -> AffinePointTarget:
    idx = builder.num_gates()
    builder.add_gate_no_constants(CurveDblGate(idx))
    builder.copy(p.x, Wire(idx, CurveDblGate.WIRE_X_OLD))
    builder.copy(p.y, Wire(idx, CurveDblGate.WIRE_Y_OLD))
    return AffinePointTarget(Wire(idx, CurveDblGate.WIRE_X_NEW),
                             Wire(idx, CurveDblGate.WIRE_Y_NEW), p.curve)


def curve_sub(builder, p1: AffinePointTarget, p2: AffinePointTarget) -> AffinePointTarget:
    return curve_add(builder, p1, curve_neg(builder, p2))


def curve_mul(builder, inner_curve, mul: CurveMulOp) -> AffinePointTarget:
    return curve_msm(builder, inner_curve, [mul])


def curve_msm(builder, inner_curve, parts: List[CurveMulOp]) -> AffinePointTarget:
    """Bit-serial simultaneous double-and-add over CurveAdd/CurveDbl gates
    with a random filler point to dodge exceptional cases
    (reference: circuit_curve.rs:287-410)."""
    f_bits = builder.spec.bits - 1
    all_bits = [builder.split_binary(part.scalar, f_bits) for part in parts]

    filler = _filler_point(inner_curve)
    acc = constant_affine_point(builder, filler)
    scalar_accs = [builder.zero_wire()] * len(parts)

    for i in range(f_bits - 1, -1, -1):
        builder.copy(acc.x, Wire(builder.num_gates(),
                                 CurveAddGate.WIRE_GROUP_ACC_X))
        builder.copy(acc.y, Wire(builder.num_gates(),
                                 CurveAddGate.WIRE_GROUP_ACC_Y))
        for j, part in enumerate(parts):
            bit = all_bits[j][i]
            idx = builder.num_gates()
            builder.add_gate_no_constants(CurveAddGate(idx))
            builder.copy(scalar_accs[j], Wire(idx, CurveAddGate.WIRE_SCALAR_ACC_OLD))
            scalar_accs[j] = Wire(idx, CurveAddGate.WIRE_SCALAR_ACC_NEW)
            builder.copy(part.point.x, Wire(idx, CurveAddGate.WIRE_ADDEND_X))
            builder.copy(part.point.y, Wire(idx, CurveAddGate.WIRE_ADDEND_Y))
            builder.copy(bit, Wire(idx, CurveAddGate.WIRE_SCALAR_BIT))

        idx_dbl = builder.num_gates()
        builder.add_gate_no_constants(CurveDblGate(idx_dbl))
        if i == 0:
            acc = AffinePointTarget(Wire(idx_dbl, CurveDblGate.WIRE_X_OLD),
                                    Wire(idx_dbl, CurveDblGate.WIRE_Y_OLD))
        else:
            acc = AffinePointTarget(Wire(idx_dbl, CurveDblGate.WIRE_X_NEW),
                                    Wire(idx_dbl, CurveDblGate.WIRE_Y_NEW))
            filler = filler.double()

    filler_target = constant_affine_point(builder, filler)
    acc = curve_sub(builder, acc, filler_target)
    for j, part in enumerate(parts):
        builder.copy(scalar_accs[j], part.scalar)
    return acc


def curve_mul_endo(builder, inner_curve, mul: CurveMulOp) -> CurveMulEndoResult:
    result = curve_msm_endo(builder, inner_curve, [mul])
    return CurveMulEndoResult(result.msm_result, result.actual_scalars[0])


def curve_mul_inv_endo(builder, inner_curve, mul: CurveMulOp) -> CurveMulEndoResult:
    """Witness r = [1/n(s)] p, verify [n(s)] r = p (reference: :214-282)."""
    scalar, point = mul.scalar, mul.point
    result = add_virtual_point_target(builder, inner_curve)
    security_bits = builder.security_bits

    def gen(_cs, w):
        s = w.get_target(scalar)
        n_s = halo_n(_cycle_of(inner_curve), scalar_to_bits_le(s, security_bits))
        n_s_inv = pow(n_s, -1, inner_curve.scalar.p)
        pt = chost.AffinePoint(inner_curve, w.get_target(point.x),
                               w.get_target(point.y))
        r = chost.mul(pt, n_s_inv)
        out = PartialWitness()
        out.set_target(result.x, r.x)
        out.set_target(result.y, r.y)
        return out

    builder.add_generator(LambdaGenerator([scalar, point.x, point.y], gen))
    mul_result = curve_mul_endo(builder, inner_curve, CurveMulOp(scalar, result))
    copy_curve(builder, mul_result.mul_result, point)
    return CurveMulEndoResult(result, mul_result.actual_scalar)


def _cycle_of(inner_curve):
    """halo_n over InnerC produces a scalar in InnerC::ScalarField using
    InnerC::ZETA_SCALAR; our halo_n(curve,...) takes the curve whose
    zeta_scalar to use and outputs in curve.scalar -- that's inner_curve."""
    return inner_curve


def curve_msm_endo(builder, inner_curve, parts: List[CurveMulOp]) -> CurveMsmEndoResult:
    """Endomorphism MSM over CurveEndoGates (reference: :413-628), with the
    GRID_WIDTH alignment made coherent (see module docstring)."""
    zero = builder.zero_wire()
    spec = builder.spec
    f_bits = spec.bits - 1
    scalar_bits = builder.security_bits
    scalar_dibits = (f_bits - scalar_bits) // 2
    assert f_bits == 254 and scalar_bits == 128 and scalar_dibits == 63

    n_real = len(parts)
    assert n_real <= ENDO_MSM_PARTS, "split larger MSMs into 64-part chunks"
    # Pad with dummy zero-scalar ops on a fixed point; their [n(0)] P_dummy
    # contribution is a known constant subtracted at the end.
    dummy_pt_host = _dummy_point(inner_curve)
    parts = list(parts)
    n_dummy = ENDO_MSM_PARTS - n_real
    if n_dummy:
        dummy_target = constant_affine_point(builder, dummy_pt_host)
        for _ in range(n_dummy):
            parts.append(CurveMulOp(zero, dummy_target))

    splits = [builder.split_binary_and_base_4(p.scalar, scalar_bits,
                                              scalar_dibits) for p in parts]
    all_bits = [s[0] for s in splits]
    all_dibits = [s[1] for s in splits]

    filler = _filler_point(inner_curve)
    acc = constant_affine_point(builder, filler)
    scalar_acc_unsigned: List[object] = []
    scalar_acc_signed: List[object] = []

    first_endo_gate_of_last_iter = None
    for i in range(scalar_bits - 2, -1, -2):
        builder.copy(acc.x, Wire(builder.num_gates(),
                                 CurveEndoGate.WIRE_GROUP_ACC_X))
        builder.copy(acc.y, Wire(builder.num_gates(),
                                 CurveEndoGate.WIRE_GROUP_ACC_Y))
        if i == 0:
            first_endo_gate_of_last_iter = builder.num_gates()
        for j, part in enumerate(parts):
            gate = builder.num_gates()
            builder.add_gate_no_constants(CurveEndoGate(gate))
            builder.copy(part.point.x, Wire(gate, CurveEndoGate.WIRE_ADDEND_X))
            builder.copy(part.point.y, Wire(gate, CurveEndoGate.WIRE_ADDEND_Y))
            builder.copy(all_bits[j][i], Wire(gate, CurveEndoGate.WIRE_SCALAR_BIT_0))
            builder.copy(all_bits[j][i + 1], Wire(gate, CurveEndoGate.WIRE_SCALAR_BIT_1))
            if i == scalar_bits - 2:
                builder.copy(zero, Wire(gate, CurveEndoGate.WIRE_SCALAR_ACC_UNSIGNED))
                builder.copy(zero, Wire(gate, CurveEndoGate.WIRE_SCALAR_ACC_SIGNED))

        gate = builder.num_gates()
        builder.add_gate_no_constants(CurveDblGate(gate))
        if i == 0:
            acc = AffinePointTarget(Wire(gate, CurveDblGate.WIRE_X_OLD),
                                    Wire(gate, CurveDblGate.WIRE_Y_OLD))
        else:
            acc = AffinePointTarget(Wire(gate, CurveDblGate.WIRE_X_NEW),
                                    Wire(gate, CurveDblGate.WIRE_Y_NEW))
            filler = filler.double()

    # Reserve the below-rows of the last iteration's endo gates with
    # BufferGates, so the final scalar accumulators land on free wires.
    # Last-iteration endo gate for part j is at first_endo_gate_of_last_iter
    # + j; its below-row is that + GRID_WIDTH.  Rows in between are already
    # occupied by that iteration itself (64 endos + 1 dbl = 65 = GRID_WIDTH),
    # so the below-rows start exactly at the current gate count.
    assert builder.num_gates() == first_endo_gate_of_last_iter + GRID_WIDTH
    for j in range(len(parts)):
        gate = builder.num_gates()
        builder.add_gate_no_constants(BufferGate(gate))
        scalar_acc_unsigned.append(Wire(gate, CurveEndoGate.WIRE_SCALAR_ACC_UNSIGNED))
        scalar_acc_signed.append(Wire(gate, CurveEndoGate.WIRE_SCALAR_ACC_SIGNED))

    # Subtract the rescaled filler.
    filler_target = constant_affine_point(builder, filler)
    acc = curve_sub(builder, acc, filler_target)

    # Subtract the dummies' contribution: n(0) * P_dummy * n_dummy.
    if n_dummy:
        n_zero = halo_n(inner_curve, [False] * scalar_bits)
        dummy_total = chost.mul(dummy_pt_host, n_zero * n_dummy % inner_curve.scalar.p)
        if not dummy_total.zero:
            dummy_total_t = constant_affine_point(builder, dummy_total)
            acc = curve_sub(builder, acc, dummy_total_t)

    # Compose each scalar from its pieces: the endo gates accumulated the
    # LOW 128 bits into scalar_acc_unsigned (MSB-first bit pairs), and the
    # remaining 63 dibits carry bits 128..254 little-endian, so
    #   scalar = (sum_j dibit_j 4^j) * 2^128 + unsigned_acc.
    # Fold the dibits MSB-first (reversed; 63 = 9 * 7 exact chunks), then
    # combine with one mul_add.  (The reference seeds the fold with the
    # unsigned accumulator and walks the dibits forward, which composes a
    # different value -- its recursion test is disabled.)
    two_pow_128 = builder.constant_wire(1 << scalar_bits)
    for j, part in enumerate(parts):
        acc_d = builder.zero_wire()
        msb_first = all_dibits[j][::-1]
        for c in range(0, len(msb_first), Base4SumGate.NUM_LIMBS):
            chunk = msb_first[c:c + Base4SumGate.NUM_LIMBS]
            assert len(chunk) == Base4SumGate.NUM_LIMBS
            gate = builder.num_gates()
            builder.add_gate_no_constants(Base4SumGate(gate))
            builder.copy(acc_d, Wire(gate, Base4SumGate.WIRE_ACC_OLD))
            acc_d = Wire(gate, Base4SumGate.WIRE_ACC_NEW)
            for k, dibit in enumerate(chunk):
                builder.copy(dibit, Wire(gate, Base4SumGate.wire_limb(k)))
        composed = builder.mul_add(acc_d, two_pow_128, scalar_acc_unsigned[j])
        builder.copy(composed, part.scalar)

    return CurveMsmEndoResult(acc, scalar_acc_signed[:n_real])
