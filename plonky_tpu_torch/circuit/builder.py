"""CircuitBuilder: gate list + copy constraints + witness generators
(reference: src/circuit_builder.rs).

Pure host-side construction (the reference's is too); `build()` finalizes
the circuit, computing the permutation sigma, the Pedersen bases and the
constant/sigma polynomial commitments -- the bulk polynomial/commitment math
runs on device (FFT + MSM kernels), while hashing-to-curve and routing are
host work.
"""

from __future__ import annotations

import secrets
from typing import Dict, List, Optional, Tuple

from ..fields import host as fhost
from ..hashing.rescue import (
    RESCUE_SPONGE_WIDTH,
    rescue_constants,
)
from .gates import (
    ArithmeticGate,
    Base4SumGate,
    BufferGate,
    ConstantGate,
    GateCtx,
    PublicInputGate,
    RescueStepAGate,
    RescueStepBGate,
)
from .target import (
    NUM_CONSTANTS,
    NUM_WIRES,
    BoundedTarget,
    PublicInput,
    VirtualTarget,
    Wire,
)
from .witness import LambdaGenerator, PartialWitness
from .partition import TargetPartitions

# Hook for deterministic tests: callable (p) -> int in [0, p).
RANDOM_SOURCE = lambda p: secrets.randbelow(p)


class CircuitBuilder:
    def __init__(self, curve, security_bits: int = 128):
        """curve: the CurveSpec over which proofs will be made; circuit
        values live in curve.scalar (reference: CircuitBuilder<C> with
        values in C::ScalarField)."""
        self.curve = curve
        self.spec = curve.scalar
        self.security_bits = security_bits
        self.public_input_index = 0
        self.virtual_target_index = 0
        self.gate_counts: Dict[str, int] = {}
        self.gate_constants: List[List[int]] = []
        self.copy_constraints: List[Tuple[object, object]] = []
        self.generators: List[object] = []
        self.constant_wires: Dict[int, object] = {}

    # ------------------------------------------------------------------
    # targets
    # ------------------------------------------------------------------
    def add_public_input(self):
        pi = PublicInput(self.public_input_index)
        self.public_input_index += 1
        return pi

    def add_public_inputs(self, n: int):
        return [self.add_public_input() for _ in range(n)]

    def add_virtual_target(self):
        v = VirtualTarget(self.virtual_target_index)
        self.virtual_target_index += 1
        return v

    def add_virtual_targets(self, n: int):
        return [self.add_virtual_target() for _ in range(n)]

    # ------------------------------------------------------------------
    # constants
    # ------------------------------------------------------------------
    def zero_wire(self):
        return self.constant_wire(0)

    def one_wire(self):
        return self.constant_wire(1)

    def two_wire(self):
        return self.constant_wire(2)

    def neg_one_wire(self):
        return self.constant_wire(self.spec.p - 1)

    def constant_wire(self, c: int):
        c %= self.spec.p
        if c in self.constant_wires:
            return self.constant_wires[c]
        gate = self.num_gates()
        self.add_gate(ConstantGate(gate), [c])
        t = Wire(gate, ConstantGate.WIRE_OUTPUT)
        self.constant_wires[c] = t
        return t

    def constant_wires(self, cs):
        return [self.constant_wire(c) for c in cs]

    def generate_constant(self, target, c: int):
        self.add_generator(LambdaGenerator([], lambda _cs, _w, t=target, v=c: (
            _pw(t, v))))

    # ------------------------------------------------------------------
    # assertions & logic
    # ------------------------------------------------------------------
    def assert_zero(self, x):
        self.copy(x, self.zero_wire())

    def assert_one(self, x):
        self.copy(x, self.one_wire())

    def assert_binary(self, x):
        self.assert_zero(self.mul_sub(x, x, x))

    def assert_nonzero(self, x):
        self.inv(x)

    def assert_all_base_4(self, limbs):
        """reference: circuit_builder.rs:170-199.

        Every limb wire of the gate must be POPULATED (generated 0 for the
        unused ones): the gate's witness generator computes acc_new =
        fold(acc_old, limbs) and only fires once all its limb dependencies
        exist.  Leaving unused limbs unset left acc_new zero-filled while
        the fold evaluated to a nonzero value, so the gate's own
        accumulator constraint was violated on otherwise-valid witnesses
        (caught by a failing base4sum prove->verify test)."""
        for i in range(0, len(limbs), Base4SumGate.NUM_ROUTED_LIMBS):
            chunk = limbs[i:i + Base4SumGate.NUM_ROUTED_LIMBS]
            gate = self.num_gates()
            self.add_gate_no_constants(Base4SumGate(gate))
            self.generate_constant(Wire(gate, Base4SumGate.WIRE_ACC_OLD), 0)
            for j, limb in enumerate(chunk):
                self.copy(limb, Wire(gate, Base4SumGate.wire_limb(j)))
            for j in range(len(chunk), Base4SumGate.NUM_LIMBS):
                self.generate_constant(Wire(gate, Base4SumGate.wire_limb(j)), 0)

    def is_zero(self, x):
        """reference: circuit_builder.rs:204-255."""
        is_zero_t = self.add_virtual_target()
        m = self.add_virtual_target()
        p = self.spec.p

        def gen(_cs, w):
            xv = w.get_target(x)
            if xv % p == 0:
                mv, iz = 1, 1
            else:
                mv, iz = (-pow(xv, -1, p)) % p, 0
            r = PartialWitness()
            r.set_target(m, mv)
            r.set_target(is_zero_t, iz)
            return r

        self.add_generator(LambdaGenerator([x], gen))
        one = self.one_wire()
        x_m_plus_1 = self.mul_add(x, m, one)
        self.copy(is_zero_t, x_m_plus_1)
        self.assert_zero(self.mul(is_zero_t, x))
        return is_zero_t

    def is_nonzero(self, x):
        return self.sub(self.one_wire(), self.is_zero(x))

    def is_equal(self, x, y):
        return self.is_zero(self.sub(x, y))

    def select(self, b, x, y):
        """if b { x } else { y } = b*x - (b*y - y) (reference: :286-302)."""
        b_y_minus_y = self.mul_sub(b, y, y)
        return self.mul_sub(b, x, b_y_minus_y)

    def not_(self, b):
        return self.sub(self.one_wire(), b)

    # ------------------------------------------------------------------
    # arithmetic (each op = one ArithmeticGate; reference: :310-743)
    # ------------------------------------------------------------------
    def _arith(self, c0: int, c1: int, x, y, z):
        index = self.num_gates()
        self.add_gate(ArithmeticGate(index), [c0 % self.spec.p, c1 % self.spec.p])
        self.copy(x, Wire(index, ArithmeticGate.WIRE_MULTIPLICAND_0))
        self.copy(y, Wire(index, ArithmeticGate.WIRE_MULTIPLICAND_1))
        self.copy(z, Wire(index, ArithmeticGate.WIRE_ADDEND))
        return Wire(index, ArithmeticGate.WIRE_OUTPUT)

    def add(self, x, y):
        zero = self.zero_wire()
        if x == zero:
            return y
        if y == zero:
            return x
        return self._arith(1, 1, x, self.one_wire(), y)

    def add_many(self, terms):
        s = self.zero_wire()
        for t in terms:
            s = self.add(s, t)
        return s

    def double(self, x):
        return self.add(x, x)

    def sub(self, x, y):
        if y == self.zero_wire():
            return x
        return self._arith(1, self.spec.p - 1, x, self.one_wire(), y)

    def mul(self, x, y):
        one = self.one_wire()
        if x == one:
            return y
        if y == one:
            return x
        return self._arith(1, 0, x, y, self.zero_wire())

    def mul_many(self, terms):
        prod = self.one_wire()
        for t in terms:
            prod = self.mul(prod, t)
        return prod

    def square(self, x):
        return self.mul(x, x)

    def mul_add(self, x, y, z):
        return self._arith(1, 1, x, y, z)

    def mul_sub(self, x, y, z):
        return self._arith(1, self.spec.p - 1, x, y, z)

    def neg(self, x):
        return self.mul(x, self.neg_one_wire())

    def exp_constant(self, x, power: int):
        """reference: circuit_builder.rs:568-596."""
        power_bits = power.bit_length()
        current = x
        product = self.one_wire()
        # NB: squares `current` after every bit including the last, exactly
        # like the reference, to keep gate counts/indices identical.
        for i in range(power_bits):
            if (power >> i) & 1:
                product = self.mul(product, current)
            current = self.square(current)
        return product

    def exp_constant_usize(self, x, power: int):
        return self.exp_constant(x, power)

    def inv(self, x):
        x_inv = self.add_virtual_target()
        p = self.spec.p

        def gen(_cs, w):
            r = PartialWitness()
            r.set_target(x_inv, pow(w.get_target(x), -1, p))
            return r

        self.add_generator(LambdaGenerator([x], gen))
        self.copy(self.mul(x, x_inv), self.one_wire())
        return x_inv

    def div(self, x, y):
        return self.mul(x, self.inv(y))

    # ------------------------------------------------------------------
    # binary / base-4 splits (reference: :747-873)
    # ------------------------------------------------------------------
    def split_binary(self, x, num_bits: int):
        bits, _ = self.split_binary_and_base_4(x, num_bits, 0)
        return bits

    def split_base_4(self, x, num_dibits: int):
        _, dibits = self.split_binary_and_base_4(x, 0, num_dibits)
        return dibits

    def split_binary_and_base_4(self, x, num_bits: int, num_dibits: int):
        bits = self.add_virtual_targets(num_bits)
        dibits = self.add_virtual_targets(num_dibits)

        def gen(_cs, w):
            xv = w.get_target(x)
            r = PartialWitness()
            for i in range(num_bits):
                r.set_target(bits[i], (xv >> i) & 1)
            for i in range(num_dibits):
                r.set_target(dibits[i], (xv >> (num_bits + 2 * i)) & 3)
            return r

        self.add_generator(LambdaGenerator([x], gen))
        return bits, dibits

    def assert_binary_composition(self, x, num_bits: int):
        """Split x into num_bits bits, CONSTRAIN each to be boolean and the
        MSB-first composition to equal x, and return the bits.  (Unlike
        split_binary, which only adds a generator, this is sound: the bits
        are usable as trusted decompositions, e.g. for in-circuit n()
        recomputation.)  Assumes x < 2^num_bits (for 254-bit fields this
        fails with probability ~2^-128 on random elements; the reference
        makes the same top-bit assumption, circuit_curve.rs:419).

        Composition is a mul_add Horner chain over the bits: Base4SumGate
        folding would be fewer gates, but its limb wires 4..6 are not
        routable, so values computed by OTHER gates cannot be soundly tied
        to them by copy constraints (only witness-generated split targets
        can occupy them, as in assert_dibit_length)."""
        bits = self.split_binary(x, num_bits)
        for bit in bits:
            self.assert_binary(bit)
        two = self.constant_wire(2)
        s = self.zero_wire()
        for bit in reversed(bits):
            s = self.mul_add(s, two, bit)
        self.copy(s, x)
        return bits

    def assert_dibit_length(self, x, num_dibits: int):
        """Range check: x fits in num_dibits dibits (reference: :823-873).

        The split produces little-endian dibits (value = sum_j d_j 4^j), so
        the MSB-first Base4 fold must consume them in REVERSED order.  (The
        reference folds them forward, so its composed accumulator never
        equals x for general values -- one of the latent bugs behind its
        disabled recursion test.)"""
        dibits = self.split_base_4(x, num_dibits)
        msb_first = dibits[::-1]
        s = self.zero_wire()
        leftover = num_dibits % Base4SumGate.NUM_LIMBS
        if leftover:
            rem = msb_first[:leftover]
            self.assert_all_base_4(rem)
            four = self.constant_wire(4)
            for dibit in rem:
                s = self.mul_add(s, four, dibit)
        for i in range(leftover, num_dibits, Base4SumGate.NUM_LIMBS):
            chunk = msb_first[i:i + Base4SumGate.NUM_LIMBS]
            gate = self.num_gates()
            self.add_gate_no_constants(Base4SumGate(gate))
            self.copy(s, Wire(gate, Base4SumGate.WIRE_ACC_OLD))
            for j, dibit in enumerate(chunk):
                self.copy(dibit, Wire(gate, Base4SumGate.wire_limb(j)))
            s = Wire(gate, Base4SumGate.WIRE_ACC_NEW)
        self.copy(s, x)

    def deterministic_square_root(self, x):
        """Witnessed sqrt with parity-0 determinism (reference: :474-566)."""
        x_sqrt = self.add_virtual_target()
        p = self.spec.p

        def gen(_cs, w):
            xv = w.get_target(x)
            s = fhost.square_root(self.spec, xv)
            assert s is not None, "not a square"
            if s & 1:
                s = (-s) % p
            r = PartialWitness()
            r.set_target(x_sqrt, s)
            return r

        self.add_generator(LambdaGenerator([x], gen))

        f_bits = self.spec.bits - 1
        assert f_bits == 254, "handles 2^254 + eps fields only (as reference)"
        bits, dibits = self.split_binary_and_base_4(x_sqrt, 2, 126)
        self.copy(self.square(x_sqrt), x)
        self.assert_zero(bits[0])
        self.assert_binary(bits[1])
        # x_sqrt = (sum_j dibit_j 4^j) * 4 + 2 bit_1 + bit_0, with bit_0 = 0.
        # MSB-first Base4 fold over REVERSED dibits (126 = 18 * 7 exact
        # chunks), then shift the two low bits in.
        s = self.zero_wire()
        msb_first = dibits[::-1]
        for i in range(0, len(msb_first), Base4SumGate.NUM_LIMBS):
            chunk = msb_first[i:i + Base4SumGate.NUM_LIMBS]
            assert len(chunk) == Base4SumGate.NUM_LIMBS
            gate = self.num_gates()
            self.add_gate_no_constants(Base4SumGate(gate))
            self.copy(s, Wire(gate, Base4SumGate.WIRE_ACC_OLD))
            for j, dibit in enumerate(chunk):
                self.copy(dibit, Wire(gate, Base4SumGate.wire_limb(j)))
            s = Wire(gate, Base4SumGate.WIRE_ACC_NEW)
        s = self.mul_add(s, self.constant_wire(4), self.double(bits[1]))
        self.copy(s, x_sqrt)
        return x_sqrt

    # ------------------------------------------------------------------
    # in-circuit Rescue (reference: :875-970)
    # ------------------------------------------------------------------
    def rescue_hash_n_to_1(self, inputs):
        return self.rescue_sponge(inputs, 1)[0]

    def rescue_hash_n_to_2(self, inputs):
        out = self.rescue_sponge(inputs, 2)
        return out[0], out[1]

    def rescue_hash_n_to_3(self, inputs):
        out = self.rescue_sponge(inputs, 3)
        return out[0], out[1], out[2]

    def rescue_sponge(self, inputs, num_outputs: int):
        state = [self.zero_wire()] * RESCUE_SPONGE_WIDTH
        rate = RESCUE_SPONGE_WIDTH - 1
        for i in range(0, len(inputs), rate):
            chunk = inputs[i:i + rate]
            for j, inp in enumerate(chunk):
                state[j] = self.add(state[j], inp)
            state = self.rescue_permutation(state)
        outputs = []
        while True:
            for j in range(rate):
                outputs.append(state[j])
                if len(outputs) == num_outputs:
                    return outputs
            state = self.rescue_permutation(state)

    def rescue_permutation(self, inputs):
        assert len(inputs) == RESCUE_SPONGE_WIDTH
        for i in range(RESCUE_SPONGE_WIDTH):
            self.copy(inputs[i],
                      Wire(self.num_gates(), RescueStepAGate.wire_acc(i)))
        all_constants = rescue_constants(self.spec, RESCUE_SPONGE_WIDTH,
                                         self.security_bits)
        for a_constants, b_constants in all_constants:
            self.add_gate(RescueStepAGate(self.num_gates()), list(a_constants))
            self.add_gate(RescueStepBGate(self.num_gates()), list(b_constants))
        gate = self.num_gates()
        self.add_gate_no_constants(BufferGate(gate))
        return [Wire(gate, RescueStepBGate.wire_acc(i))
                for i in range(RESCUE_SPONGE_WIDTH)]

    # ------------------------------------------------------------------
    # gates / copies
    # ------------------------------------------------------------------
    def add_gate_no_constants(self, gate):
        self.add_gate(gate, [])

    def add_gate(self, gate, gate_constants):
        assert len(gate.PREFIX) + len(gate_constants) <= NUM_CONSTANTS
        all_constants = [1 if b else 0 for b in gate.PREFIX]
        all_constants.extend(c % self.spec.p for c in gate_constants)
        while len(all_constants) < NUM_CONSTANTS:
            all_constants.append(0)
        self.gate_constants.append(all_constants)
        self.add_generator(gate)
        self.gate_counts[gate.NAME] = self.gate_counts.get(gate.NAME, 0) + 1

    def add_generator(self, generator):
        self.generators.append(generator)

    def num_gates(self) -> int:
        return len(self.gate_constants)

    def copy(self, target_1, target_2):
        self.copy_constraints.append((target_1, target_2))

    def conditional_copy(self, condition, target_1, target_2):
        self.copy(self.mul(condition, target_1), self.mul(condition, target_2))

    # ------------------------------------------------------------------
    # build (reference: :1078-1186)
    # ------------------------------------------------------------------
    def _add_blinding_gate(self):
        gate = self.num_gates()
        self.add_gate_no_constants(BufferGate(gate))
        p = self.spec.p
        for input_ in range(NUM_WIRES):
            t = Wire(gate, input_)
            self.add_generator(LambdaGenerator(
                [], lambda _cs, _w, t=t: _pw(t, RANDOM_SOURCE(p))))

    def _append_public_input_gates(self):
        num_gates = self.num_gates()
        num_pi_gates = -(-self.public_input_index // NUM_WIRES)
        for i in range(num_pi_gates):
            self.add_gate_no_constants(PublicInputGate(num_gates + i * 2))
            self.add_gate_no_constants(BufferGate(num_gates + i * 2 + 1))

    def _route_public_inputs(self, offset: int):
        new_ccs = []
        for (a, b) in self.copy_constraints:
            if isinstance(a, PublicInput):
                a = a.routable_target(offset)
            if isinstance(b, PublicInput):
                b = b.routable_target(offset)
            new_ccs.append((a, b))
        self.copy_constraints = new_ccs

    def get_routing_partitions(self) -> TargetPartitions:
        partitions = TargetPartitions()
        partitions.add_partitions(
            [VirtualTarget(i) for i in range(self.virtual_target_index)])
        partitions.add_partitions(
            [Wire(gate, input_) for gate in range(self.num_gates())
             for input_ in range(NUM_WIRES)])
        for a, b in self.copy_constraints:
            partitions.merge(a, b)
        return partitions

    def build(self, inner_curve=None, light: bool = False, device=None):
        """Finalize the circuit; its device tensors live on `device` (the
        card unless the caller passes "cpu")."""
        from ..protocol.circuit import build_circuit
        return build_circuit(self, inner_curve, light, device)


def _pw(target, value) -> PartialWitness:
    r = PartialWitness()
    r.set_target(target, value)
    return r
