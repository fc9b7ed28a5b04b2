"""The port's gates (plonky_tpu_torch/circuit/gates.py) against the
soundness-degree claim of tests/test_gate_degree.py (the reference's
`test_gate_low_degree!`, src/gates/mod.rs:336-443): random polynomials of
degree < 4 for every constant and wire slot, each gate's filtered
constraints evaluated pointwise on a 64-point domain, and every
coefficient above degree 8 * 3 of their interpolation zero.  The port's
values at every point are also held equal to the JAX package's gate of the
same name.  Host ints throughout."""

import numpy as np
import pytest

from plonky_tpu.circuit import gates as jgates
from plonky_tpu.circuit.algebra import HostAlgebra as JHostAlgebra
from plonky_tpu.curves import TWEEDLEDEE as J_TWEEDLEDEE
from plonky_tpu.curves import TWEEDLEDUM as J_TWEEDLEDUM
from plonky_tpu_torch.circuit.algebra import HostAlgebra
from plonky_tpu_torch.circuit.gates import ALL_GATES, GateCtx
from plonky_tpu_torch.circuit.target import NUM_CONSTANTS, NUM_WIRES
from plonky_tpu_torch.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu_torch.fields import host as fhost

N_SMALL = 4          # degree of the sampled polynomials is < N_SMALL
EXTENDED = 16 * N_SMALL
MAX_DEGREE = 8 * (N_SMALL - 1)
J_GATES = {g.NAME: g for g in jgates.ALL_GATES}


def _eval_poly(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _interpolate(values, n_inv, g_inv, p):
    """Inverse DFT over the order-len(values) subgroup (O(n^2) host)."""
    coeffs = []
    for j in range(len(values)):
        wj = pow(g_inv, j, p)
        acc, w = 0, 1
        for v in values:
            acc = (acc + v * w) % p
            w = w * wj % p
        coeffs.append(acc * n_inv % p)
    return coeffs


def test_port_has_the_jax_gates():
    assert [g.NAME for g in ALL_GATES] == list(J_GATES)


@pytest.mark.parametrize("gate", ALL_GATES, ids=lambda g: g.NAME)
def test_gate_constraints_low_degree(gate):
    spec = TWEEDLEDEE.scalar
    p = spec.p
    rng = np.random.default_rng(sum(map(ord, gate.NAME)))

    def rand_polys(k):
        return [[int.from_bytes(rng.bytes(40), "little") % p
                 for _ in range(N_SMALL)] for _ in range(k)]

    slots = (rand_polys(NUM_CONSTANTS), rand_polys(NUM_WIRES),
             rand_polys(NUM_WIRES), rand_polys(NUM_WIRES))
    g = fhost.primitive_root_of_unity(spec, EXTENDED.bit_length() - 1)
    xs = fhost.cyclic_subgroup_known_order(spec, g, EXTENDED)
    ctx, jctx = GateCtx(spec, TWEEDLEDUM), jgates.GateCtx(J_TWEEDLEDEE.scalar,
                                                          J_TWEEDLEDUM)
    alg, jalg = HostAlgebra(spec), JHostAlgebra(J_TWEEDLEDEE.scalar)
    per_point = []
    for x in xs:
        args = [[_eval_poly(c, x, p) for c in polys] for polys in slots]
        got = gate.evaluate_filtered(alg, ctx, *args)
        assert got == J_GATES[gate.NAME].evaluate_filtered(jalg, jctx, *args)
        per_point.append(got)

    assert per_point[0] or gate.NAME == "BufferGate"
    n_inv, g_inv = pow(EXTENDED, -1, p), pow(g, -1, p)
    for k in range(len(per_point[0])):
        coeffs = _interpolate([pp[k] for pp in per_point], n_inv, g_inv, p)
        assert all(c == 0 for c in coeffs[MAX_DEGREE + 1:]), (
            f"{gate.NAME} constraint {k} has degree > 8")
