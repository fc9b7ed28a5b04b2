"""Built circuit: all prover data (reference: src/plonk.rs:31-70 `Circuit`)
and the build pipeline (reference: src/circuit_builder.rs:1078-1186).

Device data layout: polynomial families are tensors [LIMBS, k, n] with the
coefficient/domain axis last.  A Circuit carries the device its tensors
live on.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..circuit.gates import GateCtx
from ..circuit.partition import sigma_values_host
from ..circuit.target import NUM_WIRES
from ..circuit.witness import PartialWitness, Witness
from ..curves import host as chost
from ..curves import msm as cmsm
from ..curves import ops as cops
from ..curves.spec import CurveSpec
from ..device import resolve
from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMBS, require_eight_limbs
from ..hashing.hash_to_curve import blake_hash_usize_to_curve
from ..poly.fft import FftPrecomputation, ifft, lde
from ..utils import log2_strict

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".cache")


def commit_window_bits(n: int) -> int:
    """Pippenger window for an n-point MSM: ~log2(n) - 3, clamped."""
    return max(2, min(8, n.bit_length() - 3))


def pedersen_bases(curve: CurveSpec, degree: int):
    """pedersen_g[i] = blake_hash_usize_to_curve(i), plus H = hash(degree),
    U = hash(degree+1) (reference: src/circuit_builder.rs:1127-1129).
    Disk-cached under <repo>/.cache/: the try-and-increment hashing is host
    work.
    """
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR,
                        f"torch_pedersen_{curve.name}_{degree + 2}.pkl")
    pts: List = []
    if os.path.exists(path):
        with open(path, "rb") as f:
            xs, ys = pickle.load(f)
        pts = [chost.AffinePoint(curve, x, y) for x, y in zip(xs, ys)]
    if len(pts) < degree + 2:
        for i in range(len(pts), degree + 2):
            pts.append(blake_hash_usize_to_curve(curve, i))
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(([p.x for p in pts], [p.y for p in pts]), f)
        os.replace(tmp, path)
    return pts[:degree], pts[degree], pts[degree + 1]


def points_to_device(curve: CurveSpec, pts, device) -> cops.Point:
    f = curve.base
    xs = fops.from_ints(f, [0 if p.zero else p.x for p in pts], device)
    ys = fops.from_ints(f, [0 if p.zero else p.y for p in pts], device)
    zero = torch.tensor([p.zero for p in pts], device=xs.device)
    return cops.from_affine(curve, xs, ys, zero)


def device_points_to_host(curve: CurveSpec, pts: cops.Point):
    """[L, k] projective points (L = curve.base.limbs) -> k affine host
    points (Z = 0 maps to the zero point).  One readback; the inversions
    run on the host, where the values are needed anyway."""
    xs, ys, zs = (fops.to_ints(curve.base, t.reshape(curve.base.limbs, -1))
                  for t in pts)
    return chost.batch_to_affine_host(curve, [int(v) for v in xs],
                                      [int(v) for v in ys], [int(v) for v in zs])


def device_point_to_host(curve: CurveSpec, pt: cops.Point) -> chost.AffinePoint:
    return device_points_to_host(curve, pt)[0]


@dataclass
class PolynomialCommitment:
    """(reference: src/poly_commit.rs:29-66)"""
    commitment: chost.AffinePoint     # affine host point
    randomness: int                   # blinding factor (0 if unblinded)


def ints_to_device_matrix(spec, rows, device) -> torch.Tensor:
    """[[int]] (k rows x n cols) -> [L, k, n] tensor (reduced mod p)."""
    k, n = len(rows), len(rows[0])
    flat = fops._limb_matrix(spec, [v for row in rows for v in row])
    return torch.from_numpy(flat.reshape(spec.limbs, k, n).copy()).to(device)


class CommitmentEngine:
    """Pedersen commitments over a fixed basis on the circuit's device."""

    def __init__(self, curve: CurveSpec, g_points, h_point, device):
        self.curve = curve
        self.g_dev = cmsm.precompute_base(
            curve, points_to_device(curve, g_points, device))
        self.h = h_point
        self.n = len(g_points)

    def commit_many(self, coeffs: torch.Tensor, blinding: bool,
                    rand_source=None) -> List[PolynomialCommitment]:
        """coeffs: [LIMBS, k, n].  One multi-MSM over the shared basis for
        all k polynomials and one readback; blinding draws one value per
        polynomial, in order."""
        pts = cmsm.msm(self.curve, self.g_dev, coeffs,
                       commit_window_bits(self.n))           # [.., k]
        out = []
        for hp in device_points_to_host(self.curve, pts):
            r = 0
            if blinding:
                r = rand_source(self.curve.scalar.p)
                hp = chost.add(hp, chost.mul(self.h, r))
            out.append(PolynomialCommitment(hp, r))
        return out


@dataclass(eq=False)  # identity hash: circuits key per-circuit caches
class Circuit:
    """All data needed to generate/verify proofs (reference: plonk.rs:31-70)."""
    curve: CurveSpec
    security_bits: int
    num_public_inputs: int
    num_gates_without_pis: int
    gate_constants: List[List[int]]
    routing_target_partitions: object
    generators: List[object]
    subgroup_generator_n: int
    subgroup_generator_8n: int
    subgroup_n: List[int]
    pedersen_g: List[chost.AffinePoint]
    pedersen_h: chost.AffinePoint
    u: chost.AffinePoint
    # device tensors
    constant_polynomials: torch.Tensor     # [LIMBS, 6, n] coeffs
    constants_8n: torch.Tensor             # [LIMBS, 6, 8n] values
    c_constants: List[PolynomialCommitment]
    s_sigma_polynomials: torch.Tensor      # [LIMBS, 6, n] coeffs
    s_sigma_values_8n: torch.Tensor        # [LIMBS, 6, 8n] values
    sigma_values_n: List[List[int]]        # host [6][n] (for Z)
    c_s_sigmas: List[PolynomialCommitment]
    fft_n: FftPrecomputation
    fft_8n: FftPrecomputation
    commit_engine: CommitmentEngine
    device: torch.device = None
    inner_curve: CurveSpec = None

    @property
    def spec(self):
        return self.curve.scalar

    def degree(self) -> int:
        return len(self.gate_constants)

    def degree_pow(self) -> int:
        return log2_strict(self.degree())

    @property
    def ctx(self) -> GateCtx:
        return GateCtx(self.spec, self.inner_curve)

    # -- witness generation (reference: plonk.rs:487-616) -----------------
    def generate_partial_witness(self, inputs: PartialWitness) -> PartialWitness:
        gen_by_dep = {}
        for i, g in enumerate(self.generators):
            for dep in g.dependencies():
                gen_by_dep.setdefault(dep, []).append(i)

        witness = inputs
        witness.replace_public_inputs(self.num_gates_without_pis)
        copy_result = self._generate_copies(witness, witness.all_populated_targets())
        copy_result.copy_buffer_to_pi_gate(self.num_gates_without_pis)
        witness.extend(copy_result)

        pending = set()
        for i, g in enumerate(self.generators):
            if witness.contains_all_targets(g.dependencies()):
                pending.add(i)
        completed = set()

        while pending:
            populated = []
            for gi in pending:
                g = self.generators[gi]
                if _takes_ctx(g):
                    result = g.generate(self.ctx, self.gate_constants, witness)
                else:
                    result = g.generate(self.gate_constants, witness)
                populated.extend(result.all_populated_targets())
                witness.extend(result)
                completed.add(gi)
            copy_result = self._generate_copies(witness, populated)
            copy_result.copy_buffer_to_pi_gate(self.num_gates_without_pis)
            populated.extend(copy_result.all_populated_targets())
            witness.extend(copy_result)

            pending = set()
            for t in populated:
                for gi in gen_by_dep.get(t, []):
                    if gi not in completed and gi not in pending and \
                            witness.contains_all_targets(
                                self.generators[gi].dependencies()):
                        pending.add(gi)
        return witness

    def generate_witness(self, inputs: PartialWitness) -> Witness:
        pw = self.generate_partial_witness(inputs)
        return Witness.from_partial(pw, self.degree())

    def _generate_copies(self, witness: PartialWitness, targets) -> PartialWitness:
        result = PartialWitness()
        for t in targets:
            value = witness.get_target(t)
            for sibling in self.routing_target_partitions.get_partition(t):
                if witness.contains_target(sibling):
                    assert witness.get_target(sibling) == value, \
                        f"copy constraint violated at {sibling}"
                else:
                    result.set_target(sibling, value)
        return result

    def get_public_inputs(self, witness: Witness) -> List[int]:
        return [witness.get_indices(
            self.num_gates_without_pis + 2 * (i // NUM_WIRES), i % NUM_WIRES)
            for i in range(self.num_public_inputs)]

    def to_vk(self):
        from .verifier import VerificationKey
        return VerificationKey(
            c_constants=[c.commitment for c in self.c_constants],
            c_s_sigmas=[c.commitment for c in self.c_s_sigmas],
            degree=self.degree(),
            num_public_inputs=self.num_public_inputs,
            num_gates_without_pis=self.num_gates_without_pis,
            security_bits=self.security_bits,
            curve=self.curve,
        )


def _takes_ctx(g) -> bool:
    from ..circuit.gates import Gate
    return isinstance(g, Gate)


def cycle_partner(curve: CurveSpec) -> CurveSpec:
    """The other curve of the 2-cycle (the default InnerC for proofs)."""
    from ..curves.instances import TWEEDLEDEE, TWEEDLEDUM
    return {"Tweedledee": TWEEDLEDUM, "Tweedledum": TWEEDLEDEE}[curve.name]


def build_circuit(builder, inner_curve: Optional[CurveSpec] = None,
                  light: bool = False, device=None) -> Circuit:
    """Finalize (reference: circuit_builder.rs:1078-1186).

    light=True skips the Pedersen bases and polynomial commitments (enough
    for witness generation and constraint checking, not for proving)."""
    from ..circuit.gates import BufferGate
    from ..utils import is_power_of_two

    require_eight_limbs(builder.curve.scalar, "build_circuit")
    dev = resolve(device)
    if inner_curve is None:
        inner_curve = cycle_partner(builder.curve)

    for _ in range(3):
        builder._add_blinding_gate()

    num_gates_without_pis = builder.num_gates()
    builder._append_public_input_gates()
    builder._route_public_inputs(num_gates_without_pis)

    while not is_power_of_two(builder.num_gates()):
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))

    degree = builder.num_gates()
    degree_pow = log2_strict(degree)
    partitions = builder.get_routing_partitions()
    sigma = partitions.to_wire_partitions().to_sigma()

    spec = builder.spec
    fft_n = None if light else FftPrecomputation(spec, degree)
    fft_8n = None if light else FftPrecomputation(spec, degree * 8)
    subgroup_generator_n = fhost.primitive_root_of_unity(spec, degree_pow)
    subgroup_generator_8n = fhost.primitive_root_of_unity(spec, degree_pow + 3)
    subgroup_n = fhost.cyclic_subgroup_known_order(spec, subgroup_generator_n, degree)

    sigma_chunks = sigma_values_host(spec, sigma, degree, subgroup_generator_n)

    if light:
        g_pts, h_pt, u_pt, engine = [], None, None, None
        constant_polynomials = constants_8n = None
        s_sigma_polynomials = s_sigma_values_8n = None
        c_constants = c_s_sigmas = []
    else:
        g_pts, h_pt, u_pt = pedersen_bases(builder.curve, degree)
        engine = CommitmentEngine(builder.curve, g_pts, h_pt, dev)

        # constant polynomials (transpose gate-major -> wire-major)
        wire_constants = [list(col) for col in zip(*builder.gate_constants)]
        const_values = ints_to_device_matrix(spec, wire_constants, dev)
        constant_polynomials = ifft(fft_n, const_values)
        constants_8n = lde(fft_8n, constant_polynomials)
        c_constants = engine.commit_many(constant_polynomials, blinding=False)

        sigma_vals_dev = ints_to_device_matrix(spec, sigma_chunks, dev)
        s_sigma_polynomials = ifft(fft_n, sigma_vals_dev)
        s_sigma_values_8n = lde(fft_8n, s_sigma_polynomials)
        c_s_sigmas = engine.commit_many(s_sigma_polynomials, blinding=False)

    return Circuit(
        curve=builder.curve,
        security_bits=builder.security_bits,
        num_public_inputs=builder.public_input_index,
        num_gates_without_pis=num_gates_without_pis,
        gate_constants=builder.gate_constants,
        routing_target_partitions=partitions,
        generators=builder.generators,
        subgroup_generator_n=subgroup_generator_n,
        subgroup_generator_8n=subgroup_generator_8n,
        subgroup_n=subgroup_n,
        pedersen_g=g_pts,
        pedersen_h=h_pt,
        u=u_pt,
        constant_polynomials=constant_polynomials,
        constants_8n=constants_8n,
        c_constants=c_constants,
        s_sigma_polynomials=s_sigma_polynomials,
        s_sigma_values_8n=s_sigma_values_8n,
        sigma_values_n=sigma_chunks,
        c_s_sigmas=c_s_sigmas,
        fft_n=fft_n,
        fft_8n=fft_8n,
        commit_engine=engine,
        device=dev,
        inner_curve=inner_curve,
    )
