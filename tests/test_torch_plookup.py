"""The port's plookup against the JAX package's, on the CPU.

Mirrors tests/test_plookup.py and holds the port to the JAX package value
for value (exact canonical ints and points):
* sort_by, pad_inputs and grand_polynomial, host functions of both;
* the vanishing polynomial on the 4(n+1) domain and its quotient by
  X^(n+1) - 1 at n = 7, as each prover made them for the proof below;
* the whole proof of tests/test_plookup.py's subset case (n = 7) under the
  same pinned random source: every commitment, opening and the Halo proof;
* each package's verifier accepts the other's proof, and the port's rejects
  a changed opening;
* a value outside the table raises; the Table's reduction to vectors
  equals the JAX package's, and Table.prove_row / verify (slow).

The JAX package's prover divides by Z_H through a call that does not fit
its callee (ROADMAP C1); `jax_adapter` replaces that callee for the JAX
proof only, so that the reference runs.  The JAX package's proof, its
vanishing polynomial and quotient are read from
tests/fixtures/jax_proofs.json; a slow test makes them again and runs the
JAX verifier on both packages' proofs.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
import plonky_tpu.plookup as jplookup
import plonky_tpu.plookup.plookup as jplookup_mod
import plonky_tpu.protocol.halo as jhalo_mod
import plonky_tpu.protocol.prover as jprover_mod
import plonky_tpu_torch.protocol.halo as halo_mod
from plonky_tpu.curves import TWEEDLEDEE as J_DEE
from plonky_tpu.fields import ops as jfops
from plonky_tpu.poly.polynomial import divide_by_z_h as jax_divide_by_z_h
from plonky_tpu.protocol.halo import OpeningProof as JOpeningProof
from plonky_tpu.protocol.proof import SchnorrProof as JSchnorrProof
from chip_smoke import PLOOKUP_N7_SHA256
from plonky_tpu.protocol.serialization import point_from_bytes as jax_point_from_bytes
from plonky_tpu.utils import cached_jit
from plonky_tpu_torch import plookup
from plonky_tpu_torch.curves import TWEEDLEDEE
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.plookup import plookup as plookup_mod
from plonky_tpu_torch.poly.polynomial import divide_by_z_h
from plonky_tpu_torch.protocol.halo import OpeningProof
from plonky_tpu_torch.protocol.proof import SchnorrProof
from plonky_tpu_torch.protocol.serialization import (point_from_bytes,
                                                     point_to_bytes)

torch.set_num_threads(1)

T = [1, 2, 3, 5, 7, 11, 13]
F = [2, 2, 5, 11]


def pinned_source():
    """tests/test_plookup.py's pinned random source, fresh."""
    rng = np.random.default_rng(99)
    return lambda p: int.from_bytes(rng.bytes(40), "little") % p


def jax_adapter(sf, n, vanishing):
    """What plonky_tpu/plookup/plookup.py:147-148 means by
    `cached_jit(_div_zh, sf, n + 1)(vanishing)`: the quotient by X^(n+1) - 1.
    The JAX package's `_div_zh` takes (sf, n, c, zh_inv, *flat), so the
    reference raises TypeError there (ROADMAP C1); this stands in for it,
    in this test's JAX proofs only, so that the port can be held to the
    reference's values."""
    return jax_divide_by_z_h(sf, vanishing, n)


def _convert(proof, curve, to_bytes, from_bytes, opening_proof, schnorr,
             plookup_proof, openings, opening):
    """A plookup proof of one package as the other's, point by point
    through the compressed encoding."""
    pt = lambda q: from_bytes(curve, to_bytes(curve, q))
    hp = proof.halo_proof
    o = proof.openings
    return plookup_proof(
        c_f=pt(proof.c_f), c_t=pt(proof.c_t), c_h1=pt(proof.c_h1),
        c_h2=pt(proof.c_h2), c_z=pt(proof.c_z),
        c_quotient=pt(proof.c_quotient),
        openings=openings(*(opening(x.local, x.right) for x in
                            (o.f, o.t, o.h1, o.h2, o.z, o.quotient))),
        halo_proof=opening_proof(
            halo_l=[pt(q) for q in hp.halo_l],
            halo_r=[pt(q) for q in hp.halo_r], halo_g=pt(hp.halo_g),
            schnorr_proof=schnorr(pt(hp.schnorr_proof.r), hp.schnorr_proof.z1,
                                  hp.schnorr_proof.z2)),
        n=proof.n)


def from_jax(proof):
    from plonky_tpu.protocol.serialization import point_to_bytes as jax_p2b
    return _convert(proof, J_DEE, jax_p2b,
                    lambda _c, b: point_from_bytes(TWEEDLEDEE, b),
                    OpeningProof, SchnorrProof, plookup.PlookupProof,
                    plookup.PlookupOpenings, plookup.Opening)


def to_jax(proof):
    return _convert(proof, TWEEDLEDEE, point_to_bytes,
                    lambda _c, b: jax_point_from_bytes(J_DEE, b),
                    JOpeningProof, JSchnorrProof, jplookup.PlookupProof,
                    jplookup.PlookupOpenings, jplookup.Opening)


def _recording(record, key, fn):
    """fn, its result also kept as record[key]."""
    def wrapped(*args):
        record[key] = fn(*args)
        return record[key]
    return wrapped


def _jax_run() -> dict:
    """The JAX package's proof of the subset case under a fresh pinned
    source and jax_adapter, and the vanishing polynomial its prover made
    on the 4(n+1) domain."""
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhalo_mod, "RANDOM_SOURCE", pinned_source())
        mp.setattr(jprover_mod, "_div_zh", jax_adapter)
        mp.setattr(jplookup_mod, "_vanishing_polynomial", _recording(
            made, "vanishing", jplookup_mod._vanishing_polynomial))
        made["proof"] = jplookup.prove(J_DEE, F, T)
    return made


OPENINGS = ("f", "t", "h1", "h2", "z", "quotient")
POINTS = ("c_f", "c_t", "c_h1", "c_h2", "c_z", "c_quotient")


def _record(proof, vanishing, quotient) -> dict:
    """A port PlookupProof (points compressed, values in hex) and the ints
    of a vanishing polynomial and its quotient, as JSON."""
    pt = lambda q: point_to_bytes(TWEEDLEDEE, q).hex()
    hp, o = proof.halo_proof, proof.openings
    return {"points": [pt(getattr(proof, k)) for k in POINTS],
            "openings": [[hex(getattr(o, k).local), hex(getattr(o, k).right)]
                         for k in OPENINGS],
            "halo_l": [pt(q) for q in hp.halo_l], "halo_r": [pt(q) for q in hp.halo_r],
            "halo_g": pt(hp.halo_g),
            "schnorr": [pt(hp.schnorr_proof.r), hex(hp.schnorr_proof.z1),
                        hex(hp.schnorr_proof.z2)],
            "n": proof.n, "vanishing": [hex(v) for v in vanishing],
            "quotient": [hex(v) for v in quotient]}


def _from_record(rec):
    """The port PlookupProof of a _record."""
    pt = lambda h: point_from_bytes(TWEEDLEDEE, bytes.fromhex(h))
    r, z1, z2 = rec["schnorr"]
    return plookup.PlookupProof(
        **{k: pt(h) for k, h in zip(POINTS, rec["points"])},
        openings=plookup.PlookupOpenings(*(plookup.Opening(int(a, 16), int(b, 16))
                                           for a, b in rec["openings"])),
        halo_proof=OpeningProof(
            halo_l=[pt(h) for h in rec["halo_l"]], halo_r=[pt(h) for h in rec["halo_r"]],
            halo_g=pt(rec["halo_g"]),
            schnorr_proof=SchnorrProof(pt(r), int(z1, 16), int(z2, 16))),
        n=rec["n"])


@pytest.fixture(scope="module")
def runs():
    """The subset case's proof from the port under a fresh pinned source
    and the vanishing polynomial its prover made on the 4(n+1) domain;
    the JAX package's proof, vanishing polynomial and quotient (made under
    jax_adapter) from tests/fixtures/jax_proofs.json, which
    test_jax_plookup_fixture makes again."""
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halo_mod, "RANDOM_SOURCE", pinned_source())
        mp.setattr(plookup_mod, "_vanishing_polynomial", _recording(
            made, "port_vanishing", plookup_mod._vanishing_polynomial))
        made["port"] = plookup.prove(TWEEDLEDEE, F, T, device="cpu")
    made["jax"] = jaxfx.load("proofs", "plookup n = 7")
    return made


@pytest.fixture(scope="module")
def proofs(runs):
    return runs["port"], _from_record(runs["jax"])


def test_host_functions_match_jax():
    rng = np.random.default_rng(5)
    p = TWEEDLEDEE.scalar.p
    assert plookup.sort_by([5, 2, 1], [1, 2, 3, 4, 5]) == [1, 2, 5]
    for nf, nt in ((4, 7), (1, 3), (9, 4), (15, 16)):
        # 0 in t: pad_inputs pads f with zeros
        t = [0] + [int(x) for x in rng.integers(1, 50, nt - 1)]
        f = [t[int(i)] for i in rng.integers(0, nt, nf)]
        assert plookup.pad_inputs(f, t) == jplookup.pad_inputs(f, t)
        n, fp, tp = plookup.pad_inputs(f, t)
        s = plookup.sort_by(fp + tp, tp)
        assert s == jplookup.sort_by(fp + tp, tp)
        beta, gamma = (int.from_bytes(rng.bytes(40), "little") % p
                       for _ in range(2))
        assert plookup.grand_polynomial(p, fp, tp, s, beta, gamma) == \
            jplookup.grand_polynomial(p, fp, tp, s, beta, gamma)


def test_vanishing_and_quotient_match_jax(runs):
    """The 4(n+1)-domain identity at n = 7, as each package's prover made
    it for the subset case's proof, and its quotient by X^(n+1) - 1 (the
    JAX package's through jax_adapter's jit, which its prove compiled;
    both read from the fixture)."""
    sf, n = TWEEDLEDEE.scalar, 7
    van = runs["port_vanishing"]
    assert van.shape[-1] == 4 * (n + 1)
    assert [hex(int(x)) for x in fops.to_ints(sf, van)] == runs["jax"]["vanishing"]
    q = divide_by_z_h(sf, van, n + 1)
    assert [hex(int(x)) for x in fops.to_ints(sf, q)] == runs["jax"]["quotient"]


def test_proof_matches_jax(proofs):
    """Every commitment, opening and the Halo proof, value for value."""
    port, conv = proofs
    assert port.n == conv.n == 7
    for name in ("c_f", "c_t", "c_h1", "c_h2", "c_z", "c_quotient"):
        assert getattr(port, name) == getattr(conv, name), name
    assert port.openings == conv.openings
    assert port.halo_proof == conv.halo_proof
    assert port.to_bytes(TWEEDLEDEE) == conv.to_bytes(TWEEDLEDEE)
    # the value chip_smoke.py:phase_plookup holds the card's proof to
    assert hashlib.sha256(conv.to_bytes(TWEEDLEDEE)).hexdigest() == \
        PLOOKUP_N7_SHA256


def test_each_verifier_accepts_the_others_proof(proofs):
    """The port's verifier accepts its own proof and the JAX package's;
    the JAX verifier's acceptance of the port's proof is
    test_jax_plookup_fixture's."""
    port, conv = proofs
    plookup.verify(TWEEDLEDEE, T, port, device="cpu")
    plookup.verify(TWEEDLEDEE, T, conv, device="cpu")


@pytest.mark.slow
def test_jax_plookup_fixture():
    """The JAX package's n = 7 proof, vanishing polynomial and quotient
    that the tests above read, made again (~4 min on one CPU process,
    the compiles), and the JAX verifier's acceptance of the port's proof
    and of its own."""
    made = _jax_run()
    sf, n = J_DEE.scalar, 7
    quotient = cached_jit(jax_adapter, sf, n + 1)(made["vanishing"])
    rec = _record(from_jax(made["proof"]),
                  [int(x) for x in jfops.to_ints(sf, made["vanishing"])],
                  [int(x) for x in jfops.to_ints(sf, quotient)])
    jaxfx.check("proofs", "plookup n = 7", rec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halo_mod, "RANDOM_SOURCE", pinned_source())
        port = plookup.prove(TWEEDLEDEE, F, T, device="cpu")
    jplookup.verify(J_DEE, T, to_jax(port))
    jplookup.verify(J_DEE, T, made["proof"])


def test_changed_opening_is_rejected(proofs):
    """One opening changed.  Most changes already break the transcript (an
    IPA challenge with no square root, a ValueError too); take the first
    that does not, so that the verifier's own checks must reject it."""
    p = TWEEDLEDEE.scalar.p
    for delta in range(1, 1024):
        bad = copy.deepcopy(proofs[0])
        bad.openings.f.local = (bad.openings.f.local + delta) % p
        try:
            bad.get_challenges(TWEEDLEDEE)
        except ValueError:
            continue
        break
    else:
        pytest.fail("no changed opening kept a valid transcript")
    with pytest.raises(ValueError, match="Incorrect quotient opening"):
        plookup.verify(TWEEDLEDEE, T, bad, device="cpu")


def test_plookup_not_subset_fails():
    with pytest.raises(Exception):
        proof = plookup.prove(TWEEDLEDEE, [4], [1, 2, 3], device="cpu")
        plookup.verify(TWEEDLEDEE, [1, 2, 3], proof, device="cpu")


def _table():
    """tests/test_plookup.py:test_plookup_table_function's table (a + b
    over [0, 4)^2) and witness rows, in both packages."""
    spec = TWEEDLEDEE.scalar
    domain, witness = [0, 1, 2, 3], [(1, 2, 3), (3, 3, 6), (0, 0, 0)]
    table = plookup.Table.from_function_cartesian(
        spec, lambda a, b: (a + b) % spec.p, domain, arity=2)
    j_table = jplookup.Table.from_function_cartesian(
        J_DEE.scalar, lambda a, b: (a + b) % spec.p, domain, arity=2)
    return table, j_table, witness


def test_table_reduction_matches_jax():
    table, j_table, witness = _table()
    assert table.get_challenge() == j_table.get_challenge()
    assert table.reduce_with(witness) == j_table.reduce_with(witness)
    assert table.to_vec() == j_table.to_vec()


@pytest.mark.slow
def test_plookup_table_function():
    """tests/test_plookup.py:test_plookup_table_function on the port (n =
    15; ~40 s on one CPU process, so slow)."""
    table, _j_table, witness = _table()
    saved = halo_mod.RANDOM_SOURCE
    halo_mod.RANDOM_SOURCE = pinned_source()
    try:
        proof = table.prove_row(TWEEDLEDEE, witness, device="cpu")
    finally:
        halo_mod.RANDOM_SOURCE = saved
    table.verify(TWEEDLEDEE, proof, device="cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plookup.prove(TWEEDLEDEE, F, T)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plookup.verify(TWEEDLEDEE, T, None)
