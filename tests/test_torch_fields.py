"""The port's field ops (plonky_tpu_torch.fields.ops, plain versions on the
CPU) against the JAX package's plonky_tpu.fields.ops and python ints, for
both Tweedle fields and BLS12-377's two (the 377-bit base field at 12
limbs).  Canonical ints are compared, never digit arrays, with
exact equality: this is integer arithmetic."""

import jax
import numpy as np
import pytest
import torch

from plonky_tpu.fields import BLS12_377_BASE as J_BLS_BASE
from plonky_tpu.fields import BLS12_377_SCALAR as J_BLS_SCALAR
from plonky_tpu.fields import TWEEDLEDEE_BASE as J_DEE, TWEEDLEDUM_BASE as J_DUM
from plonky_tpu.fields import ops as jfops
from plonky_tpu_torch import interop
from plonky_tpu_torch.fields import (BLS12_377_BASE, BLS12_377_SCALAR,
                                     TWEEDLEDEE_BASE, TWEEDLEDUM_BASE)
from plonky_tpu_torch.fields import ops as fops

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

FIELDS = [(TWEEDLEDEE_BASE, J_DEE), (TWEEDLEDUM_BASE, J_DUM),
          (BLS12_377_BASE, J_BLS_BASE), (BLS12_377_SCALAR, J_BLS_SCALAR)]
BATCH = 37


def _values(p: int, seed: int):
    """37 values: adversarial ones first, the rest uniform from a seed."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << 128, (1 << 254) % p,
            (1 << 255) % p, ((1 << 256) - 1) % p]
    width = 40 if p.bit_length() <= 255 else 56       # 64 bits above p
    rand = [int.from_bytes(rng.bytes(width), "little") % p
            for _ in range(BATCH - len(edge))]
    return edge + rand


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


@pytest.mark.parametrize("spec,jspec", FIELDS, ids=lambda s: s.name)
def test_field_ops_match_jax(spec, jspec):
    p = spec.p
    av, bv, cv = _values(p, 1), _values(p, 2)[::-1], _values(p, 3)
    col = 0x1234567890ABCDEF1234567890ABCDEF % p
    a, b, c = (fops.from_ints(spec, v, "cpu") for v in (av, bv, cv))
    ccol = fops.column(spec, col, "cpu")
    ja, jb, jc = (jfops.from_ints(jspec, v) for v in (av, bv, cv))
    jcol = jfops.from_ints(jspec, [col])
    W = jfops.WORK_DB

    @jax.jit
    def reference(ja, jb, jc, jcol):
        return {
            "add": jfops.add(jspec, ja, jb),
            "sub": jfops.sub(jspec, ja, jb),
            "neg": jfops.neg(jspec, ja),
            "mul": jfops.mul(jspec, ja, jb),
            "square": jfops.square(jspec, ja),
            "mul_small": jfops.mul_small(jspec, ja, 12345),
            "product_sum": jfops.product_sum(jspec, [
                (jcol, W, ja, W, 1), (jb, W, jc, W, -1), (ja, W, None, 0, 1),
                (jc, W, None, 0, -1)]),
            "sum_reduce": jfops.sum_reduce(jspec, jfops.mul(jspec, ja, jb), 0),
            "inverse": jfops.inverse(jspec, ja),
            "exp": jfops.exp_const(jspec, ja, 0x1F2E3D),
        }

    want = {k: jfops.to_ints(jspec, v)
            for k, v in reference(ja, jb, jc, jcol).items()}
    got = {
        "add": fops.add(spec, a, b),
        "sub": fops.sub(spec, a, b),
        "neg": fops.neg(spec, a),
        "mul": fops.mul(spec, a, b),
        "square": fops.square(spec, a),
        "mul_small": fops.mul_small(spec, a, 12345),
        "product_sum": fops.product_sum(
            spec, [(ccol, a, 1), (b, c, -1), (a, None, 1), (c, None, -1)]),
        "sum_reduce": fops.sum_reduce(spec, fops.mul(spec, a, b), 0),
        "inverse": fops.inverse(spec, a),
        "exp": fops.exp_const(spec, a, 0x1F2E3D),
    }
    for k in want:
        assert _ints(fops.to_ints(spec, got[k])) == _ints(want[k]), k
    # and against python ints
    assert _ints(fops.to_ints(spec, got["product_sum"])) == [
        (col * x - y * z + x - z) % p for x, y, z in zip(av, bv, cv)]
    assert _ints(fops.to_ints(spec, got["inverse"])) == [
        pow(x, p - 2, p) for x in av]
    assert _ints(fops.to_ints(spec, got["inverse"]))[0] == 0   # inverse(0)


@pytest.mark.parametrize("spec,jspec", FIELDS, ids=lambda s: s.name)
def test_bits_select_and_comparisons(spec, jspec):
    p = spec.p
    av = _values(p, 4)
    a = fops.from_ints(spec, av, "cpu")
    n_bits = 32 * spec.limbs - 1            # 255 at 8 limbs, 383 at 12
    jbits = np.asarray(jfops.to_bits(jspec, jfops.from_ints(jspec, av), n_bits))
    assert np.array_equal(fops.to_bits(spec, a, n_bits).numpy(), jbits)
    mask = np.arange(BATCH) % 3 == 0
    z = fops.zeros(spec, (BATCH,), "cpu")
    sel = fops.select(torch.from_numpy(mask), a, z)
    assert _ints(fops.to_ints(spec, sel)) == [
        v if m else 0 for v, m in zip(av, mask)]
    assert fops.is_zero(spec, a).tolist() == [v == 0 for v in av]
    assert fops.eq(spec, a, sel).tolist() == [
        m or v == 0 for v, m in zip(av, mask)]


@pytest.mark.parametrize("spec", [TWEEDLEDEE_BASE, TWEEDLEDUM_BASE,
                                  BLS12_377_BASE, BLS12_377_SCALAR],
                         ids=lambda s: s.name)
def test_product_sum_extremes(spec):
    """32 terms of (p-1)^2 with mixed signs, and 33 (two launches' worth):
    the widest sums the reduction takes."""
    p = spec.p
    rng = np.random.default_rng(5)
    big = fops.from_ints(spec, [p - 1] * 5 + [p - 2, 1, 0], "cpu")
    for count in (32, 33):
        signs = [1 if rng.integers(2) else -1 for _ in range(count)]
        terms = [(big, big, s) for s in signs]
        want = [sum(s * v * v for s in signs) % p
                for v in [p - 1] * 5 + [p - 2, 1, 0]]
        assert _ints(fops.to_ints(spec, fops.product_sum(spec, terms))) == want


@pytest.mark.parametrize("spec,jspec", FIELDS, ids=lambda s: s.name)
def test_interop_digits_roundtrip(spec, jspec):
    """A JAX loose-digit result (digits above 255) reads back through
    interop.field_from_jax_digits as the same canonical values."""
    av, bv = _values(spec.p, 6), _values(spec.p, 7)
    loose = jax.jit(lambda x, y: jfops.add(jspec, x, y))(
        jfops.from_ints(jspec, av), jfops.from_ints(jspec, bv))
    digits = np.asarray(loose)
    port = interop.field_from_jax_digits(spec, digits, "cpu")
    assert _ints(fops.to_ints(spec, port)) == _ints(jfops.to_ints(jspec, loose))
    back = interop.field_to_jax_digits(spec, port, jspec.n_digits)
    assert _ints(jfops.to_ints(jspec, back)) == _ints(fops.to_ints(spec, port))
    bumped = digits.copy()
    bumped[0] += 1 << 20            # digit 0 far above 255: value + 2^20
    shifted = interop.field_from_jax_digits(spec, bumped, "cpu")
    assert _ints(fops.to_ints(spec, shifted)) == [
        (v + (1 << 20)) % spec.p for v in _ints(fops.to_ints(spec, port))]
