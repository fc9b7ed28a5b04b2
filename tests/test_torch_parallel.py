"""The port's sharded FFTs and MSM (plonky_tpu_torch.parallel, meshes of
CPU entries, plain versions of the kernels) against the port's one-device
functions and the JAX package's sharded functions on conftest's 8 virtual
devices; and the launch routing every kernel wrapper goes through
(`_cuda.launch`: one card a launch).  Inputs are made from numpy seeds and
cross as the JAX package's digit arrays through interop.py.  Comparisons
are exact: canonical field values and affine points (ROADMAP C4)."""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from plonky_tpu.curves import TWEEDLEDEE as J_CURVE
from plonky_tpu.curves import ops as jcops
from plonky_tpu.fields import TWEEDLEDEE_BASE as J_SPEC
from plonky_tpu.fields import ops as jfops
from plonky_tpu.parallel import fft as jpfft
from plonky_tpu.parallel import msm as jpmsm
from plonky_tpu.parallel.mesh import default_mesh as j_default_mesh
from plonky_tpu_torch import _cuda, device, interop, msms_bench
from plonky_tpu_torch.curves import TWEEDLEDEE as CURVE
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import TWEEDLEDEE_BASE as SPEC
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.parallel import (default_mesh, fft_sharded_batch,
                                       fft_sharded_domain, msm_sharded,
                                       shard_basis)
from plonky_tpu_torch.parallel import fft as ppfft
from plonky_tpu_torch.poly import fft as pfft

# The plain versions run thousands of small tensor ops: extra intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

jfft = importlib.import_module("plonky_tpu.poly.fft")


def _coeffs(seed, shape):
    """Random canonical values as the JAX package's digits [D, *shape] and
    the port's limbs [8, *shape] (through interop)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % SPEC.p
            for _ in range(int(np.prod(shape)))]
    digits = jfops.from_ints(J_SPEC, vals).reshape(J_SPEC.n_digits, *shape)
    return digits, interop.field_from_jax_digits(SPEC, np.asarray(digits), "cpu")


def _ints(x):
    return np.asarray(fops.to_ints(SPEC, x)).reshape(-1).tolist()


def _jax_ints(x):
    return np.asarray(jfops.to_ints(J_SPEC, x)).reshape(-1).tolist()


@pytest.mark.parametrize("m,k,lg_n", [(8, 8, 6), (3, 3, 8)])
def test_fft_sharded_batch(m, k, lg_n):
    """Mesh m over a batch of k polynomials: the port's one-device fft and
    the JAX package's fft_sharded_batch."""
    n = 1 << lg_n
    digits, x = _coeffs(m, (k, n))
    pre = pfft.FftPrecomputation(SPEC, n)
    got = fft_sharded_batch(default_mesh(m, "cpu"), pre, x)
    assert torch.equal(got, pfft.fft(pre, x))
    want = jpfft.fft_sharded_batch(j_default_mesh(m),
                                   jfft.FftPrecomputation(J_SPEC, n), digits)
    assert _ints(got) == _jax_ints(want)


@pytest.mark.parametrize("lg_n,lg_n1", [(8, 3), (10, 2)])
def test_row_twiddles_are_the_tables_rows(lg_n, lg_n1):
    """Each shard's own twiddle row equals its row of the four-step table
    (held against the JAX package's in test_torch_fft_four_step.py)."""
    n = 1 << lg_n
    table = pfft.four_step_twiddles(SPEC, n, lg_n1, device="cpu").canonical
    rows = tuple(range(1, 1 << lg_n1, 2))
    got = ppfft.row_twiddles(SPEC, n, lg_n1, rows, torch.device("cpu"))
    assert torch.equal(got, table[:, list(rows)])
    one = ppfft.row_twiddles(SPEC, n, lg_n1, (0,), torch.device("cpu"))
    assert torch.equal(one, table[:, :1])


def test_fft_sharded_domain_matches_jax():
    """Mesh 8 over one domain of 2^8: the one-device fft and the JAX
    package's four-step fft_sharded_domain."""
    digits, x = _coeffs(2, (1 << 8,))
    got = fft_sharded_domain(default_mesh(8, "cpu"), SPEC, x)
    assert torch.equal(got, pfft.fft(pfft.FftPrecomputation(SPEC, 1 << 8), x))
    want = jpfft.fft_sharded_domain(j_default_mesh(8), J_SPEC, digits)
    assert _ints(got) == _jax_ints(want)


@pytest.mark.parametrize("m,shape", [(4, (2, 1 << 6)), (1, (1 << 4,))])
def test_fft_sharded_domain_shapes(m, shape):
    """A batch axis and a mesh of one against the one-device fft; a mesh
    size that is not a power of two, or whose square does not divide n
    (the exchange's blocks would not be whole), is refused."""
    _digits, x = _coeffs(m, shape)
    pre = pfft.FftPrecomputation(SPEC, shape[-1])
    assert torch.equal(fft_sharded_domain(default_mesh(m, "cpu"), SPEC, x),
                       pfft.fft(pre, x))
    for bad in (3, 16):
        with pytest.raises(ValueError, match="power of two"):
            fft_sharded_domain(default_mesh(bad, "cpu"), SPEC, x)


def _chain_points(n, seed):
    """A doubling chain of n points from a random multiple of the
    generator (host affine points)."""
    rng = np.random.default_rng(seed)
    cur = chost.mul(chost.generator(CURVE), int(rng.integers(1, 1 << 60)))
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = chost.add(cur, cur)
    return pts


def _identity_heavy_scalars(n, seed):
    """tests/test_parallel.py's scalars: a quarter zero, a quarter
    repeating another quarter."""
    rng = np.random.default_rng(seed)
    scal = [int.from_bytes(rng.bytes(40), "little") % CURVE.scalar.p
            for _ in range(n)]
    for i in range(0, n, 4):
        scal[i] = 0
    for i in range(1, n, 4):
        scal[i] = scal[(i + 4) % n]
    return scal


def _basis(pts):
    xs = fops.from_ints(CURVE.base, [p.x for p in pts], "cpu")
    ys = fops.from_ints(CURVE.base, [p.y for p in pts], "cpu")
    return cmsm.precompute_base(CURVE, cops.from_affine(CURVE, xs, ys))


def _affine(pt):
    x, y, zero = cops.to_affine(CURVE, pt)
    return bool(zero), fops.to_ints(CURVE.base, x), fops.to_ints(CURVE.base, y)


def _host_msm(pts, scal):
    acc = chost.zero_point(CURVE)
    for p, s in zip(pts, scal):
        if s:
            acc = chost.add(acc, chost.mul(p, s))
    return False, acc.x, acc.y


# N = 5 x 64 points split by both meshes below (40 or 64 a shard).
MSM_N = 320


@functools.lru_cache(maxsize=None)
def _msm_case():
    """The sharded MSM tests' points, scalars, basis and their one-device
    and host MSMs (made once: the plain MSM is ~1.3 s a call here, most of
    it the plain Horner)."""
    pts = _chain_points(MSM_N, 5)
    scal = _identity_heavy_scalars(MSM_N, 5)
    basis = _basis(pts)
    scalars = fops.from_ints(CURVE.scalar, scal, "cpu")
    want = _affine(cmsm.msm(CURVE, basis, scalars, 4))
    assert want == _host_msm(pts, scal)
    return basis, scalars, want


@pytest.mark.parametrize("m", [8, 5])
def test_msm_sharded(m):
    """Point-sharded MSM at window 4 over 320 points, power-of-two and odd
    mesh splits with identity-heavy scalars: the port's one-device msm,
    itself equal to a host sum; a basis the mesh does not divide is
    refused."""
    basis, scalars, want = _msm_case()
    mesh = default_mesh(m, "cpu")
    shards = shard_basis(mesh, basis)
    assert [s.n for s in shards] == [MSM_N // m] * m
    assert _affine(msm_sharded(mesh, CURVE, shards, scalars, window_bits=4)) == want
    with pytest.raises(ValueError, match="over"):
        shard_basis(mesh, basis.slice(0, MSM_N - 1))


@pytest.mark.slow
def test_msm_sharded_matches_jax():
    """The JAX package's msm_sharded (44 s a case at 2^10 on one CPU
    process) against the port's, mesh 8 over 64 points at window 4."""
    n = 64
    pts = _chain_points(n, 4)
    scal = _identity_heavy_scalars(n, 4)
    xs = jfops.from_ints(J_CURVE.base, [p.x for p in pts])
    ys = jfops.from_ints(J_CURVE.base, [p.y for p in pts])
    jp = jcops.from_affine(J_CURVE, xs, ys, jax.numpy.zeros(n, bool))
    js = jfops.from_ints(J_CURVE.scalar, scal)
    want = jpmsm.msm_sharded(j_default_mesh(8), J_CURVE, jp, js, window_bits=4)
    x, y, zero = jax.jit(lambda q: jcops.to_affine(J_CURVE, q))(want)
    want = (bool(np.asarray(zero)), jfops.to_ints(J_CURVE.base, x),
            jfops.to_ints(J_CURVE.base, y))
    basis = cmsm.precompute_base(CURVE, interop.points_from_jax(
        CURVE, [np.asarray(t) for t in jp], "cpu"))
    mesh = default_mesh(8, "cpu")
    got = msm_sharded(mesh, CURVE, shard_basis(mesh, basis),
                      fops.from_ints(CURVE.scalar, scal, "cpu"), window_bits=4)
    assert _affine(got) == want


@pytest.mark.slow
def test_msms_bench_on_the_cpu():
    """The harness end to end at 16 points over meshes of 1 and 2 CPU
    entries, each result held against the single-device MSM inside it
    (~12 s: five plain MSMs)."""
    results = msms_bench.main(["--device", "cpu", "--log-n", "4", "--window",
                               "4", "--virtual", "2", "--reps", "1"])
    assert sorted(results) == [1, 2]


def test_default_mesh():
    mesh = default_mesh(5, "cpu")
    assert mesh.size == 5 and mesh.cards() == [torch.device("cpu")]
    assert default_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        default_mesh(0, "cpu")


def test_launch_takes_one_device():
    """A launch whose tensors lie on two devices raises before anything is
    built or called; none is counted."""
    _cuda.reset_launches()
    a = torch.zeros(2, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.int32, device="meta")
    assert _cuda.device_of("field_mul", (a, None, a)) == torch.device("cpu")
    with pytest.raises(ValueError, match="one device"):
        _cuda.launch("field_mul", "pt_field_mul", (a, b), 0)
    assert _cuda.LAUNCHES["field_mul"] == 0 and not _cuda.DEVICE_LAUNCHES


def test_resolve_names_the_card(monkeypatch):
    """A bare "cuda" resolves to the current card with its index, so that
    tables cached by device belong to one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device.resolve() == torch.device("cuda", 3)
    assert device.resolve("cuda:1") == torch.device("cuda", 1)
    assert device.resolve("cpu") == torch.device("cpu")
