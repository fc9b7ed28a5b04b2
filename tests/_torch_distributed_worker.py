"""One process of tests/test_torch_distributed.py: the port of
tests/_distributed_worker.py on torch.distributed (gloo, 4 CPU entries a
process, 2 processes: the hybrid [2, 4] mesh).

Launched with MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK set.  Checks
a sum over every shard of both processes (JAX's psum), the MSM of both
processes' shares (N = 16, window 4) against a host oracle, and the
domain-sharded FFT across both processes against the one-process `fft`.
"""

import numpy as np
import torch

from plonky_tpu_torch.curves import TWEEDLEDEE as curve
from plonky_tpu_torch.curves import host as chost
from plonky_tpu_torch.curves import msm as cmsm
from plonky_tpu_torch.curves import ops as cops
from plonky_tpu_torch.fields import ops as fops
from plonky_tpu_torch.parallel import distributed, msm as pmsm
from plonky_tpu_torch.poly import fft as pfft

torch.set_num_threads(1)

dev = distributed.initialize(device="cpu")
mesh = distributed.hybrid_mesh(4, device=dev)
assert mesh.shape == (2, 4), mesh.shape
rank = mesh.rank

# --- a sum over every shard of both processes ------------------------------
lo, hi = distributed.process_local_slice(16)
xs = torch.arange(16, dtype=torch.int64)[lo:hi]
parts = [x.sum(0, keepdim=True).to(d)
         for x, d in zip(xs.tensor_split(mesh.local.size), mesh.local.devices)]
total = int(distributed.psum(mesh, parts).item())
assert total == int(np.arange(16).sum()), total

# --- the MSM of both processes' shares ------------------------------------
N = 16
rng = np.random.default_rng(7)
g = chost.generator(curve)
pts = [chost.mul(g, int(k)) for k in rng.integers(1, 1 << 30, N)]
scal = [int(s) for s in rng.integers(1, 1 << 30, N)]
expected = None
for p_, s_ in zip(pts, scal):
    term = chost.mul(p_, s_)
    expected = term if expected is None else chost.add(expected, term)

lo, hi = distributed.process_local_slice(N)
basis = cmsm.precompute_base(curve, cops.from_affine(
    curve, fops.from_ints(curve.base, [p_.x for p_ in pts[lo:hi]], dev),
    fops.from_ints(curve.base, [p_.y for p_ in pts[lo:hi]], dev)))
scalars = fops.from_ints(curve.scalar, scal[lo:hi], dev)
out = distributed.msm_sharded(mesh, curve, pmsm.shard_basis(mesh.local, basis),
                              scalars, window_bits=4)
x, y, zero = cops.to_affine(curve, out)
assert not bool(zero), "MSM returned the identity"
got = chost.AffinePoint(curve, fops.to_ints(curve.base, x),
                        fops.to_ints(curve.base, y))
assert got == expected, (got, expected)

# --- the domain-sharded FFT across both processes --------------------------
spec = curve.scalar
n = 1 << 6
coeffs = fops.from_ints(spec, [int.from_bytes(rng.bytes(40), "little") % spec.p
                               for _ in range(n)], dev)
got = distributed.fft_sharded_domain(mesh, spec, coeffs)
assert torch.equal(got, pfft.fft(pfft.FftPrecomputation(spec, n), coeffs))

print(f"proc {rank}: distributed psum + sharded MSM + sharded FFT OK", flush=True)
