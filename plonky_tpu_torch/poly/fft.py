"""Batched radix-2 FFT over prime fields (the reference's src/fft.rs).

Values are [LIMBS, ..., n] tensors with the domain axis last.  A transform
is a bit-reversal gather (a torch index) followed by lg n butterfly layers.

K3, the NTT-stage kernel (csrc/ntt_kernels.cu), runs one layer on CUDA
tensors, one thread per butterfly, batched over the leading axes.
`ntt_stage_plain` is its plain PyTorch version; `ntt_stage` takes the plain
version only for CPU tensors.  The coset scaling and the 1/n of the
inverse are K1 multiplies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMBS, FieldSpec
from ..utils import log2_strict


@functools.lru_cache(maxsize=None)
class FftPrecomputation:
    """Twiddle tables for a size-n FFT over `spec` (n a power of two); the
    reference's FftPrecomputation (src/fft.rs:28-59)."""

    def __init__(self, spec: FieldSpec, n: int):
        self.spec = spec
        self.n = n
        self.lg_n = log2_strict(n)
        self.g = fhost.primitive_root_of_unity(spec, self.lg_n)
        self.g_inv = pow(self.g, -1, spec.p)
        self.n_inv = pow(n, -1, spec.p)
        self._device_tables = {}

    def _twiddle_ints(self, inverse: bool):
        """All layers in one list: layer ell (half-size m = 2^ell) holds
        [w^j, j < m] with w = g^(n / 2m), starting at index m - 1."""
        p = self.spec.p
        root = self.g_inv if inverse else self.g
        out = []
        for ell in range(self.lg_n):
            m = 1 << ell
            w = pow(root, self.n // (2 * m), p)
            cur = 1
            for _ in range(m):
                out.append(cur)
                cur = cur * w % p
        return out

    def tables(self, device, inverse: bool = False):
        """(twiddles [LIMBS, n - 1], bit-reversal index [n]) on `device`,
        built and uploaded once per (device, direction)."""
        key = (str(device), bool(inverse))
        if key not in self._device_tables:
            n = self.n
            idx = np.arange(n)
            rev = np.zeros(n, dtype=np.int64)
            for b in range(self.lg_n):
                rev |= ((idx >> b) & 1) << (self.lg_n - 1 - b)
            tw = (fops.from_ints(self.spec, self._twiddle_ints(inverse), device)
                  if n > 1 else fops.zeros(self.spec, (0,), device))
            self._device_tables[key] = (
                tw, torch.from_numpy(rev).to(device))
        return self._device_tables[key]

    @functools.cached_property
    def subgroup(self):
        """[1, g, g^2, ...] as python ints (host)."""
        return fhost.cyclic_subgroup_known_order(self.spec, self.g, self.n)


def ntt_stage_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                    m: int) -> torch.Tensor:
    """One butterfly layer of half-size m over x [LIMBS, B, n]:
    (x[e], x[e + m]) -> (e + o w_j, e - o w_j), w_j = tw[:, m - 1 + j]."""
    n = x.shape[-1]
    y = x.reshape(LIMBS, -1, n // (2 * m), 2, m)
    even, odd = y[..., 0, :], y[..., 1, :]
    w = tw[:, m - 1:2 * m - 1].reshape(LIMBS, 1, 1, m)
    t = fops.mul_plain(spec, odd, w)
    out = torch.stack([fops.add_plain(spec, even, t),
                       fops.sub_plain(spec, even, t)], dim=-2)
    return out.reshape(x.shape)


def ntt_stage(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
              m: int) -> torch.Tensor:
    """K3 on the card: one layer over x [LIMBS, B, n] into a new tensor."""
    if not fops._dispatch(x):
        return ntt_stage_plain(spec, x, tw, m)
    for t in (x, tw):
        _cuda.check("ntt_stage", t, LIMBS)
    if x.dim() != 3 or tw.shape[1] != x.shape[2] - 1 or x.shape[2] % (2 * m):
        raise ValueError(f"ntt_stage: x {tuple(x.shape)}, twiddles "
                         f"{tuple(tw.shape)}, m = {m}")
    batch, n = x.shape[1], x.shape[2]
    y = torch.empty_like(x)
    if batch * n == 0:
        return y
    _cuda.launch("ntt_stage", "pt_ntt_stage", y.data_ptr(), x.data_ptr(),
                 tw.data_ptr(), tw.shape[1], batch, n, m,
                 spec.kernel_consts.ctypes.data, _cuda.stream())
    return y


def _fft_core(pre: FftPrecomputation, x: torch.Tensor,
              inverse: bool) -> torch.Tensor:
    spec, n = pre.spec, pre.n
    assert x.shape[-1] == n, (x.shape, n)
    shape = x.shape
    tw, rev = pre.tables(x.device, inverse)
    y = x.reshape(LIMBS, -1, n)[..., rev].contiguous()
    for ell in range(pre.lg_n):
        y = ntt_stage(spec, y, tw, 1 << ell)
    y = y.reshape(shape)
    if inverse:
        y = fops.mul(spec, y, fops.column(spec, pre.n_inv, y.device))
    return y


def fft(pre: FftPrecomputation, coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the order-n subgroup [g^0..g^(n-1)]."""
    return _fft_core(pre, coeffs, inverse=False)


def ifft(pre: FftPrecomputation, values: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients (reference: src/fft.rs:82-101)."""
    return _fft_core(pre, values, inverse=True)


def pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis to length n."""
    if x.shape[-1] == n:
        return x
    pad = x.new_zeros((*x.shape[:-1], n - x.shape[-1]))
    return torch.cat([x, pad], dim=-1)


def lde(pre: FftPrecomputation, coeffs: torch.Tensor) -> torch.Tensor:
    """Zero-pad the coefficient axis to pre.n and FFT (the 8x low-degree
    extension; reference: src/plonk_util.rs:179-190)."""
    return fft(pre, pad_to(coeffs, pre.n))


def powers_dyn(spec: FieldSpec, base_col: torch.Tensor, n: int) -> torch.Tensor:
    """[base^0 .. base^(n-1)] as [LIMBS, n] from a [LIMBS, 1] device base:
    a doubling construction, log2(n) batched multiplies."""
    acc = fops.column(spec, 1, base_col.device)
    top = base_col   # invariant: top = base^(width of acc)
    while acc.shape[-1] < n:
        acc = torch.cat([acc, fops.mul(spec, acc, top)], dim=-1)
        if acc.shape[-1] < n:
            top = fops.square(spec, top)
    return acc[:, :n]


def powers_device(spec: FieldSpec, base: int, n: int, device) -> torch.Tensor:
    """[base^0, .., base^(n-1)] as [LIMBS, n] for a host-int base."""
    return powers_dyn(spec, fops.column(spec, base, device), n)


def _scale_by_powers(pre: FftPrecomputation, x: torch.Tensor,
                     base: int) -> torch.Tensor:
    powers = powers_device(pre.spec, base, pre.n, x.device)
    powb = powers.reshape((LIMBS,) + (1,) * (x.dim() - 2) + (pre.n,))
    return fops.mul(pre.spec, x, powb)


def coset_fft(pre: FftPrecomputation, coeffs: torch.Tensor,
              shift: int) -> torch.Tensor:
    """Evaluations over the coset shift*H: scale coeff i by shift^i, then FFT."""
    return fft(pre, _scale_by_powers(pre, coeffs, shift))


def coset_ifft(pre: FftPrecomputation, values: torch.Tensor,
               shift: int) -> torch.Tensor:
    coeffs = ifft(pre, values)
    return _scale_by_powers(pre, coeffs, pow(shift, -1, pre.spec.p))
