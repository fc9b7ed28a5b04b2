"""Batched radix-2 FFT over prime fields (the reference's src/fft.rs).

Values are [LIMBS, ..., n] tensors with the domain axis last.  A transform
is the input in bit-reversed order followed by lg n butterfly layers; layer
ell (half-size m = 2^ell) maps the pair (pos, pos + m), j = pos mod m, to
(e + o w_m^j, e - o w_m^j).

K3, the NTT kernel (csrc/ntt_kernels.cu), runs a whole transform on CUDA
tensors in len(pass_plan(lg n)) launches of `ntt_pass`: each pass runs up
to NTT_MAX_LAYERS consecutive layers on groups of elements held in shared
memory, the first pass loading through the bit reversal (and multiplying
by shift^i for a coset transform), the last multiplying by the inverse's
scale.  `ntt_plain` is its plain PyTorch version: the same passes, groups,
positions and twiddle indices (`_pass_groups`, `_twiddle_index`), with
canonical twiddles where the kernel holds them in Montgomery form.  `fft`,
`ifft`, `lde`, `coset_fft` and `coset_ifft` take the plain version only
for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from .. import _cuda
from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMB_BITS, LIMBS, FieldSpec, require_eight_limbs
from ..utils import log2_strict

# Layers of one ntt_pass launch, and elements of one block's groups: the
# best of a sweep on the H100 (PERF.md).  csrc/ntt_kernels.cu defines the
# same two values and sizes its shared memory by them.
NTT_MAX_LAYERS = 7
NTT_BLOCK_ELEMS = 512
_MONT_R_BITS = LIMB_BITS * LIMBS   # Montgomery form: v 2^256 mod p


@functools.lru_cache(maxsize=None)
class FftPrecomputation:
    """Twiddle and scale tables for a size-n FFT over `spec` (n a power of
    two); the reference's FftPrecomputation (src/fft.rs:28-59).  Tables are
    built on the host and uploaded once per device and form."""

    def __init__(self, spec: FieldSpec, n: int):
        require_eight_limbs(spec, "FftPrecomputation")
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

    def _powers_ints(self, base: int, scale: int = 1):
        """[scale base^i, i < n] mod p."""
        p = self.spec.p
        out, cur = [], scale % p
        for _ in range(self.n):
            out.append(cur)
            cur = cur * base % p
        return out

    def _upload(self, key, device, montgomery: bool, make):
        """The table `make()` (python ints) as [LIMBS, len] on `device`,
        in Montgomery form (v 2^256 mod p) when asked; cached."""
        key = (key, str(device), bool(montgomery))
        if key not in self._device_tables:
            vals = make()
            if montgomery:
                p = self.spec.p
                vals = [(v << _MONT_R_BITS) % p for v in vals]
            self._device_tables[key] = fops.from_ints(self.spec, vals, device)
        return self._device_tables[key]

    def twiddles(self, device, inverse: bool = False,
                 montgomery: bool = False) -> torch.Tensor:
        """[LIMBS, n - 1]: layer of half-size m at column m - 1."""
        return self._upload(("tw", bool(inverse)), device, montgomery,
                            lambda: self._twiddle_ints(inverse))

    def coset_powers(self, device, shift: int,
                     montgomery: bool = False) -> torch.Tensor:
        """[LIMBS, n]: shift^i, the coset transform's input scale."""
        return self._upload(("coset", shift % self.spec.p), device, montgomery,
                            lambda: self._powers_ints(shift))

    def inverse_scale(self, device, shift=None,
                      montgomery: bool = False) -> torch.Tensor:
        """The inverse transform's output scale: n^-1 as [LIMBS, 1], or
        n^-1 shift^-i as [LIMBS, n] for the inverse coset transform."""
        if shift is None:
            return self._upload(("n_inv",), device, montgomery,
                                lambda: [self.n_inv])
        shift_inv = pow(shift, -1, self.spec.p)
        return self._upload(("coset_inv", shift % self.spec.p), device,
                            montgomery,
                            lambda: self._powers_ints(shift_inv, self.n_inv))

    @functools.cached_property
    def subgroup(self):
        """[1, g, g^2, ...] as python ints (host)."""
        return fhost.cyclic_subgroup_known_order(self.spec, self.g, self.n)


def pass_plan(lg: int, max_layers: int = NTT_MAX_LAYERS):
    """The passes of a transform of 2^lg points: [(first layer, layer
    count)], as few as max_layers allows, the layers spread evenly (the
    earlier passes take the extra one)."""
    if lg == 0:
        return []
    count = -(-lg // max_layers)
    base, extra = divmod(lg, count)
    plan, l0 = [], 0
    for i in range(count):
        kp = base + (i < extra)
        plan.append((l0, kp))
        l0 += kp
    return plan


def block_groups(batch: int, lg: int, kp: int) -> int:
    """lg of the groups of 2^kp elements one ntt_pass block holds: as many
    as NTT_BLOCK_ELEMS allows, and no more than the pass's batch 2^(lg - kp)
    groups round up to."""
    groups = batch << (lg - kp)
    return max(0, min(log2_strict(NTT_BLOCK_ELEMS) - kp,
                      (groups - 1).bit_length()))


def _bit_reverse(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def _pass_groups(lg: int, l0: int, kp: int, device):
    """(src, dst), each [Q, S] (Q = 2^(lg - kp) groups of a row, S = 2^kp
    members): the row positions member s of group r is read from and
    written to by the pass (l0, kp), as ntt_pass_kernel computes them.  The
    first pass reads through the bit reversal: group r is the tile of
    outputs at rev(r) S, read from rev(s) Q + r."""
    q_count, size = 1 << (lg - kp), 1 << kp
    r = torch.arange(q_count, device=device)[:, None]
    s = torch.arange(size, device=device)[None, :]
    if l0 == 0:
        return (_bit_reverse(s, kp) * q_count + r,
                _bit_reverse(r, lg - kp) * size + s)
    low = (1 << l0) - 1
    pos = (r & low) | ((r >> l0) << (l0 + kp)) | (s << l0)
    return pos, pos


def _twiddle_index(l0: int, d: int, q_count: int, size: int, device):
    """(se, so, j) of local layer d of a pass: the members of each group's
    butterflies (each [S / 2]) and the twiddle index j [Q, S / 2] of each,
    into the layer of half-size m = 2^(l0 + d) (column m - 1 + j)."""
    h = 1 << d
    q = torch.arange(size // 2, device=device)
    se = ((q >> d) << (d + 1)) | (q & (h - 1))
    r = torch.arange(q_count, device=device)[:, None]
    j = (r & ((1 << l0) - 1)) + ((se & (h - 1)) << l0)[None, :]
    return se, se + h, j


def ntt_plain(pre: FftPrecomputation, x: torch.Tensor, inverse: bool = False,
              shift=None, max_layers: int = NTT_MAX_LAYERS) -> torch.Tensor:
    """The transform of `ntt`, pass by pass as the kernel runs it, with the
    plain field ops: fft (shift None) or coset_fft, or with `inverse`,
    ifft or coset_ifft."""
    spec, n, lg = pre.spec, pre.n, pre.lg_n
    assert x.shape[-1] == n, (x.shape, n)
    shape, dev = x.shape, x.device
    y = x.reshape(LIMBS, -1, n)
    if lg == 0 or y.shape[1] == 0:
        return y.clone().reshape(shape)
    tw = pre.twiddles(dev, inverse)
    pre_tab = (pre.coset_powers(dev, shift)
               if shift is not None and not inverse else None)
    post = pre.inverse_scale(dev, shift) if inverse else None
    plan = pass_plan(lg, max_layers)
    for i, (l0, kp) in enumerate(plan):
        src, dst = _pass_groups(lg, l0, kp, dev)
        v = y[:, :, src]                               # [LIMBS, B, Q, S]
        if i == 0 and pre_tab is not None:
            v = fops.mul_plain(spec, v, pre_tab[:, None, src])
        for d in range(kp):
            se, so, j = _twiddle_index(l0, d, src.shape[0], src.shape[1], dev)
            w = tw[:, None, (1 << (l0 + d)) - 1 + j]
            even, odd = v[..., se], v[..., so]
            t = fops.mul_plain(spec, odd, w)
            v = v.clone()
            v[..., se] = fops.add_plain(spec, even, t)
            v[..., so] = fops.sub_plain(spec, even, t)
        if i == len(plan) - 1 and post is not None:
            v = fops.mul_plain(spec, v, post if post.shape[1] == 1
                               else post[:, None, dst])
        out = torch.empty_like(y)
        out[:, :, dst] = v
        y = out
    return y.reshape(shape)


def ntt(pre: FftPrecomputation, x: torch.Tensor, inverse: bool = False,
        shift=None) -> torch.Tensor:
    """K3 on the card: the transform of `ntt_plain` in one ntt_pass launch
    per pass of pass_plan, into a new tensor."""
    if not fops._dispatch(x):
        return ntt_plain(pre, x, inverse, shift)
    spec, n, lg = pre.spec, pre.n, pre.lg_n
    if x.shape[-1] != n:
        raise ValueError(f"ntt: x {tuple(x.shape)} for n = {n}")
    shape, dev = x.shape, x.device
    x3 = x.reshape(LIMBS, -1, n).contiguous()
    _cuda.check("ntt_pass", x3, LIMBS)
    batch = x3.shape[1]
    if lg == 0 or batch == 0:
        return x3.clone().reshape(shape)
    tw = pre.twiddles(dev, inverse, montgomery=True)
    pre_tab = (pre.coset_powers(dev, shift, montgomery=True)
               if shift is not None and not inverse else None)
    post = pre.inverse_scale(dev, shift, montgomery=True) if inverse else None
    y = torch.empty_like(x3)
    src = x3
    plan = pass_plan(lg)
    for i, (l0, kp) in enumerate(plan):
        lg_groups = block_groups(batch, lg, kp)
        last = i == len(plan) - 1
        _cuda.launch(
            "ntt_pass", "pt_ntt_pass", y.data_ptr(), src.data_ptr(),
            tw.data_ptr(),
            pre_tab.data_ptr() if i == 0 and pre_tab is not None else None,
            post.data_ptr() if last and post is not None else None,
            int(post is not None and post.shape[1] == 1), batch, lg, l0, kp,
            lg_groups, spec.kernel_consts.ctypes.data, _cuda.stream())
        src = y
    return y.reshape(shape)


def fft(pre: FftPrecomputation, coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the order-n subgroup [g^0..g^(n-1)]."""
    return ntt(pre, coeffs)


def ifft(pre: FftPrecomputation, values: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients (reference: src/fft.rs:82-101)."""
    return ntt(pre, values, inverse=True)


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
    require_eight_limbs(spec, "powers_dyn")
    acc = fops.column(spec, 1, base_col.device)
    top = base_col   # invariant: top = base^(width of acc)
    while acc.shape[-1] < n:
        acc = torch.cat([acc, fops.mul(spec, acc, top)], dim=-1)
        if acc.shape[-1] < n:
            top = fops.square(spec, top)
    return acc[:, :n]


def coset_fft(pre: FftPrecomputation, coeffs: torch.Tensor,
              shift: int) -> torch.Tensor:
    """Evaluations over the coset shift*H: scale coeff i by shift^i, then FFT
    (the scaling runs in the transform's first pass)."""
    return ntt(pre, coeffs, shift=shift)


def coset_ifft(pre: FftPrecomputation, values: torch.Tensor,
               shift: int) -> torch.Tensor:
    """Inverse of coset_fft: iFFT, then scale coeff i by shift^-i (in the
    transform's last pass, with the 1/n)."""
    return ntt(pre, values, inverse=True, shift=shift)
