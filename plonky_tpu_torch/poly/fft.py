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

`fft_four_step` is the JAX package's single-chip four-step FFT
(plonky_tpu/poly/fft.py:198-262): n = n1 n2, two batched K3 transforms of
n2 and of n1 points around `ntt_twiddle_transpose` launches
(csrc/ntt_kernels.cu), which transpose the last two axes through shared
memory and, in the middle step, multiply by the table of
`four_step_twiddles`.  `twiddle_transpose_plain` is that kernel's plain
version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _cuda
from ..device import resolve
from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import LIMBS, FieldSpec, require_eight_limbs
from ..utils import log2_strict

# Layers of one ntt_pass launch, and elements of one block's groups: the
# best of a sweep on the H100 (PERF.md).  csrc/ntt_kernels.cu defines the
# same two values and sizes its shared memory by them.
NTT_MAX_LAYERS = 7
NTT_BLOCK_ELEMS = 512


@functools.lru_cache(maxsize=None)
class FftPrecomputation:
    """Twiddle and scale tables for a size-n FFT over `spec` (n a power of
    two); the reference's FftPrecomputation (src/fft.rs:28-59).  Tables are
    made once per device and form, canonical or Montgomery (v 2^256 mod p,
    one K1 multiply on the card): the twiddles on the device by K1 (a
    Python-int build of both directions' [8, n - 1] tables and their first
    transforms took 15 s at n = 2^22 on the host of an H100 machine), the
    coset and inverse scales on the host."""

    def __init__(self, spec: FieldSpec, n: int):
        require_eight_limbs(spec, "FftPrecomputation")
        self.spec = spec
        self.n = n
        self.lg_n = log2_strict(n)
        self.g = fhost.primitive_root_of_unity(spec, self.lg_n)
        self.g_inv = pow(self.g, -1, spec.p)
        self.n_inv = pow(n, -1, spec.p)
        self._tables = {}

    def _table(self, key, device, montgomery: bool, make):
        """The canonical [LIMBS, len] table `make(device)`, or its
        Montgomery form when asked; both cached by card (a bare "cuda"
        names the current one)."""
        device = resolve(device)
        full = (key, str(device), bool(montgomery))
        if full not in self._tables:
            if montgomery:
                tab = fops.to_montgomery(
                    self.spec, self._table(key, device, False, make))
            else:
                tab = make(device).contiguous()
            self._tables[full] = tab
        return self._tables[full]

    def _powers(self, base: int, scale: int = 1):
        """A maker of the table [scale base^i, i < n] mod p, built on the
        host."""
        p = self.spec.p

        def make(device):
            out, cur = [], scale % p
            for _ in range(self.n):
                out.append(cur)
                cur = cur * base % p
            return fops.from_ints(self.spec, out, device)
        return make

    def twiddles(self, device, inverse: bool = False,
                 montgomery: bool = False) -> torch.Tensor:
        """[LIMBS, n - 1]: layer ell (half-size m = 2^ell) holds [w^j, j <
        m], w = g^(n / 2m), from column m - 1.  Built on `device` from the
        powers g^i, i < n / 2 (`powers_dyn`, lg n - 1 doubling steps of
        K1), of which layer m takes every (n / 2m)-th."""
        def make(device):
            half = self.n // 2
            if half == 0:
                return torch.zeros((LIMBS, 0), dtype=torch.int32, device=device)
            root = self.g_inv if inverse else self.g
            pw = powers_dyn(self.spec, fops.column(self.spec, root, device), half)
            return torch.cat([pw[:, ::half >> ell] for ell in range(self.lg_n)],
                             dim=1)
        return self._table(("tw", bool(inverse)), device, montgomery, make)

    def coset_powers(self, device, shift: int,
                     montgomery: bool = False) -> torch.Tensor:
        """[LIMBS, n]: shift^i, the coset transform's input scale."""
        return self._table(("coset", shift % self.spec.p), device, montgomery,
                           self._powers(shift))

    def inverse_scale(self, device, shift=None,
                      montgomery: bool = False) -> torch.Tensor:
        """The inverse transform's output scale: n^-1 as [LIMBS, 1], or
        n^-1 shift^-i as [LIMBS, n] for the inverse coset transform."""
        if shift is None:
            return self._table(("n_inv",), device, montgomery,
                               lambda d: fops.column(self.spec, self.n_inv, d))
        shift_inv = pow(shift, -1, self.spec.p)
        return self._table(("coset_inv", shift % self.spec.p), device,
                           montgomery, self._powers(shift_inv, self.n_inv))

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
            "ntt_pass", "pt_ntt_pass", (y, src, tw, pre_tab, post), y.data_ptr(),
            src.data_ptr(), tw.data_ptr(),
            pre_tab.data_ptr() if i == 0 and pre_tab is not None else None,
            post.data_ptr() if last and post is not None else None,
            int(post is not None and post.shape[1] == 1), batch, lg, l0, kp,
            lg_groups, spec.kernel_consts.ctypes.data)
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
    """[base^0 .. base^(n-1)] as [LIMBS, *B, n] from [LIMBS, *B, 1] device
    bases: a doubling construction, log2(n) batched multiplies."""
    require_eight_limbs(spec, "powers_dyn")
    acc = fops.constant(spec, 1, base_col.shape[1:], base_col.device).contiguous()
    top = base_col   # invariant: top = base^(width of acc)
    while acc.shape[-1] < n:
        acc = torch.cat([acc, fops.mul(spec, acc, top)], dim=-1)
        if acc.shape[-1] < n:
            top = fops.square(spec, top)
    return acc[..., :n]


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


class Twiddles(NamedTuple):
    """A table of the four-step FFT's middle step in both forms: `canonical`
    [8, r, s], the API's and the plain version's, and `montgomery` (w 2^256
    mod p), which ntt_twiddle_transpose reads."""
    canonical: torch.Tensor
    montgomery: torch.Tensor

    @classmethod
    def of(cls, spec: FieldSpec, canonical: torch.Tensor) -> Twiddles:
        canonical = canonical.contiguous()
        return cls(canonical, fops.to_montgomery(spec, canonical))


@functools.lru_cache(maxsize=8)
def _four_step_table(spec: FieldSpec, n: int, lg_n1: int, inverse: bool,
                     device: torch.device) -> Twiddles:
    require_eight_limbs(spec, "four_step_twiddles")
    n1 = 1 << lg_n1
    n2 = n // n1
    if n1 * n2 != n or n2 < 1:
        raise ValueError(f"four_step_twiddles: n = {n}, lg_n1 = {lg_n1}")
    g = fhost.primitive_root_of_unity(spec, log2_strict(n))
    if inverse:
        g = pow(g, -1, spec.p)
    bases = powers_dyn(spec, fops.column(spec, g, device), n1)      # [8, n1]
    acc = fops.constant(spec, 1, (n1, 1), device).contiguous()       # [8, n1, 1]
    top = bases[..., None]           # invariant: top = base^(width of acc)
    while acc.shape[-1] < n2:
        acc = torch.cat([acc, fops.mul(spec, acc, top)], dim=-1)
        if acc.shape[-1] < n2:
            top = fops.square(spec, top)
    return Twiddles.of(spec, acc)


def four_step_twiddles(spec: FieldSpec, n: int, lg_n1: int,
                       inverse: bool = False, device=None) -> Twiddles:
    """The four-step FFT's middle table w_n^(+-i1 k2), [8, n1, n2] (n1 =
    2^lg_n1, n2 = n / n1); plonky_tpu/poly/fft.py:204-225.  Built on
    `device` (the card unless the CPU is asked for) by the same doubling:
    the bases w_n^i1 (`powers_dyn`), then lg n2 batched K1 multiplies
    along k2.  The eight latest tables are cached (256 MiB a table on the
    card at n = 2^22)."""
    return _four_step_table(spec, n, lg_n1, bool(inverse), resolve(device))


def twiddle_transpose_plain(spec: FieldSpec, x: torch.Tensor,
                            tw: Twiddles | None = None) -> torch.Tensor:
    """x [8, *B, r, s] (times tw [8, r, s] when given) with its last two
    axes swapped: [8, *B, s, r]."""
    if tw is not None:
        x = fops.mul_plain(spec, x, tw.canonical)
    return x.transpose(-1, -2).contiguous()


def twiddle_transpose(spec: FieldSpec, x: torch.Tensor,
                      tw: Twiddles | None = None) -> torch.Tensor:
    """`twiddle_transpose_plain` in one ntt_twiddle_transpose launch on the
    card (tw read in its Montgomery form)."""
    if not fops._dispatch(x):
        return twiddle_transpose_plain(spec, x, tw)
    require_eight_limbs(spec, "ntt_twiddle_transpose")
    if x.dim() < 3:
        raise ValueError(f"ntt_twiddle_transpose: x {tuple(x.shape)}")
    r, s = x.shape[-2], x.shape[-1]
    x4 = x.reshape(LIMBS, -1, r, s).contiguous()
    _cuda.check("ntt_twiddle_transpose", x4, LIMBS)
    y = torch.empty((LIMBS, *x.shape[1:-2], s, r), dtype=torch.int32,
                    device=x.device)
    if y.numel() == 0:
        return y
    mont = None
    if tw is not None:
        mont = tw.montgomery
        if tuple(mont.shape) != (LIMBS, r, s):
            raise ValueError(f"ntt_twiddle_transpose: tw {tuple(mont.shape)} "
                             f"for x {tuple(x.shape)}")
        _cuda.check("ntt_twiddle_transpose", mont, LIMBS)
    _cuda.launch("ntt_twiddle_transpose", "pt_ntt_twiddle_transpose",
                 (y, x4, mont), y.data_ptr(), x4.data_ptr(),
                 None if mont is None else mont.data_ptr(), x4.shape[1], r, s,
                 spec.kernel_consts.ctypes.data)
    return y


def fft_four_step(spec: FieldSpec, x: torch.Tensor, tw: Twiddles,
                  lg_n1: int, inverse: bool = False) -> torch.Tensor:
    """The transform of `ntt` (forward, or with `inverse` the inverse) of
    x [8, *B, n] factored as n = n1 n2 (plonky_tpu/poly/fft.py:228-262):

        X[k2 + n2 k1] = sum_i1 w_n1^(i1 k1) [w_n^(i1 k2)
                        sum_i2 w_n2^(i2 k2) C[i1, i2]],  C[i1, i2] = x[i1 + n1 i2]:

    the transpose to C, K3 over the B n1 rows of n2, the twiddle product
    with the transpose to [.., n2, n1], K3 over the B n2 rows of n1, the
    transpose back.  `tw` is four_step_twiddles(spec, n, lg_n1, inverse);
    the inverse's 1/n is the sub-transforms' 1/n2 1/n1."""
    n = x.shape[-1]
    n1 = 1 << lg_n1
    n2 = n // n1
    if n1 * n2 != n:
        raise ValueError(f"fft_four_step: n = {n}, lg_n1 = {lg_n1}")
    if tuple(tw.canonical.shape) != (LIMBS, n1, n2):
        raise ValueError(f"fft_four_step: tw {tuple(tw.canonical.shape)} for "
                         f"n1 = {n1}, n2 = {n2}")
    pre1, pre2 = FftPrecomputation(spec, n1), FftPrecomputation(spec, n2)
    c = twiddle_transpose(spec, x.reshape(*x.shape[:-1], n2, n1))  # [.., n1, n2]
    inner = ntt(pre2, c, inverse)
    y = twiddle_transpose(spec, inner, tw)                           # [.., n2, n1]
    out = twiddle_transpose(spec, ntt(pre1, y, inverse))             # [.., n1, n2]
    return out.reshape(x.shape)
