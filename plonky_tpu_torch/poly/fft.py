"""Batched radix-2 FFT over prime fields (the reference's src/fft.rs).

Values are [L, ..., n] tensors (L = spec.limbs, 8 or 12) with the domain
axis last.  A transform is the input in bit-reversed order followed by
lg n butterfly layers; layer ell (half-size m = 2^ell) maps the pair
(pos, pos + m), j = pos mod m, to (e + o w_m^j, e - o w_m^j).

K3, the NTT kernel (csrc/ntt_kernels.cu), runs a whole transform on CUDA
tensors in len(pass_plan(lg n, limbs=L)) launches of `ntt_pass`: each
pass runs up to the width's layers a pass (NTT_MAX_LAYERS at 8 limbs,
NTT_L12_MAX_LAYERS at 12) on groups of elements held in shared memory,
the first pass loading through the bit reversal (and multiplying by
shift^i for a coset transform), the last multiplying by the inverse's
scale.  `ntt_plain` is its plain PyTorch version: the same passes, groups,
positions and twiddle indices (`_pass_groups`, `_twiddle_index`) at the
field's width, with canonical twiddles where the kernel holds them in
Montgomery form, and canonical values throughout where the 12-limb kernel
keeps them lazily below 2p (lg n + 1) inside a transform (its outputs are
canonical: `lazy_ntt_fits`).  `fft`, `ifft`, `lde`, `coset_fft` and
`coset_ifft` take the plain version only for CPU tensors.  Both kernels
have a build at each width: a 12-limb field (BLS12-377's base field)
launches `ntt_pass_l12` and `ntt_twiddle_transpose_l12`, with tables held
as v 2^384 mod p.

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
from ..fields.spec import FieldSpec
from ..utils import log2_strict

# Layers of one ntt_pass launch, and elements of one block's groups, from a
# sweep on the H100 at each width (PERF.md; ntt_sweep.py at 12 limbs).
# csrc/ntt_kernels.cu defines the same values (NTT_* at 8 limbs, NTT_L12_*
# at 12) and checks each launch against them.
NTT_MAX_LAYERS = 7
NTT_BLOCK_ELEMS = 512
NTT_L12_MAX_LAYERS = 7
NTT_L12_BLOCK_ELEMS = 1024


def ntt_shape(limbs: int = 8) -> tuple:
    """(layers a pass at most, elements a block at most) of ntt_pass at a
    field width."""
    if limbs == 8:
        return NTT_MAX_LAYERS, NTT_BLOCK_ELEMS
    if limbs == 12:
        return NTT_L12_MAX_LAYERS, NTT_L12_BLOCK_ELEMS
    raise NotImplementedError(f"ntt_pass has no {limbs}-limb build")


def lazy_ntt_fits(spec: FieldSpec, lg: int) -> bool:
    """Whether the 12-limb ntt_pass can run a transform of 2^lg points
    over `spec` (csrc/ntt_kernels.cu, its 12-limb section): its values stay
    below 2p (lg + 1) inside a transform, which must fit 384 bits, and its
    last store reduces them with a quotient from p's top limb p_11, which
    must be large: 2 (lg + 1) (p_11 + 1) <= 2^32 and p_11 >= 2^17.  Every
    8-limb field fits (that kernel reduces every value)."""
    if spec.limbs == 8:
        return True
    top = spec.p >> (32 * (spec.limbs - 1))
    return top >= 1 << 17 and 2 * (lg + 1) * (top + 1) <= 1 << 32


@functools.lru_cache(maxsize=None)
class FftPrecomputation:
    """Twiddle and scale tables for a size-n FFT over `spec` (n a power of
    two); the reference's FftPrecomputation (src/fft.rs:28-59).  Tables are
    made once per device and form, canonical or Montgomery (v 2^(32 L) mod
    p, one K1 multiply on the card), all on the device by K1: a
    Python-int build of both directions' [8, n - 1] tables and their first
    transforms took 15 s at n = 2^22 on the host of an H100 machine, and
    of one 12-limb coset table 1.24 s at n = 2^20."""

    def __init__(self, spec: FieldSpec, n: int):
        self.spec = spec
        self.n = n
        self.lg_n = log2_strict(n)
        self.g = fhost.primitive_root_of_unity(spec, self.lg_n)
        self.g_inv = pow(self.g, -1, spec.p)
        self.n_inv = pow(n, -1, spec.p)
        self._tables = {}

    def _table(self, key, device, montgomery: bool, make):
        """The canonical [L, len] table `make(device)`, or its
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
        device by K1 (`powers_dyn`, then one product by the scale's
        column where it is not 1)."""
        spec = self.spec

        def make(device):
            pw = powers_dyn(spec, fops.column(spec, base, device), self.n)
            if scale % spec.p != 1:
                pw = fops.mul(spec, pw, fops.column(spec, scale, device))
            return pw
        return make

    def twiddles(self, device, inverse: bool = False,
                 montgomery: bool = False) -> torch.Tensor:
        """[L, n - 1]: layer ell (half-size m = 2^ell) holds [w^j, j <
        m], w = g^(n / 2m), from column m - 1.  Built on `device` from the
        powers g^i, i < n / 2 (`powers_dyn`, lg n - 1 doubling steps of
        K1), of which layer m takes every (n / 2m)-th."""
        def make(device):
            half = self.n // 2
            if half == 0:
                return fops.zeros(self.spec, (0,), device)
            root = self.g_inv if inverse else self.g
            pw = powers_dyn(self.spec, fops.column(self.spec, root, device), half)
            return torch.cat([pw[:, ::half >> ell] for ell in range(self.lg_n)],
                             dim=1)
        return self._table(("tw", bool(inverse)), device, montgomery, make)

    def coset_powers(self, device, shift: int,
                     montgomery: bool = False) -> torch.Tensor:
        """[L, n]: shift^i, the coset transform's input scale."""
        return self._table(("coset", shift % self.spec.p), device, montgomery,
                           self._powers(shift))

    def inverse_scale(self, device, shift=None,
                      montgomery: bool = False) -> torch.Tensor:
        """The inverse transform's output scale: n^-1 as [L, 1], or
        n^-1 shift^-i as [L, n] for the inverse coset transform."""
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


def pass_plan(lg: int, max_layers: int | None = None, limbs: int = 8):
    """The passes of a transform of 2^lg points: [(first layer, layer
    count)], as few as max_layers (by default the width's layers a pass,
    ntt_shape) allows, the layers spread evenly (the earlier passes take
    the extra one)."""
    if max_layers is None:
        max_layers = ntt_shape(limbs)[0]
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


def block_groups(batch: int, lg: int, kp: int, limbs: int = 8) -> int:
    """lg of the groups of 2^kp elements one ntt_pass block holds: as many
    as the width's elements a block (ntt_shape) allow, and no more than the
    pass's batch 2^(lg - kp) groups round up to."""
    groups = batch << (lg - kp)
    return max(0, min(log2_strict(ntt_shape(limbs)[1]) - kp,
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
              shift=None, max_layers: int | None = None) -> torch.Tensor:
    """The transform of `ntt`, pass by pass as the kernel runs it (the
    field width's plan unless max_layers is given), with the plain field
    ops: fft (shift None) or coset_fft, or with `inverse`, ifft or
    coset_ifft."""
    spec, n, lg = pre.spec, pre.n, pre.lg_n
    assert x.shape[-1] == n, (x.shape, n)
    shape, dev = x.shape, x.device
    y = x.reshape(spec.limbs, -1, n)
    if lg == 0 or y.shape[1] == 0:
        return y.clone().reshape(shape)
    tw = pre.twiddles(dev, inverse)
    pre_tab = (pre.coset_powers(dev, shift)
               if shift is not None and not inverse else None)
    post = pre.inverse_scale(dev, shift) if inverse else None
    plan = pass_plan(lg, max_layers, spec.limbs)
    for i, (l0, kp) in enumerate(plan):
        src, dst = _pass_groups(lg, l0, kp, dev)
        v = y[:, :, src]                               # [L, B, Q, S]
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
    (at the field's width) per pass of pass_plan, into a new tensor.
    Raises where the 12-limb kernel's lazy values would not fit
    (`lazy_ntt_fits`)."""
    if not fops._dispatch(x):
        return ntt_plain(pre, x, inverse, shift)
    spec, n, lg = pre.spec, pre.n, pre.lg_n
    if x.shape[-1] != n:
        raise ValueError(f"ntt: x {tuple(x.shape)} for n = {n}")
    if not lazy_ntt_fits(spec, lg):
        raise ValueError(f"ntt: {spec.name} at n = 2^{lg} leaves the 12-limb "
                         "kernel's lazy bound")
    name, entry = _cuda.kernel("ntt_pass", spec.limbs)
    shape, dev = x.shape, x.device
    x3 = x.reshape(spec.limbs, -1, n).contiguous()
    _cuda.check(name, x3, spec.limbs)
    batch = x3.shape[1]
    if lg == 0 or batch == 0:
        return x3.clone().reshape(shape)
    tw = pre.twiddles(dev, inverse, montgomery=True)
    pre_tab = (pre.coset_powers(dev, shift, montgomery=True)
               if shift is not None and not inverse else None)
    post = pre.inverse_scale(dev, shift, montgomery=True) if inverse else None
    y = torch.empty_like(x3)
    src = x3
    plan = pass_plan(lg, limbs=spec.limbs)
    for i, (l0, kp) in enumerate(plan):
        lg_groups = block_groups(batch, lg, kp, spec.limbs)
        last = i == len(plan) - 1
        _cuda.launch(
            name, entry, (y, src, tw, pre_tab, post), y.data_ptr(),
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
    """[base^0 .. base^(n-1)] as [L, *B, n] from [L, *B, 1] device
    bases: a doubling construction, log2(n) batched multiplies."""
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
    [L, r, s], the API's and the plain version's, and `montgomery` (w
    2^(32 L) mod p), which ntt_twiddle_transpose reads."""
    canonical: torch.Tensor
    montgomery: torch.Tensor

    @classmethod
    def of(cls, spec: FieldSpec, canonical: torch.Tensor) -> Twiddles:
        canonical = canonical.contiguous()
        return cls(canonical, fops.to_montgomery(spec, canonical))


@functools.lru_cache(maxsize=8)
def _four_step_table(spec: FieldSpec, n: int, lg_n1: int, inverse: bool,
                     device: torch.device) -> Twiddles:
    n1 = 1 << lg_n1
    n2 = n // n1
    if n1 * n2 != n or n2 < 1:
        raise ValueError(f"four_step_twiddles: n = {n}, lg_n1 = {lg_n1}")
    g = fhost.primitive_root_of_unity(spec, log2_strict(n))
    if inverse:
        g = pow(g, -1, spec.p)
    bases = powers_dyn(spec, fops.column(spec, g, device), n1)      # [L, n1]
    acc = fops.constant(spec, 1, (n1, 1), device).contiguous()       # [L, n1, 1]
    top = bases[..., None]           # invariant: top = base^(width of acc)
    while acc.shape[-1] < n2:
        acc = torch.cat([acc, fops.mul(spec, acc, top)], dim=-1)
        if acc.shape[-1] < n2:
            top = fops.square(spec, top)
    return Twiddles.of(spec, acc)


def four_step_twiddles(spec: FieldSpec, n: int, lg_n1: int,
                       inverse: bool = False, device=None) -> Twiddles:
    """The four-step FFT's middle table w_n^(+-i1 k2), [L, n1, n2] (n1 =
    2^lg_n1, n2 = n / n1); plonky_tpu/poly/fft.py:204-225.  Built on
    `device` (the card unless the CPU is asked for) by the same doubling:
    the bases w_n^i1 (`powers_dyn`), then lg n2 batched K1 multiplies
    along k2.  The eight latest tables are cached (256 MiB a table on the
    card at n = 2^22 and 8 limbs, 384 MiB at 12)."""
    return _four_step_table(spec, n, lg_n1, bool(inverse), resolve(device))


def twiddle_transpose_plain(spec: FieldSpec, x: torch.Tensor,
                            tw: Twiddles | None = None) -> torch.Tensor:
    """x [L, *B, r, s] (times tw [L, r, s] when given) with its last two
    axes swapped: [L, *B, s, r]."""
    if tw is not None:
        x = fops.mul_plain(spec, x, tw.canonical)
    return x.transpose(-1, -2).contiguous()


def twiddle_transpose(spec: FieldSpec, x: torch.Tensor,
                      tw: Twiddles | None = None) -> torch.Tensor:
    """`twiddle_transpose_plain` in one ntt_twiddle_transpose launch (at the
    field's width) on the card (tw read in its Montgomery form)."""
    if not fops._dispatch(x):
        return twiddle_transpose_plain(spec, x, tw)
    name, entry = _cuda.kernel("ntt_twiddle_transpose", spec.limbs)
    nl = spec.limbs
    if x.dim() < 3:
        raise ValueError(f"{name}: x {tuple(x.shape)}")
    r, s = x.shape[-2], x.shape[-1]
    x4 = x.reshape(nl, -1, r, s).contiguous()
    _cuda.check(name, x4, nl)
    y = torch.empty((nl, *x.shape[1:-2], s, r), dtype=torch.int32,
                    device=x.device)
    if y.numel() == 0:
        return y
    mont = None
    if tw is not None:
        mont = tw.montgomery
        if tuple(mont.shape) != (nl, r, s):
            raise ValueError(f"{name}: tw {tuple(mont.shape)} "
                             f"for x {tuple(x.shape)}")
        _cuda.check(name, mont, nl)
    _cuda.launch(name, entry, (y, x4, mont), y.data_ptr(), x4.data_ptr(),
                 None if mont is None else mont.data_ptr(), x4.shape[1], r, s,
                 spec.kernel_consts.ctypes.data)
    return y


def fft_four_step(spec: FieldSpec, x: torch.Tensor, tw: Twiddles,
                  lg_n1: int, inverse: bool = False) -> torch.Tensor:
    """The transform of `ntt` (forward, or with `inverse` the inverse) of
    x [L, *B, n] factored as n = n1 n2 (plonky_tpu/poly/fft.py:228-262):

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
    if tuple(tw.canonical.shape) != (spec.limbs, n1, n2):
        raise ValueError(f"fft_four_step: tw {tuple(tw.canonical.shape)} for "
                         f"n1 = {n1}, n2 = {n2}")
    pre1, pre2 = FftPrecomputation(spec, n1), FftPrecomputation(spec, n2)
    c = twiddle_transpose(spec, x.reshape(*x.shape[:-1], n2, n1))  # [.., n1, n2]
    inner = ntt(pre2, c, inverse)
    y = twiddle_transpose(spec, inner, tw)                           # [.., n2, n1]
    out = twiddle_transpose(spec, ntt(pre1, y, inverse))             # [.., n1, n2]
    return out.reshape(x.shape)
