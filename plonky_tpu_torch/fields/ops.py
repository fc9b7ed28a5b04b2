"""Batched prime-field arithmetic on canonical limb tensors.

A value is an int32 tensor ``[L, *batch]`` of canonical elements, L =
``spec.limbs`` (8 or 12, see spec.py).  Operands broadcast over the batch
like torch tensors; an ``[L, 1]`` column (a challenge, a constant) is read
with a zero batch stride by the kernels, and `add`, `sub` and `mul` read
any view (a slice, a broadcast) in place through its strides where its
batch axes merge into two levels (`operand_layout`).

K1, the field kernel (csrc/field_kernels.cu), computes `add`, `sub`, `mul`
and `product_sum` / `product_sums` on CUDA tensors (`mul`: one Barrett
reduction per product, on PTX carry chains; `product_sums`: several sums
over one batch in one launch, each reduced once), and `exp_const` (and so
`inverse` and `kth_root`) as one `field_exp` launch that runs the whole
exponent chain.  Each has a build for each width (the 12-limb launches
count as `field_add_l12`, ..., `field_exp_l12`).  Beside each sits its plain PyTorch
version (`add_plain`, ...), which computes the same canonical result with
16-bit digits in int64 so that every partial product stays exact: the CPU
runs it, and the chip check compares the kernel with it.  A wrapper takes
the plain version only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..device import resolve
from .chain import exp_consts
from .host import kth_root_exponent
from .spec import LIMB_BITS, MAX_TERMS, FieldSpec, int_to_limbs

_M16 = 0xFFFF


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def _limb_matrix(spec: FieldSpec, values) -> np.ndarray:
    """Python ints -> canonical limbs as int32 [L, len(values)]."""
    p, nl = spec.p, spec.limbs
    flat = b"".join((int(v) % p).to_bytes(4 * nl, "little") for v in values)
    arr = np.frombuffer(flat, dtype="<u4").reshape(len(values), nl)
    return np.array(arr.T, order="C").view(np.int32)


def from_ints(spec: FieldSpec, values, device=None) -> torch.Tensor:
    """Python ints -> [L, len(values)] tensor (reduced mod p)."""
    return torch.from_numpy(_limb_matrix(spec, values)).to(resolve(device))


def to_ints(spec: FieldSpec, x: torch.Tensor):
    """[L, *batch] -> canonical python ints: an object array shaped like
    the batch, or an int when there is no batch."""
    arr = x.detach().cpu().contiguous().numpy().view(np.uint32)
    flat = np.ascontiguousarray(arr.reshape(spec.limbs, -1).T)
    vals = [int.from_bytes(row.tobytes(), "little") for row in flat]
    shape = tuple(x.shape[1:])
    if not shape:
        return vals[0]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out.reshape(shape)


def constant(spec: FieldSpec, v: int, batch=(), device=None) -> torch.Tensor:
    """A python int as a [L, *batch] tensor (an expanded view)."""
    nl = spec.limbs
    col = torch.from_numpy(
        int_to_limbs(v % spec.p, nl).view(np.int32).copy()).to(resolve(device))
    return col.reshape((nl,) + (1,) * len(batch)).expand(nl, *batch)


def zeros(spec: FieldSpec, batch=(), device=None) -> torch.Tensor:
    return torch.zeros((spec.limbs, *batch), dtype=torch.int32,
                       device=resolve(device))


def column(spec: FieldSpec, v: int, device) -> torch.Tensor:
    """A python int as a contiguous [L, 1] column."""
    return constant(spec, v, (1,), device).contiguous()


# ---------------------------------------------------------------------------
# Plain versions: 16-bit digits in int64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _plain_tables(spec: FieldSpec, device: torch.device):
    """p (2L + 2 digits), the Barrett factor mu = floor(2^(32 (2L + 1)) / p)
    (2L + 3 digits) and 2p (2L + 1 digits) as 16-bit digits, L =
    spec.limbs (18, 19 and 17 digits at 8 limbs).  _reduce_columns needs
    2^(16 (2L - 1)) < p < 2^(32 L - 1)."""
    nd = 2 * spec.limbs
    assert (1 << (16 * (nd - 1))) < spec.p < (1 << (16 * nd - 1)), spec.name

    def digits(v, n):
        assert 0 <= v < (1 << (16 * n)), (v, n)
        return torch.tensor([(v >> (16 * k)) & _M16 for k in range(n)],
                            dtype=torch.int64, device=device)
    p16 = digits(spec.p, nd + 2)
    mu = digits(spec.sum_mu, nd + 3)
    return p16, mu, digits(2 * spec.p, nd + 1)


@functools.lru_cache(maxsize=None)
def _diag(la: int, lb: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([i + j for i in range(la) for j in range(lb)],
                        dtype=torch.int64, device=device)


def _split16(x: torch.Tensor) -> torch.Tensor:
    """[L, N] int32 -> [2L, N] int64 16-bit digits."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & _M16, v >> 16], dim=1).reshape(2 * x.shape[0], -1)


def _join16(d: torch.Tensor) -> torch.Tensor:
    """[2L, N] digits in [0, 2^16) -> [L, N] int32."""
    v = d[0::2] | (d[1::2] << 16)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _carry(cols: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """Propagate carries (in place) until every column but the last is in
    [0, 2^16).  Columns may be negative; the last keeps the signed top.
    The first `rounds` rounds run without a check (columns below 2^48
    settle in three)."""
    body = cols[:-1]
    for i in range(4 * cols.shape[0] + 4):
        hi = body >> 16
        body.bitwise_and_(_M16)
        cols[1:] += hi
        if i + 1 >= rounds and not bool((body >> 16).any()):
            return cols
    raise AssertionError("carry propagation did not settle")


def batch_shape(*xs) -> torch.Size:
    """The broadcast batch shape of [L, *batch] operands."""
    shapes = [x.shape[1:] for x in xs]
    if all(s == shapes[0] for s in shapes[1:]):
        return shapes[0]
    return torch.broadcast_shapes(*shapes)


def _conv16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of digit vectors [la, N] x [lb, N] (or a
    [lb, 1] constant) -> [la + lb - 1, N]."""
    la, lb, n = a.shape[0], b.shape[0], a.shape[1]
    prod = (a[:, None, :] * b[None, :, :]).reshape(la * lb, n)
    out = torch.zeros((la + lb - 1, n), dtype=torch.int64, device=a.device)
    return out.index_add_(0, _diag(la, lb, a.device), prod)


@functools.lru_cache(maxsize=None)
def _pow2(n: int, device: torch.device) -> torch.Tensor:
    return (torch.ones((n, 1), dtype=torch.int64, device=device)
            << torch.arange(n, device=device)[:, None])


def _geq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x >= y for normalized digit vectors [L, N] (y may be [L, 1]): the
    sign of the most significant nonzero digit difference, read as the sign
    of sum_k sign(x_k - y_k) 2^k."""
    d = torch.sign(x - y)
    return (d * _pow2(x.shape[0], x.device)).sum(0) >= 0


def _sub_multiple(x: torch.Tensor, k: torch.Tensor, p16) -> torch.Tensor:
    """x - k p for normalized digits x >= k p (k a [N] count): borrows
    settle in a round or two, as the result is not negative."""
    d = torch.cat([x - k[None] * p16[:x.shape[0], None],
                   torch.zeros_like(x[:1])])
    return _carry(d)[:-1]


def _reduce_columns(spec: FieldSpec, s: torch.Tensor) -> torch.Tensor:
    """Columns of an integer 0 <= S < 2^T, T = 32 (2L + 1) (2^544 at 8
    limbs, 2^800 at 12), at 16-bit positions (any values that keep int64
    exact; at most 4L + 2 columns) -> S mod p as 2L normalized digits, by
    Barrett reduction: q = floor(floor(S / 2^(16 (2L - 1))) mu /
    2^(T - 16 (2L - 1))) with mu = floor(2^T / p) is at most 2 below
    floor(S / p) (as 2^(16 (2L - 1)) < p), so S - q p < 3p <
    2^(16 (2L + 1))."""
    p16, mu, p2 = _plain_tables(spec, s.device)
    nd = 2 * spec.limbs                                  # digits of a value
    n = s.shape[1]
    assert s.shape[0] <= 2 * nd + 2, s.shape
    x = _carry(torch.cat([s, s.new_zeros((2 * nd + 3 - s.shape[0], n))]), 3)
    q2 = _conv16(x[nd - 1:2 * nd + 2], mu[:, None])     # 2 nd + 5 columns
    q2 = _carry(torch.cat([q2, q2.new_zeros((1, n))]), 3)
    r2 = _conv16(q2[nd + 3:2 * nd + 6], p16[:nd, None])[:nd + 1]  # q p, low
    r = _carry(torch.cat([x[:nd + 1] - r2, x.new_zeros((1, n))]), 3)[:nd + 1]
    k = _geq(r, p16[:nd + 1, None]).long() + _geq(r, p2[:, None]).long()
    return _sub_multiple(r, k, p16)[:nd]


def _expand(x: torch.Tensor, batch) -> torch.Tensor:
    """Broadcast [L, *b] to [L, *batch] (batch axes align right)."""
    nl = x.shape[0]
    pad = len(batch) - (x.dim() - 1)
    if pad:
        x = x.reshape((nl,) + (1,) * pad + tuple(x.shape[1:]))
    return x.expand(nl, *batch)


def _flat(x: torch.Tensor, batch) -> torch.Tensor:
    return _expand(x, batch).reshape(x.shape[0], -1)


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = batch_shape(a, b)
    nl = spec.limbs
    p16 = _plain_tables(spec, a.device)[0][:2 * nl]
    s = _split16(_flat(a, batch)) + _split16(_flat(b, batch))
    s = _carry(torch.cat([s, torch.zeros_like(s[:1])]))[:-1]
    s = _sub_multiple(s, _geq(s, p16[:, None]).long(), p16)
    return _join16(s).reshape(nl, *batch)


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = batch_shape(a, b)
    nl = spec.limbs
    p16 = _plain_tables(spec, a.device)[0][:2 * nl]
    a16, b16 = _split16(_flat(a, batch)), _split16(_flat(b, batch))
    wrap = (~_geq(a16, b16)).long()             # a < b: add p
    d = torch.cat([a16 - b16 + wrap[None] * p16[:, None],
                   torch.zeros_like(a16[:1])])
    return _join16(_carry(d)[:-1]).reshape(nl, *batch)


def product_sum_plain(spec: FieldSpec, terms) -> torch.Tensor:
    """sum_i sign_i a_i b_i mod p; terms: (a, b or None, sign)."""
    batch = batch_shape(*[a for a, _b, _s in terms],
                        *[b for _a, b, _s in terms if b is not None])
    dev = terms[0][0].device
    nl = spec.limbs
    nd = 2 * nl
    p16 = _plain_tables(spec, dev)[0][:nd]
    n = int(np.prod(batch)) if batch else 1
    # a negative product enters as p 2^(32 L) - a b: S < 32 p 2^(32 L)
    s = torch.zeros((2 * nd + 1, n), dtype=torch.int64, device=dev)
    for a, b, sign in terms:
        a16 = _split16(_flat(a, batch))
        if b is None:
            if sign >= 0:
                s[:nd] += a16
            else:
                s[:nd] += p16[:, None] - a16
        else:
            c = _conv16(a16, _split16(_flat(b, batch)))
            if sign >= 0:
                s[:2 * nd - 1] += c
            else:
                s[nd:2 * nd] += p16[:, None]
                s[:2 * nd - 1] -= c
    return _join16(_reduce_columns(spec, s)).reshape(nl, *batch)


def product_sums_plain(spec: FieldSpec, sums) -> list:
    """product_sum_plain of each term list of `sums`."""
    return [product_sum_plain(spec, terms) for terms in sums]


def mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return product_sum_plain(spec, [(a, b, 1)])


# ---------------------------------------------------------------------------
# Kernel wrappers (K1)
# ---------------------------------------------------------------------------

def _operand(x: torch.Tensor, batch) -> tuple:
    """(contiguous tensor, zero-stride flag) for one kernel operand."""
    if x[0].numel() == 1:
        return x.reshape(x.shape[0], 1).contiguous(), 1
    return _expand(x, batch).contiguous(), 0


def operand_layout(sizes, strides) -> tuple | None:
    """(outer stride, inner stride, inner size) of a batch index of at most
    two levels that walks batch axes of `sizes` and `strides` (row-major,
    in elements) as the elementwise kernel reads an operand in place:
    element i at (i // inner size) * outer + (i % inner size) * inner.
    Axes merge as TensorIterator coalesces them (an axis of size 1 drops
    out; an axis merges into the next when its stride is the next one's
    size times its stride, so broadcast axes merge with each other); None
    where more than two levels remain.  Raises on a negative stride."""
    if any(s < 0 for s in strides):
        raise ValueError(f"negative stride in {tuple(strides)}")
    levels = []
    for n, s in zip(sizes, strides):
        if n == 1:
            continue
        if levels and levels[-1][1] == n * s:
            levels[-1] = (levels[-1][0] * n, s)
        else:
            levels.append((n, s))
    if len(levels) > 2:
        return None
    if len(levels) < 2:
        n, s = levels[0] if levels else (1, 0)
        return 0, s, n
    (_no, so), (ni, si) = levels
    return so, si, ni


def layout_reads(x: torch.Tensor, layout, n: int) -> int:
    """The largest element offset from x's first element that the kernel
    reads: the last limb row at the last element of n."""
    outer, inner, inner_n = layout
    return ((x.shape[0] - 1) * x.stride(0) + (n // inner_n - 1) * outer
            + (inner_n - 1) * inner)


def _binary_operand(name: str, spec: FieldSpec, x: torch.Tensor, batch,
                    n: int) -> tuple:
    """(tensor, layout) of one elementwise operand broadcast to [L,
    *batch]: the view itself, read in place, or a contiguous copy (counted
    in _cuda.COPIES) where its batch axes do not fit two levels."""
    x = _expand(x, batch)
    layout = operand_layout(x.shape[1:], x.stride()[1:])
    if layout is None:
        _cuda.COPIES[name] += 1
        x = x.contiguous()
        layout = operand_layout(x.shape[1:], x.stride()[1:])
    _cuda.check(name, x, spec.limbs, reads=layout_reads(x, layout, n))
    return x, layout


def _launch_binary(kernel: str, spec: FieldSpec, a, b):
    """One launch of field_add / field_sub / field_mul at the field's
    width, its operands read in place (_binary_operand)."""
    name, entry = _cuda.kernel(kernel, spec.limbs)
    batch = batch_shape(a, b)
    out = torch.empty((spec.limbs, *batch), dtype=torch.int32, device=a.device)
    n = out[0].numel()
    if n == 0:
        return out
    operands = [_binary_operand(name, spec, x, batch, n) for x in (a, b)]
    words = _cuda.host_array([w for x, layout in operands
                              for w in (x.data_ptr(), x.stride(0), *layout)],
                             np.int64)
    _cuda.launch(name, entry, (out, *(x for x, _l in operands)), out.data_ptr(),
                 words.ctypes.data, n, spec.mul_consts.ctypes.data)
    return out


def _dispatch(a: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version (CPU tensors)."""
    if a.device.type == "cpu":
        return False
    if a.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {a.device}")


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _dispatch(a):
        return add_plain(spec, a, b)
    return _launch_binary("field_add", spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _dispatch(a):
        return sub_plain(spec, a, b)
    return _launch_binary("field_sub", spec, a, b)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _dispatch(a):
        return mul_plain(spec, a, b)
    return _launch_binary("field_mul", spec, a, b)


# The product-sum launch's limits and term flags (csrc/field_kernels.cu).
PS_MAX_SUMS = 16          # sums of one launch
PS_MAX_ENTRIES = 64       # terms of one launch, all its sums together
PS_MAX_SPLITS = 4         # threads that share one element of a sum
PS_A_BCAST, PS_B_BCAST, PS_NEG = 1, 2, 4
# Threads a launch should have per SM before its sums' terms are dealt out
# among several threads an element (16 warps).
_FILL_PER_SM = 512


@functools.lru_cache(maxsize=None)
def _fill_threads(device: torch.device) -> int:
    return _FILL_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count


def _sums_batch(sums):
    """The batch of a list of term lists: every sum must have the same."""
    batches = [batch_shape(*[x for a, b, _s in terms for x in (a, b)
                             if x is not None]) for terms in sums]
    if any(b != batches[0] for b in batches[1:]):
        raise ValueError(f"product_sums: the sums' batches differ: {batches}")
    return batches[0]


def _splits(threads: int, most_terms: int, fill: int) -> int:
    """Threads an element: 1, or 2 or 4 (no more than the most terms of a
    sum) where the launch has fewer than `fill` threads and a sum has more
    than 2 terms (chosen from sweeps on the H100, which showed a gain from
    3 terms on and none at 2; PERF.md)."""
    if most_terms <= 2:
        return 1
    k = 1
    while k < PS_MAX_SPLITS and threads * k < fill and k < most_terms:
        k *= 2
    return k


def _product_sums_launch(spec: FieldSpec, sums, batch, splits=None) -> list:
    """One launch of field_product_sum (at the field's width) for up to
    PS_MAX_SUMS sums of at most MAX_TERMS terms each (PS_MAX_ENTRIES in
    all) over `batch`."""
    name, entry = _cuda.kernel("field_product_sum", spec.limbs)
    dev = sums[0][0][0].device
    out = torch.empty((len(sums), spec.limbs, *batch), dtype=torch.int32,
                      device=dev)
    n = out[0, 0].numel()
    if n == 0:
        return list(out)
    keep, a_ptrs, b_ptrs, flags, first = [], [], [], [], [0]
    for terms in sums:
        for a, b, sign in terms:
            ta, fa = _operand(a, batch)
            _cuda.check(name, ta, spec.limbs)
            keep.append(ta)
            a_ptrs.append(ta.data_ptr())
            flag = (PS_A_BCAST if fa else 0) | (PS_NEG if sign < 0 else 0)
            if b is None:
                b_ptrs.append(0)
            else:
                tb, fb = _operand(b, batch)
                _cuda.check(name, tb, spec.limbs)
                keep.append(tb)
                b_ptrs.append(tb.data_ptr())
                flag |= PS_B_BCAST if fb else 0
            flags.append(flag)
        first.append(len(a_ptrs))
    if splits is None:
        splits = _splits(n * len(sums), max(len(t) for t in sums),
                         _fill_threads(dev))
    bufs = [_cuda.host_array(a_ptrs, np.uint64),
            _cuda.host_array(b_ptrs, np.uint64),
            _cuda.host_array(flags, np.int32), _cuda.host_array(first, np.int32)]
    _cuda.launch(name, entry, (out, *keep),
                 out.data_ptr(), *[buf.ctypes.data for buf in bufs], len(sums),
                 splits, n, spec.mul_consts.ctypes.data)
    return list(out)


def product_sums(spec: FieldSpec, sums) -> list:
    """[sum_i sign_i a_i b_i mod p for each term list of `sums`] over one
    batch (b None: the term is sign_i a_i): as many sums as fit in one
    launch (PS_MAX_SUMS sums, PS_MAX_ENTRIES terms), each reduced once per
    MAX_TERMS terms.  sums: list of lists of (a, b, sign)."""
    sums = [list(terms) for terms in sums]
    batch = _sums_batch(sums)
    if not _dispatch(sums[0][0][0]):
        return product_sums_plain(spec, sums)
    chunks = [(k, terms[i:i + MAX_TERMS]) for k, terms in enumerate(sums)
              for i in range(0, len(terms), MAX_TERMS)]
    out = [None] * len(sums)
    group = []

    def flush():
        parts = _product_sums_launch(spec, [c for _k, c in group], batch)
        for (k, _c), part in zip(group, parts):
            out[k] = part if out[k] is None else add(spec, out[k], part)
        group.clear()

    for chunk in chunks:
        if group and (len(group) == PS_MAX_SUMS or sum(
                len(c) for _k, c in group) + len(chunk[1]) > PS_MAX_ENTRIES):
            flush()
        group.append(chunk)
    flush()
    return out


def product_sum(spec: FieldSpec, terms) -> torch.Tensor:
    """sum_i sign_i a_i b_i  (b None: the term is sign_i a_i), mod p, with
    one reduction per MAX_TERMS terms.  terms: list of (a, b, sign)."""
    return product_sums(spec, [terms])[0]


# ---------------------------------------------------------------------------
# Composite ops
# ---------------------------------------------------------------------------

def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((spec.limbs,) + (1,) * (a.dim() - 1), dtype=a.dtype,
                       device=a.device)
    return sub(spec, zero, a)


def square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mul(spec, a, a)


def mul_small(spec: FieldSpec, a: torch.Tensor, c: int) -> torch.Tensor:
    return mul(spec, a, column(spec, c, a.device))


def _mont_factors(spec: FieldSpec):
    """(R mod p, R^-1 mod p) for R = 2^(32 L)."""
    r = pow(2, 32 * spec.limbs, spec.p)
    return r, pow(r, -1, spec.p)


def to_montgomery(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Canonical x -> x 2^(32 L) mod p (canonical limbs of the Montgomery
    form), the form the curve and NTT kernels read their tables in."""
    return mul_small(spec, x, _mont_factors(spec)[0])


def from_montgomery(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical x."""
    return mul_small(spec, x, _mont_factors(spec)[1])


def sum_reduce(spec: FieldSpec, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum along a batch axis (axis 0 is the first batch axis) by a halving
    tree of adds."""
    dim = axis + 1
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        lo = x.narrow(dim, 0, half)
        hi = x.narrow(dim, half, half)
        s = add(spec, lo, hi)
        if n % 2:
            s = torch.cat([s, x.narrow(dim, n - 1, 1)], dim=dim)
        x = s
    return x.squeeze(dim)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select over the batch (mask shaped like the batch)."""
    return torch.where(mask.to(torch.bool)[None], a, b)


def exp_const_plain(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """field_exp's plain version: x^e for e > 0, left-to-right square and
    multiply over the plain products (reference semantics:
    src/field/field.rs:309-331 `exp`)."""
    acc = x
    for bit in bin(e)[3:]:
        acc = mul_plain(spec, acc, acc)
        if bit == "1":
            acc = mul_plain(spec, acc, x)
    return acc


def _launch_exp(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """One launch of field_exp (at the field's width): x^e for e > 0 over
    the whole batch of x, the chain of fields/chain.py:exp_consts."""
    name, entry = _cuda.kernel("field_exp", spec.limbs)
    xin = x.reshape(spec.limbs, -1).contiguous()
    _cuda.check(name, xin, spec.limbs)
    out = torch.empty_like(xin)
    n = xin.shape[1]
    if n:
        consts = exp_consts(spec, e)
        _cuda.launch(name, entry, (out, xin), out.data_ptr(), xin.data_ptr(), n,
                     consts.ctypes.data)
    return out.reshape(x.shape)


def exp_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a python-int exponent: 1 for e = 0 (made on the host); else
    one field_exp launch on a CUDA tensor, exp_const_plain on a CPU one."""
    assert e >= 0
    if e == 0:
        return constant(spec, 1, x.shape[1:], x.device).contiguous()
    if not _dispatch(x):
        return exp_const_plain(spec, x, e)
    return _launch_exp(spec, x, e)


def exp_dyn(spec: FieldSpec, x: torch.Tensor, e_bits: torch.Tensor) -> torch.Tensor:
    """x^e with e given on the device, little-endian bits [nbits, *batch]
    (0/1): right-to-left square and multiply, every bit's product taken
    and kept where the bit is set."""
    acc = constant(spec, 1, x.shape[1:], x.device).contiguous()
    cur = x
    for i, bit in enumerate(e_bits):
        acc = select(bit, mul(spec, acc, cur), acc)
        if i + 1 < len(e_bits):
            cur = square(spec, cur)
    return acc


def inverse(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) (Fermat); inverse(0) = 0, which the prover relies on."""
    return exp_const(spec, x, spec.p - 2)


def kth_root(spec: FieldSpec, x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(1/k) where x -> x^k is a permutation: one exponentiation by the
    host's exponent, the root the reference picks (src/field/field.rs:
    346-375)."""
    return exp_const(spec, x, kth_root_exponent(spec, k))


def is_zero(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(dim=0)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def to_bits(spec: FieldSpec, x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Little-endian bits [n_bits, *batch] (int64 0/1) of x."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(n_bits, device=x.device)
    shifts = (idx % LIMB_BITS).reshape((n_bits,) + (1,) * (x.dim() - 1))
    return (v[idx // LIMB_BITS] >> shifts) & 1
