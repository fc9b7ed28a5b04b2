"""Multi-scalar multiplication (Pippenger) over a typed, precomputed basis.

Pipeline for scalars [Ls, *B, N] (Ls = curve.scalar.limbs) against an
N-point basis of base-field coordinates [L, N] (L = curve.base.limbs: 8 on
the Tweedle curves, 12 on BLS12-377; the kernels have a build for each):
  1. c-bit window digits of every scalar (torch); with `signed`, the
     signed-window recoding: digits in [-2^(c-1), 2^(c-1)] over one window
     more, as magnitudes and signs (`scalar_window_digits_signed`),
  2. one stable argsort per (scalar, window) row and the start of every
     bucket's run in the sorted order (torch; `window_rows`),
  3. bucket sums (K4 accumulation kernel): one thread per chunk of CHUNK
     sorted positions sums the pieces of the runs in its chunk; runs that
     cross chunks are merged by a tree over the `tile_for(L)` chunks of a
     block, and runs that cross blocks leave one carry per block; signed,
     `msm_bucket_accumulate_signed` negates Y of a point whose digit is
     negative as it gathers it,
  4. window sums  sum_j j B_j  (K4 reduction kernel): the carries are added
     to their buckets, segments of `reduce_seg(nb)` buckets are reduced by
     running sums in parallel and then combined,
  5. Horner across windows: c doublings and one add per window, the
     whole chain of every MSM in one launch, one warp per MSM (K2's
     `curve_horner`, csrc/curve_kernels.cu; `horner_plain` is its plain
     version, today's loop over `double_plain` / `add_plain`).

Steps 3 and 4 keep the points in Montgomery form (x 2^(32 L) mod p; the
basis keeps a point-major copy in that form, `MsmBasis.mont`), and step 4
converts its output back to canonical coordinates.  K4 lives in
csrc/msm_kernels.cu; `bucket_accumulate_plain` and `bucket_reduce_plain`
are its plain PyTorch versions, taken only for CPU tensors: they add the
same points in the same grouping as the kernels, so their outputs equal
the kernels' word for word.  The result is a projective point
[L, *B]; only its affine value is defined (it matches the reference's
MSM, not its coordinates).  `msm_chunked` sums the MSMs of 2^chunk_log
slices of the basis with K2's `curve_add` (the JAX package's bench entry
point for BLS12-377).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _cuda
from ..fields import ops as fops
from ..fields.spec import FieldSpec
from . import ops as cops
from .spec import CurveSpec


CHUNK = 32           # sorted positions per accumulation thread
TILE = 128           # chunks per accumulation block at 8 limbs (MSM_TILE)
WIDE_TILE = 64       # the same at 12 limbs (36-word points)
SEG = 16             # least buckets per segment of the reduction
REDUCE_LANES = 32    # most segments of a row: one warp lane each (MSM_WARP)
SIGN_BIT = -(1 << 31)  # bit 31 of an `order` word: the point enters negated


def tile_for(limbs: int) -> int:
    """Chunks per accumulation block at a base-field width: the kernel's
    MSM_TILE, which keeps its static shared memory (4 points a thread)
    within 48 KB: 128 x 4 x 96 bytes at 8 limbs, 64 x 4 x 144 at 12."""
    return TILE if limbs == 8 else WIDE_TILE


def reduce_seg(nb: int) -> int:
    """Buckets per segment of the reduction for nb buckets a row: the
    smallest power of two from SEG up with ceil((nb - 1) / seg) segments
    within the kernel's REDUCE_LANES (16 up to c = 9 unsigned; 32 at
    c = 10, 128 at c = 12; 64 at signed c = 12, nb = 2049)."""
    seg = SEG
    while -(-(nb - 1) // seg) > REDUCE_LANES:
        seg *= 2
    return seg


def words(curve: CurveSpec) -> int:
    """Words of a point-major Montgomery point: X, Y, Z limbs (24 or 36)."""
    return 3 * curve.base.limbs


@dataclass(frozen=True, eq=False)
class MsmBasis:
    """A fixed MSM basis: canonical projective coordinates [L, N] on one
    device, and the same points point-major in Montgomery form,
    [N, words(curve)] (what the accumulation kernel gathers).  `msm` takes
    nothing else, so a commitment can never be made against an unchecked
    array (the reference took any uint8 input as canonical)."""
    curve: CurveSpec
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    mont: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def slice(self, lo: int, hi: int) -> "MsmBasis":
        """Points lo .. hi - 1 as a basis (views, no copy; the Montgomery
        rows stay 16-byte aligned)."""
        return MsmBasis(self.curve, self.x[:, lo:hi], self.y[:, lo:hi],
                        self.z[:, lo:hi], self.mont[lo:hi])


def precompute_base(curve: CurveSpec, points: cops.Point) -> MsmBasis:
    """Contiguous [L, N] copies of a point batch and their point-major
    Montgomery copy as an MsmBasis."""
    x, y, z = (t.reshape(curve.base.limbs, -1).contiguous() for t in points)
    assert x.shape == y.shape == z.shape
    return MsmBasis(curve, x, y, z, pack_points(curve, (x, y, z)))


def scalar_window_digits(spec: FieldSpec, scalars: torch.Tensor,
                         c: int) -> torch.Tensor:
    """Canonical scalars [Ls, *B, N] -> window digits [W, *B, N] (int64,
    least significant window first), W = ceil(bits / c)."""
    n_windows = -(-spec.bits // c)
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros_like(v[:1])])          # a zero limb on top
    start = torch.arange(n_windows, device=scalars.device) * c
    limb, shift = start // 32, start % 32
    view = (n_windows,) + (1,) * (scalars.dim() - 1)
    lo = v[limb] >> shift.reshape(view)
    hi = (v[limb + 1] << (32 - shift).reshape(view)) & 0xFFFFFFFF
    return (lo | hi) & ((1 << c) - 1)


def scalar_window_digits_signed(spec: FieldSpec, scalars: torch.Tensor,
                                c: int):
    """Canonical scalars [Ls, *B, N] -> (magnitudes, signs), each
    [W + 1, *B, N] (int64; signs +1 or -1), W = ceil(bits / c): the
    signed-window recoding of plonky_tpu/curves/msm.py:49-72.  Window by
    window from the least significant, t = digit + carry; t >= 2^(c-1)
    becomes the digit t - 2^c (magnitude 2^c - t, sign -1) and carries one
    into the next window, so magnitudes lie in [0, 2^(c-1)]; the extra top
    window takes the last carry.  sum_w sign_w mag_w 2^(c w) is the
    scalar.

    The carries are found for all windows at once, as a carry-lookahead:
    a window whose digit is at least 2^(c-1) carries out whatever comes
    in, one whose digit is 2^(c-1) - 1 passes its carry in on, and any
    other stops it; so window w carries out what the last window up to w
    that is not a pass-on decides (cummax over window indices), in a
    fixed number of torch ops rather than a loop over the windows."""
    d = scalar_window_digits(spec, scalars, c)
    d = torch.cat([d, torch.zeros_like(d[:1])])          # the extra window
    half, full = 1 << (c - 1), 1 << c
    idx = torch.arange(d.shape[0], device=d.device).reshape(
        (-1,) + (1,) * (d.dim() - 1))
    last = torch.where(d != half - 1, idx, -1).cummax(dim=0).values
    carry_out = (last >= 0) & (torch.gather(d, 0, last.clamp(min=0)) >= half)
    t = d + torch.cat([torch.zeros_like(d[:1]), carry_out[:-1].to(d.dtype)])
    return (torch.where(carry_out, full - t, t),
            torch.where(carry_out, -1, 1))


def _run_starts(sorted_digits: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[R, N] sorted digits -> [R, n_buckets + 1] int32 run starts."""
    ids = torch.arange(n_buckets + 1, device=sorted_digits.device)
    ids = ids.expand(sorted_digits.shape[0], -1).contiguous()
    return torch.searchsorted(sorted_digits.contiguous(), ids).to(torch.int32)


def pack_points(curve: CurveSpec, pt: cops.Point) -> torch.Tensor:
    """Canonical [L, M] coordinates -> [M, 3L] point-major Montgomery
    words (X, Y, Z limbs of point m in row m)."""
    m, nl = pt[0].shape[1], curve.base.limbs
    if m == 0:
        return torch.zeros((0, 3 * nl), dtype=torch.int32, device=pt[0].device)
    mont = fops.to_montgomery(curve.base, torch.cat(pt, dim=1))
    return mont.reshape(nl, 3, m).permute(2, 1, 0).reshape(m, 3 * nl).contiguous()


def unpack_points(curve: CurveSpec, packed: torch.Tensor) -> cops.Point:
    """[M, 3L] point-major Montgomery words -> canonical [L, M]."""
    m, nl = packed.shape[0], curve.base.limbs
    if m == 0:
        return _empty(curve, 0, packed.device)
    flat = packed.reshape(m, 3, nl).permute(2, 1, 0).reshape(nl, 3 * m)
    return tuple(fops.from_montgomery(curve.base, flat.contiguous()).chunk(3, dim=1))


def _take(pt: cops.Point, idx: torch.Tensor) -> cops.Point:
    return tuple(t[:, idx] for t in pt)


def _put(pt: cops.Point, idx: torch.Tensor, val: cops.Point) -> None:
    for t, v in zip(pt, val):
        t[:, idx] = v


def _accumulate(curve: CurveSpec, acc: cops.Point, has: torch.Tensor,
                x: cops.Point, x_has: torch.Tensor) -> torch.Tensor:
    """acc (+)= x in place over a batch (the kernels' mpt_accumulate):
    where acc holds no point yet it takes x, where both hold one it takes
    add(acc, x).  Returns the new `has`."""
    both = (has & x_has).nonzero().squeeze(1)
    only = (x_has & ~has).nonzero().squeeze(1)
    if both.numel():
        _put(acc, both, cops.add_plain(curve, _take(acc, both), _take(x, both)))
    if only.numel():
        _put(acc, only, _take(x, only))
    return has | x_has


def _negate_where(curve: CurveSpec, pt: cops.Point, neg: torch.Tensor) -> cops.Point:
    """pt with Y negated where `neg` (plain field ops)."""
    y = pt[1]
    zero = torch.zeros_like(y[:, :1])
    return (pt[0], torch.where(neg[None], fops.sub_plain(curve.base, zero, y), y),
            pt[2])


def _empty(curve: CurveSpec, m: int, device) -> cops.Point:
    return tuple(torch.zeros((curve.base.limbs, m), dtype=torch.int32,
                             device=device) for _ in range(3))


def bucket_accumulate_plain(curve: CurveSpec, basis: MsmBasis, digits: torch.Tensor,
                            order: torch.Tensor, starts: torch.Tensor,
                            chunk: int = CHUNK, tile: int | None = None,
                            signs: torch.Tensor | None = None):
    """(buckets [R, nb, 3L], carries [R, ntiles, 3L]) in Montgomery
    form, as the accumulation kernel leaves them (see its comment in
    csrc/msm_kernels.cu): bucket j of row r holds the sum of its run's
    points in the sorted order `order[r]` (digits[r] sorted, run starts
    `starts`) that lie in the run's first tile of chunk * tile positions;
    carries[r, t] holds the part in tile t of the run that crosses into
    tile t.  Empty buckets, bucket 0 and unused carries are zero words.
    With `signs` ([R, N] in the sorted order, as `digits`), a position
    whose sign is negative adds its point with Y negated (p - y, 0 for
    0), at the gather as the signed kernel does.  The kernel's grouping
    is chunk = CHUNK, tile = tile_for(L) (the default)."""
    if tile is None:
        tile = tile_for(curve.base.limbs)
    w = words(curve)
    rows, n = order.shape
    nb = starts.shape[1] - 1
    dev = basis.device
    nchunks = -(-n // chunk)
    ntiles = -(-nchunks // tile)
    buckets = torch.zeros((rows * nb, w), dtype=torch.int32, device=dev)
    carries = torch.zeros((rows * ntiles, w), dtype=torch.int32, device=dev)
    if rows * n == 0:
        return (buckets.reshape(rows, nb, w),
                carries.reshape(rows, ntiles, w))
    pad = nchunks * chunk + 1 - n
    dig = torch.cat([digits.to(torch.int64),
                     torch.full((rows, pad), -1, dtype=torch.int64, device=dev)], 1)
    ordp = torch.cat([order.to(torch.int64),
                      torch.zeros((rows, pad), dtype=torch.int64, device=dev)], 1)
    negp = None if signs is None else torch.cat(
        [signs < 0, torch.zeros((rows, pad), dtype=torch.bool, device=dev)], 1)
    st = starts.to(torch.int64)
    m = rows * nchunks
    row = torch.arange(rows, device=dev).repeat_interleave(nchunks)
    cq = torch.arange(nchunks, device=dev).repeat(rows)
    s0 = cq * chunk
    s1 = torch.clamp(s0 + chunk, max=n)
    pts = (basis.x, basis.y, basis.z)

    acc = _empty(curve, m, dev)
    cont, head = _empty(curve, m, dev), _empty(curve, m, dev)
    has_cont = torch.zeros(m, dtype=torch.bool, device=dev)
    has_head = torch.zeros_like(has_cont)
    cont_lo, cont_hi, head_hi, head_d = (torch.zeros(m, dtype=torch.int64, device=dev)
                                         for _ in range(4))
    written_idx, written = [], []
    for k in range(chunk):
        s = s0 + k
        d = dig[row, s]
        valid = d > 0
        new = valid & ((d != dig[row, torch.clamp(s - 1, min=0)]) if k else valid)
        step = (valid & ~new).nonzero().squeeze(1)
        pt = _take(pts, ordp[row, s])
        if negp is not None:
            pt = _negate_where(curve, pt, negp[row, s])
        if step.numel():
            _put(acc, step, cops.add_plain(curve, _take(acc, step), _take(pt, step)))
        sel = new.nonzero().squeeze(1)
        _put(acc, sel, _take(pt, sel))
        ends = valid & ((dig[row, s + 1] != d) | (k == chunk - 1))
        lo = st[row, torch.clamp(d, min=0)]
        hi = st[row, torch.clamp(d + 1, min=0)]
        whole = ends & (lo >= s0) & (hi <= s1)
        to_cont = ends & (lo < s0)
        to_head = ends & ~whole & ~to_cont
        sel = whole.nonzero().squeeze(1)
        written_idx.append(row[sel] * nb + d[sel])
        written.append(_take(acc, sel))
        sel = to_cont.nonzero().squeeze(1)
        _put(cont, sel, _take(acc, sel))
        has_cont |= to_cont
        cont_lo = torch.where(to_cont, lo, cont_lo)
        cont_hi = torch.where(to_cont, hi, cont_hi)
        sel = to_head.nonzero().squeeze(1)
        _put(head, sel, _take(acc, sel))
        has_head |= to_head
        head_hi = torch.where(to_head, hi, head_hi)
        head_d = torch.where(to_head, d, head_d)

    first = (cq // tile) * tile
    last = torch.clamp(first + tile, max=nchunks) - 1
    cont_root = torch.maximum(cont_lo // chunk, first)
    cont_last = torch.minimum((cont_hi - 1) // chunk, last)
    head_last = torch.minimum((head_hi - 1) // chunk, last)
    step = 1
    while step < min(tile, nchunks):
        recv_c = (has_cont & ((cq - cont_root) % (2 * step) == 0)
                  & (cq + step <= cont_last)).nonzero().squeeze(1)
        recv_h = (has_head & (cq + step <= head_last)).nonzero().squeeze(1)
        new_c = cops.add_plain(curve, _take(cont, recv_c), _take(cont, recv_c + step))
        new_h = cops.add_plain(curve, _take(head, recv_h), _take(cont, recv_h + step))
        _put(cont, recv_c, new_c)
        _put(head, recv_h, new_h)
        step *= 2
    sel = has_head.nonzero().squeeze(1)
    written_idx.append(row[sel] * nb + head_d[sel])
    written.append(_take(head, sel))
    sel = (has_cont & (cq == first)).nonzero().squeeze(1)
    carry_idx = row[sel] * ntiles + cq[sel] // tile
    idx = torch.cat(written_idx)
    vals = tuple(torch.cat(parts, dim=1) for parts in zip(*written))
    buckets[idx] = pack_points(curve, vals)
    carries[carry_idx] = pack_points(curve, _take(cont, sel))
    return buckets.reshape(rows, nb, w), carries.reshape(rows, ntiles, w)


def bucket_reduce_plain(curve: CurveSpec, buckets: torch.Tensor, carries: torch.Tensor,
                        starts: torch.Tensor, chunk: int = CHUNK,
                        tile: int | None = None, seg: int | None = None) -> cops.Point:
    """Window sums [L, R] (canonical) of the accumulation's output:
    sum_j j B_j, with B_j the bucket plus its carries, as the reduction
    kernel forms it (see its comment in csrc/msm_kernels.cu): segments of
    `seg` buckets by running sums, their W_s by a pairwise tree, sum s T_s
    by a running sum, seg times by doublings.  An empty row gives the
    identity.  chunk and tile are the accumulation's; the kernel's are
    CHUNK, tile_for(L) (the default) and reduce_seg(nb) (the default)."""
    if tile is None:
        tile = tile_for(curve.base.limbs)
    w = words(curve)
    rows, nb = buckets.shape[0], buckets.shape[1]
    if seg is None:
        seg = reduce_seg(nb)
    ntiles = carries.shape[1]
    dev = buckets.device
    tp = chunk * tile
    nseg = -(-(nb - 1) // seg)
    out = cops.identity(curve, (rows,), dev)
    if rows == 0 or nseg == 0:
        return out
    b = unpack_points(curve, buckets.reshape(rows * nb, w))
    c = unpack_points(curve, carries.reshape(rows * ntiles, w))
    st = starts.to(torch.int64)
    lo, hi = st[:, :-1].reshape(-1), st[:, 1:].reshape(-1)
    nonempty = hi > lo
    t0 = lo // tp + 1
    extra = torch.where(nonempty, (hi - 1) // tp - t0 + 1, torch.zeros_like(lo))
    brow = torch.arange(rows, device=dev).repeat_interleave(nb)
    for e in range(int(extra.max().item())):
        sel = (extra > e).nonzero().squeeze(1)
        _put(b, sel, cops.add_plain(curve, _take(b, sel),
                                    _take(c, brow[sel] * ntiles + t0[sel] + e)))

    lanes = rows * nseg
    lrow = torch.arange(rows, device=dev).repeat_interleave(nseg)
    lseg = torch.arange(nseg, device=dev).repeat(rows)
    running, acc = _empty(curve, lanes, dev), _empty(curve, lanes, dev)
    has_run = torch.zeros(lanes, dtype=torch.bool, device=dev)
    has_acc = torch.zeros_like(has_run)
    for i in range(seg - 1, -1, -1):
        j = lseg * seg + i + 1
        present = j < nb
        flat = lrow * nb + torch.clamp(j, max=nb - 1)
        present &= nonempty[flat]
        has_run = _accumulate(curve, running, has_run, _take(b, flat), present)
        has_acc = _accumulate(curve, acc, has_acc, running, has_run)

    step = 1
    while step < nseg:
        recv = ((lseg % (2 * step) == 0) & (lseg + step < nseg)).nonzero().squeeze(1)
        part = recv + step
        sub = _take(acc, recv)
        sub_has = _accumulate(curve, sub, has_acc[recv], _take(acc, part), has_acc[part])
        _put(acc, recv, sub)
        has_acc[recv] = sub_has
        step *= 2

    run2, acc2 = _empty(curve, rows, dev), _empty(curve, rows, dev)
    has_run2 = torch.zeros(rows, dtype=torch.bool, device=dev)
    has_acc2 = torch.zeros_like(has_run2)
    base = torch.arange(rows, device=dev) * nseg
    for k in range(nseg - 1, 0, -1):
        has_run2 = _accumulate(curve, run2, has_run2, _take(running, base + k),
                               has_run[base + k])
        has_acc2 = _accumulate(curve, acc2, has_acc2, run2, has_run2)
    sel = has_acc2.nonzero().squeeze(1)
    if sel.numel():
        pt = _take(acc2, sel)
        for _ in range(seg.bit_length() - 1):
            pt = cops.double_plain(curve, pt)
        _put(acc2, sel, pt)
    res = _take(acc, base)
    has_res = _accumulate(curve, res, has_acc[base], acc2, has_acc2)
    sel = has_res.nonzero().squeeze(1)
    if sel.numel():
        _put(out, sel, _take(res, sel))
    return out


def signed_order(order: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """int32 order words with bit 31 set where the sign is negative."""
    return torch.where(signs < 0, order | SIGN_BIT, order)


def bucket_accumulate(curve: CurveSpec, basis: MsmBasis, digits: torch.Tensor,
                      order: torch.Tensor, starts: torch.Tensor,
                      signs: torch.Tensor | None = None):
    """K4 accumulation on the card: sorted digits and order [R, N], run
    starts [R, B + 1] (int32) -> (buckets [R, B, 3L], carries
    [R, ntiles, 3L]), Montgomery form (see bucket_accumulate_plain).  With
    `signs` ([R, N], sorted order) it launches msm_bucket_accumulate_signed,
    which reads a negative position's sign from bit 31 of its `order`
    word (SIGN_BIT; N < 2^31 leaves the bit free, and the kernel reads the
    word anyway, so the sign costs no bytes and no argument)."""
    if not fops._dispatch(basis.mont):
        return bucket_accumulate_plain(curve, basis, digits, order, starts,
                                       signs=signs)
    kernel = "msm_bucket_accumulate" + ("" if signs is None else "_signed")
    name, entry = _cuda.kernel(kernel, curve.base.limbs)
    for t in (basis.mont, digits, order, starts):
        _cuda.check(name, t)
    if signs is not None:
        if signs.shape != order.shape:
            raise ValueError(f"{name}: signs {tuple(signs.shape)}, order "
                             f"{tuple(order.shape)}")
        order = signed_order(order, signs)
    w, tile = words(curve), tile_for(curve.base.limbs)
    rows, n = order.shape
    nb = starts.shape[1] - 1
    if (starts.dim() != 2 or starts.shape[0] != rows or n != basis.n
            or digits.shape != order.shape
            or basis.mont.shape != (n, w) or basis.mont.data_ptr() % 16):
        raise ValueError(f"{name}: order {tuple(order.shape)}, digits "
                         f"{tuple(digits.shape)}, basis {tuple(basis.mont.shape)}")
    ntiles = -(-n // (CHUNK * tile))
    buckets = torch.zeros((rows, nb, w), dtype=torch.int32, device=basis.device)
    carries = torch.zeros((rows, ntiles, w), dtype=torch.int32, device=basis.device)
    if rows * n == 0:
        return buckets, carries
    _cuda.launch(name, entry, (buckets, carries, basis.mont, digits, order, starts),
                 buckets.data_ptr(), carries.data_ptr(), basis.mont.data_ptr(),
                 digits.data_ptr(), order.data_ptr(), starts.data_ptr(), rows, n,
                 nb, CHUNK, tile, cops._consts_host(curve).ctypes.data)
    return buckets, carries


def bucket_reduce(curve: CurveSpec, buckets: torch.Tensor, carries: torch.Tensor,
                  starts: torch.Tensor) -> cops.Point:
    """K4 reduction on the card: the accumulation's (buckets, carries) and
    the run starts -> window sums [L, R], canonical."""
    if not fops._dispatch(buckets):
        return bucket_reduce_plain(curve, buckets, carries, starts)
    nl = curve.base.limbs
    name, entry = _cuda.kernel("msm_bucket_reduce", nl)
    for t in (buckets, carries, starts):
        _cuda.check(name, t)
    w = words(curve)
    rows, nb = buckets.shape[0], buckets.shape[1]
    if (buckets.dim() != 3 or buckets.shape[2] != w or carries.dim() != 3
            or carries.shape[0] != rows or carries.shape[2] != w
            or starts.shape != (rows, nb + 1)):
        raise ValueError(f"{name}: buckets {tuple(buckets.shape)}, carries "
                         f"{tuple(carries.shape)}, starts {tuple(starts.shape)}")
    outs = [torch.empty((nl, rows), dtype=torch.int32, device=buckets.device)
            for _ in range(3)]
    if rows == 0:
        return tuple(outs)
    _cuda.launch(name, entry, (*outs, buckets, carries, starts),
                 *[t.data_ptr() for t in outs],
                 buckets.data_ptr(), carries.data_ptr(), starts.data_ptr(), rows, nb,
                 carries.shape[1], CHUNK * tile_for(nl), reduce_seg(nb),
                 cops._consts_host(curve).ctypes.data)
    return tuple(outs)


def horner_plain(curve: CurveSpec, ws: cops.Point, c: int) -> cops.Point:
    """Window sums [L, K, W] (canonical, least significant window
    first) -> sum_w 2^(c w) ws[w], [L, K]: acc = ws[W-1], then for
    w = W-2 .. 0, c doublings and one add of ws[w]."""
    n_windows = ws[0].shape[-1]
    acc = tuple(t[..., n_windows - 1].contiguous() for t in ws)
    for w in range(n_windows - 2, -1, -1):
        for _ in range(c):
            acc = cops.double_plain(curve, acc)
        acc = cops.add_plain(curve, acc, tuple(t[..., w] for t in ws))
    return acc


def horner(curve: CurveSpec, ws: cops.Point, c: int) -> cops.Point:
    """K2's Horner chain on the card (one launch, one warp per MSM): the
    same function as horner_plain, equal to it word for word."""
    if not fops._dispatch(ws[0]):
        return horner_plain(curve, ws, c)
    nl = curve.base.limbs
    name, entry = _cuda.kernel("curve_horner", nl)
    for t in ws:
        _cuda.check(name, t, nl)
    if (ws[0].dim() != 3 or any(t.shape != ws[0].shape for t in ws)
            or ws[0].shape[2] < 1 or c < 1):
        raise ValueError(f"{name}: window sums {[tuple(t.shape) for t in ws]}, "
                         f"c = {c}")
    k, n_windows = ws[0].shape[1], ws[0].shape[2]
    outs = [torch.empty((nl, k), dtype=torch.int32, device=ws[0].device)
            for _ in range(3)]
    if k == 0:
        return tuple(outs)
    _cuda.launch(name, entry, (*outs, *ws), *[t.data_ptr() for t in outs],
                 *[t.data_ptr() for t in ws], k, n_windows, c,
                 cops._consts_host(curve).ctypes.data)
    return tuple(outs)


def window_rows(curve: CurveSpec, scalars: torch.Tensor, c: int,
                signed: bool = False):
    """Steps 1-2 of `msm` for canonical scalars [Ls, *B, N]: (sorted
    digits [R, N] int32, order [R, N] int32, run starts [R, nb + 1] int32,
    signs [R, N] in the sorted order or None, windows a scalar), R = K W
    rows scalar-major (a scalar's windows contiguous, least significant
    first), nb = 2^c buckets, or 2^(c-1) + 1 and W + 1 windows signed."""
    if signed:
        digits, signs = scalar_window_digits_signed(curve.scalar, scalars, c)
        n_buckets = (1 << (c - 1)) + 1
    else:
        digits, signs = scalar_window_digits(curve.scalar, scalars, c), None
        n_buckets = 1 << c
    n_windows, n = digits.shape[0], digits.shape[-1]

    def rows(t):
        return t.reshape(n_windows, -1, n).transpose(0, 1).reshape(-1, n)
    sorted_digits, order = torch.sort(rows(digits), dim=-1, stable=True)
    starts = _run_starts(sorted_digits, n_buckets)
    if signs is not None:
        signs = torch.gather(rows(signs), 1, order)
    return (sorted_digits.to(torch.int32).contiguous(),
            order.to(torch.int32).contiguous(), starts, signs, n_windows)


def msm(curve: CurveSpec, basis: MsmBasis, scalars: torch.Tensor,
        window_bits: int, signed: bool = False) -> cops.Point:
    """sum_i scalars[..., i] * basis[i] for canonical scalars
    [Ls, *B, N]; returns a [L, *B] projective point (a multi-MSM over the
    shared basis when B is not empty).  `signed` takes the signed-window
    recoding (plonky_tpu/curves/msm.py:277): half the buckets, one window
    more."""
    if not isinstance(basis, MsmBasis):
        raise TypeError("msm takes an MsmBasis (see precompute_base)")
    if scalars.shape[-1] != basis.n:
        raise ValueError(f"{scalars.shape[-1]} scalars for {basis.n} points")
    c = window_bits
    if signed and c < 2:
        raise ValueError(f"signed windows need window_bits >= 2, not {c}")
    lead = tuple(scalars.shape[1:-1])
    k = 1
    for d in lead:
        k *= d
    digits, order, starts, signs, n_windows = window_rows(curve, scalars, c, signed)
    buckets, carries = bucket_accumulate(curve, basis, digits, order, starts, signs)
    nl = curve.base.limbs
    ws = bucket_reduce(curve, buckets, carries, starts)   # [L, K W]
    ws = tuple(t.reshape(nl, k, n_windows) for t in ws)
    acc = horner(curve, ws, c)
    return tuple(t.reshape(nl, *lead) for t in acc)


def msm_chunked(curve: CurveSpec, basis: MsmBasis, scalars: torch.Tensor,
                window_bits: int = 8, chunk_log: int = 18,
                signed: bool = False) -> cops.Point:
    """`msm` over slices of 2^chunk_log points, summed by `cops.add` (K2's
    curve_add on the card): the MSM is linear in its points, so the sum of
    the slices' MSMs is the whole one (plonky_tpu/curves/msm.py:436-465,
    whose bench runs BLS12-377 at chunk_log = 16).  N must be at most
    2^chunk_log or a multiple of it."""
    if not isinstance(basis, MsmBasis):
        raise TypeError("msm_chunked takes an MsmBasis (see precompute_base)")
    n, size = basis.n, 1 << chunk_log
    if n <= size:
        return msm(curve, basis, scalars, window_bits, signed)
    if n % size:
        raise ValueError(f"N={n} not a multiple of chunk {size}")
    acc = None
    for lo in range(0, n, size):
        part = msm(curve, basis.slice(lo, lo + size),
                   scalars[..., lo:lo + size], window_bits, signed)
        acc = part if acc is None else cops.add(curve, acc, part)
    return acc
