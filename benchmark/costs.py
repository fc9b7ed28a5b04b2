"""The yardstick's least work: bytes and 32-bit IMAD slots of a call,
counted from its shapes and inputs, and the peaks they are held against.

The counters are frozen copies of chip_smoke.py's (`field_costs`,
`point_costs`, `horner_work`, `ntt_work`, `k4_work`, `reduce_work`), taking
a field as (p, limbs) so that nothing here reads the program.  A product
of two L-limb numbers is L^2 wide 32 x 32 -> 64-bit products, two IMAD
slots each; a Montgomery reduction L rounds of one quotient digit and L
wide products; over p = 2^254 + c (c < 2^128, p = 1 mod 2^32, both Tweedle
fields) the reduction's quotient digit is a negation and m p three wide
products a row.  Additions and multiplies by small constants are not
counted: every count is a floor.
"""

from __future__ import annotations

import torch

# One H100 SXM: HBM3 at 3.35 TB/s (data sheet); 64 IMAD slots per SM per
# clock x 132 SMs x the published boost clock of 1980 MHz.
HBM_BYTES_PER_S = 3.35e12
IMAD_SLOTS_PER_S = 64 * 132 * 1980e6
WIDE = 2


def product_ops(nl: int) -> int:
    return nl * nl * WIDE                       # 128 at 8 limbs, 288 at 12


def redc_ops(nl: int) -> int:
    return nl * (1 + nl * WIDE)                 # 136 at 8 limbs, 300 at 12


def mul_ops(nl: int) -> int:
    return product_ops(nl) + redc_ops(nl)       # 264 at 8 limbs, 588 at 12


def sqr_ops(nl: int) -> int:
    return nl * (nl + 1) // 2 * WIDE + redc_ops(nl)   # 208, 456


SPARSE_REDC_OPS = 8 * 3 * WIDE
SPARSE_MUL_OPS = product_ops(8) + SPARSE_REDC_OPS
SPARSE_SQR_OPS = 8 * 9 // 2 * WIDE + SPARSE_REDC_OPS


def sparse_prime(p: int) -> bool:
    c = p - (1 << 254)
    return 0 <= c < 1 << 128 and p % (1 << 32) == 1


def field_costs(p: int, nl: int) -> tuple:
    """(square, multiply, reduction) in IMAD slots: 120, 176, 48 over a
    sparse prime; else 208, 264, 136 at 8 limbs and 456, 588, 300 at 12."""
    if sparse_prime(p):
        return SPARSE_SQR_OPS, SPARSE_MUL_OPS, SPARSE_REDC_OPS
    return sqr_ops(nl), mul_ops(nl), redc_ops(nl)


def point_costs(p: int, nl: int) -> tuple:
    """(add, double) in IMAD slots: RCB15 Alg. 7 (a = 0) 12 M, Alg. 9
    6 M + 2 S."""
    sqr, mul, _redc = field_costs(p, nl)
    return 12 * mul, 6 * mul + 2 * sqr


def horner_work(k: int, n_windows: int, c: int, p: int, nl: int) -> tuple:
    """(bytes, slots) of the Horner over windows: the window sums read
    once, one point an MSM written; (W - 1) (c doublings + 1 add) an MSM."""
    add, dbl = point_costs(p, nl)
    return (3 * 4 * nl * k * (n_windows + 1),
            k * (n_windows - 1) * (c * dbl + add))


def ntt_work(batch: int, lg: int, inverse: bool, coset: bool, p: int, nl: int) -> tuple:
    """(bytes, slots) of a whole transform of [batch, 2^lg]: B (n / 2)
    (lg - 1) twiddle products, plus B n scale products where it scales;
    the data read and written once, the twiddles of layers 1 .. lg - 1 and
    any scale table read once."""
    n = 1 << lg
    scaled = inverse or coset
    elem = 4 * nl
    table = elem * n if coset else (elem if inverse else 0)
    return (2 * elem * batch * n + elem * max(n - 2, 0) + table,
            field_costs(p, nl)[1] * (batch * (n // 2) * max(lg - 1, 0)
                                     + (batch * n if scaled else 0)))


def k4_work(rows: torch.Tensor, starts: torch.Tensor, out_bytes: int,
            p: int, nl: int) -> tuple:
    """(accumulate bytes, accumulate slots, reduce bytes, reduce slots) for
    digit rows [R, N] and their run starts [R, nb + 1]: the basis, sorted
    digits, order and run starts read once and `out_bytes` of buckets
    written; one add a point beyond the first of each non-empty bucket;
    the reduction as reduce_work counts it."""
    r, n = rows.shape
    live = int((rows != 0).sum().item())
    nonempty = int(((starts[:, 2:] - starts[:, 1:-1]) > 0).sum().item())
    acc_bytes = 12 * nl * n + 8 * r * n + 4 * starts.numel() + out_bytes
    return (acc_bytes, point_costs(p, nl)[0] * (live - nonempty),
            *reduce_work(starts, out_bytes, p, nl))


def reduce_work(starts: torch.Tensor, out_bytes: int, p: int, nl: int) -> tuple:
    """(bytes, slots) of the reduction: the buckets and run starts read,
    a point a row written, two adds a non-empty bucket."""
    nonempty = int(((starts[:, 2:] - starts[:, 1:-1]) > 0).sum().item())
    return (out_bytes + 4 * starts.numel() + 12 * nl * starts.shape[0],
            point_costs(p, nl)[0] * 2 * nonempty)


def window_digits(scalars: torch.Tensor, bits: int, c: int) -> torch.Tensor:
    """Canonical scalars [Ls, *B, N] (int32 limbs) -> c-bit window digits
    [W, *B, N] (int64, least significant window first), W = ceil(bits / c)."""
    n_windows = -(-bits // c)
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros_like(v[:1])])
    start = torch.arange(n_windows, device=scalars.device) * c
    limb, shift = start // 32, start % 32
    view = (n_windows,) + (1,) * (scalars.dim() - 1)
    lo = v[limb] >> shift.reshape(view)
    hi = (v[limb + 1] << (32 - shift).reshape(view)) & 0xFFFFFFFF
    return (lo | hi) & ((1 << c) - 1)


def run_starts(rows: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[R, N] digits -> [R, n_buckets + 1] starts of each bucket's run in
    the sorted order (int64)."""
    counts = torch.zeros((rows.shape[0], n_buckets), dtype=torch.int64,
                         device=rows.device)
    counts.scatter_add_(1, rows, torch.ones_like(rows))
    return torch.cat([torch.zeros_like(counts[:, :1]), counts.cumsum(1)], 1)


def msm_work(scalars: torch.Tensor, bits: int, c: int, slice_points: int,
             p: int, nl: int) -> tuple:
    """(bytes, slots) of an unsigned-window MSM of scalars [Ls, K, N] over
    slices of `slice_points` points (one slice when N is not above it):
    each slice's accumulate (its buckets written), one reduction over
    every slice's rows, one Horner of slices x K chains, and the
    (slices - 1) K adds that sum the slices' points."""
    ls, k, n = scalars.shape
    size = min(n, slice_points)
    slices = n // size
    nb = 1 << c
    n_windows = -(-bits // c)
    add = point_costs(p, nl)[0]
    point = 12 * nl
    total_bytes = total_ops = 0
    for lo in range(0, n, size):
        d = window_digits(scalars[..., lo:lo + size], bits, c)       # [W, K, size]
        rows = d.transpose(0, 1).reshape(-1, size)
        starts = run_starts(rows, nb)
        out = point * rows.shape[0] * nb
        acc_b, acc_o, red_b, red_o = k4_work(rows, starts, out, p, nl)
        total_bytes += acc_b + red_b
        total_ops += acc_o + red_o
    h_bytes, h_ops = horner_work(slices * k, n_windows, c, p, nl)
    tree = (slices - 1) * k
    return (total_bytes + h_bytes + 3 * point * tree,
            total_ops + h_ops + add * tree)


def inverse_work(p: int, nl: int, count: int) -> tuple:
    """(bytes, slots) at least of `count` Fermat inverses x^(p - 2): one
    element read and written, and the bit length's squares less one (any
    chain for it doubles that often; its multiplies are not counted)."""
    sqr = field_costs(p, nl)[0]
    return 2 * 4 * nl * count, count * sqr * ((p - 2).bit_length() - 1)


def least_seconds(work: tuple) -> tuple:
    """(least seconds, "bytes" or "ops"): the larger of the bytes over the
    HBM bandwidth and the slots over the IMAD issue rate."""
    t_bytes = work[0] / HBM_BYTES_PER_S
    t_ops = work[1] / IMAD_SLOTS_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
