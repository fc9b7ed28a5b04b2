"""Prime fields: roots of unity on Python ints, and exact sums over tensors
of canonical 32-bit limbs ([L, ...], least significant limb first, int32
holding the unsigned word)."""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def root_of_unity(p: int, generator: int, two_adicity: int, lg: int) -> int:
    """The primitive 2^lg-th root of unity g^((p - 1) / 2^lg) of the
    field's published multiplicative generator g."""
    if not 0 <= lg <= two_adicity:
        raise ValueError(f"no 2^{lg}-th root: two-adicity {two_adicity}")
    return pow(generator, (p - 1) >> lg, p)


def ints_to_bytes(values, nbytes: int) -> np.ndarray:
    """Python ints (each below 2^(8 nbytes)) -> [len, nbytes] uint8,
    little-endian."""
    flat = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(flat, dtype=np.uint8).reshape(-1, nbytes)


def limb_bytes(x: torch.Tensor) -> torch.Tensor:
    """[L, *B, N] int32 limbs -> [*B, N, 4L] uint8, each element's
    little-endian bytes."""
    return x.movedim(0, -1).contiguous().view(torch.uint8)


def ints_from_limbs(x: torch.Tensor) -> list:
    """[L, N] int32 limbs -> N Python ints (the words as they are, not
    reduced)."""
    rows = limb_bytes(x.reshape(x.shape[0], -1)).cpu().numpy()
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def below(x: torch.Tensor, p: int) -> torch.Tensor:
    """[L, ...] int32 limbs -> bool [...]: the element is below p (that
    is, canonical)."""
    v = x.to(torch.int64) & MASK32
    lt = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    eq = torch.ones_like(lt)
    for limb in range(x.shape[0] - 1, -1, -1):
        pl = (p >> (32 * limb)) & MASK32
        lt |= eq & (v[limb] < pl)
        eq &= v[limb] == pl
    return lt


def dot_mod(weights: torch.Tensor, x: torch.Tensor, p: int) -> list:
    """sum_i w_i x[k, i] mod p for every row k: weights [N, nw] uint8
    (their little-endian bytes), x [L, K, N] int32 limbs.  Exact: the
    byte products are summed by float64 matrix products, whose every
    partial sum stays below N 2^16 < 2^53, and the byte columns are
    joined on Python ints."""
    xb = limb_bytes(x.reshape(x.shape[0], -1, x.shape[-1]))      # [K, N, 4L]
    w = weights.to(device=x.device, dtype=torch.float64)
    if w.shape[0] != xb.shape[1] or w.shape[0] >= 1 << 37:
        raise ValueError(f"weights {tuple(w.shape)} for x {tuple(x.shape)}")
    nw, nx = w.shape[1], xb.shape[2]
    out = []
    for k in range(xb.shape[0]):
        m = (w.T @ xb[k].to(torch.float64)).to(torch.int64)          # [nw, nx]
        diag = torch.zeros(nw + nx - 1, dtype=torch.int64, device=m.device)
        for b in range(nw):
            diag[b:b + nx] += m[b]
        total = sum(int(d) << (8 * t) for t, d in enumerate(diag.tolist()))
        out.append(total % p)
    return out


def plus_p(x: torch.Tensor, p: int) -> torch.Tensor:
    """x + p in the same limbs (the value left unreduced, as a lazy last
    step would leave it; x + p must fit)."""
    v = x.to(torch.int64) & MASK32
    out = torch.empty_like(v)
    carry = torch.zeros_like(v[0])
    for limb in range(v.shape[0]):
        s = v[limb] + ((p >> (32 * limb)) & MASK32) + carry
        out[limb], carry = s & MASK32, s >> 32
    if bool((carry != 0).any()):
        raise ValueError("x + p does not fit the limbs")
    return (out - ((out >> 31) << 32)).to(torch.int32)
