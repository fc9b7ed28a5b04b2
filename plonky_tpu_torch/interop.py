"""State carried across from the JAX package, given as numpy arrays.

The JAX package stores a field element as loose little-endian 8-bit digits
in an int32 array [D, *batch] (digits may exceed 255 between reductions,
and two encodings of one value may differ).  These helpers turn such arrays
into this package's canonical limb tensors and back, so that tests can feed
the JAX package's intermediate values into the port's functions.  Nothing
here imports the JAX package: the arrays arrive as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.spec import CurveSpec
from .device import resolve
from .fields import ops as fops
from .fields.spec import FieldSpec


def field_from_jax_digits(spec: FieldSpec, digits, device=None) -> torch.Tensor:
    """Loose digits [D, *batch] (any non-negative int32 values; D = 34 on
    the Tweedle fields, 50 on BLS12-377's base field) -> canonical limbs
    [L, *batch] (L = spec.limbs) holding sum_i d_i 256^i mod p."""
    d = np.asarray(digits).astype(np.int64)
    assert d.ndim >= 1 and (d >= 0).all(), "digits must be non-negative"
    batch = d.shape[1:]
    flat = torch.from_numpy(d.reshape(d.shape[0], -1))
    if flat.shape[0] % 2:
        flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    # pairs of 8-bit digits -> columns at 16-bit positions (still loose)
    cols = flat[0::2] + (flat[1::2] << 8)
    assert cols.shape[0] <= 4 * spec.limbs + 2, "value too wide for the reduction"
    limbs = fops._join16(fops._reduce_columns(spec, cols))
    return limbs.reshape(spec.limbs, *batch).to(resolve(device))


def field_to_jax_digits(spec: FieldSpec, x: torch.Tensor,
                        n_digits: int) -> np.ndarray:
    """Canonical limbs [L, *batch] -> canonical 8-bit digits
    [n_digits, *batch] int32 (the JAX package's working width is
    ceil((bits + 16) / 8) digits)."""
    nl = spec.limbs
    arr = x.detach().cpu().contiguous().numpy().view(np.uint32)
    batch = arr.shape[1:]
    b = arr.reshape(nl, -1).T.copy().view(np.uint8)     # [N, 4 L]
    out = np.zeros((n_digits, b.shape[0]), dtype=np.int32)
    k = min(n_digits, 4 * nl)
    out[:k] = b[:, :k].T
    return out.reshape((n_digits,) + batch)


def points_from_jax(curve: CurveSpec, point, device=None):
    """A JAX projective point (X, Y, Z) of loose digit arrays -> a port
    point of canonical limb tensors."""
    return tuple(field_from_jax_digits(curve.base, c, device) for c in point)


def circuit_tensors_from_jax(spec: FieldSpec, arrays: dict,
                             device=None) -> dict:
    """The JAX circuit's device tensors (numpy digit arrays, each
    [D, 6, n] or [D, 6, 8n]) -> canonical port tensors, for the keys
    constant_polynomials, constants_8n, s_sigma_polynomials and
    s_sigma_values_8n."""
    keys = ("constant_polynomials", "constants_8n", "s_sigma_polynomials",
            "s_sigma_values_8n")
    return {k: field_from_jax_digits(spec, arrays[k], device)
            for k in keys if k in arrays}
