"""Evaluation algebras for gate constraints.

Each gate's constraints are written ONCE against this interface
(circuit/gates.py) and instantiated twice here:

* HostAlgebra  -- python ints mod p (the verifier's evaluation at zeta)
* BatchAlgebra -- canonical limb tensors [LIMBS, *batch] (the prover's
  vanishing-polynomial evaluation over all 8n points); every operation is
  one field-kernel launch.
"""

from __future__ import annotations

import torch

from ..fields import ops as fops
from ..fields.spec import FieldSpec, require_eight_limbs


class HostAlgebra:
    def __init__(self, spec: FieldSpec):
        self.p = spec.p

    def constant(self, c: int):
        return c % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def mul_const(self, c: int, a):
        return c * a % self.p

    def zero(self):
        return 0

    def one(self):
        return 1


class BatchAlgebra:
    """Canonical tensors over a trailing batch.  Constants are [LIMBS, 1]
    columns that broadcast; `wrap` and `unwrap` are identities (values are
    always canonical, so there are no pending carries to settle)."""

    def __init__(self, spec: FieldSpec, device: torch.device):
        require_eight_limbs(spec, "BatchAlgebra")
        self.spec = spec
        self.device = device

    def wrap(self, arr):
        return arr

    def unwrap(self, v):
        return v

    def constant(self, c: int):
        return fops.column(self.spec, c, self.device)

    def add(self, a, b):
        return fops.add(self.spec, a, b)

    def sub(self, a, b):
        return fops.sub(self.spec, a, b)

    def mul(self, a, b):
        return fops.mul(self.spec, a, b)

    def mul_const(self, c: int, a):
        return fops.mul(self.spec, self.constant(c), a)

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)
