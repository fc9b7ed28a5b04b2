"""Copy-constraint partitions and the sigma permutation
(reference: src/partition.rs).

The partition list ORDER is semantic: a wire's "neighbor" is the next wire in
its partition list (wrapping), and sigma is built from neighbors, so merge
order must match the reference exactly (merge appends a's list onto b's).

Implementation: the reference re-indexes every member of the merged
partition on each merge (O(|a|) dict writes, fine in Rust, quadratic-ish and
hash-dominated in Python -- measured 268s of a 334s recursion-circuit
build).  Here a partition is a singly-linked list with union-find roots:
merge is O(1) (relink tail/head + one parent pointer), membership is a
path-compressed find, and the ordered lists are materialized only at the
end.  The resulting order is identical: b's list followed by a's list.
"""

from __future__ import annotations

from typing import Dict, List

from ..fields import host as fhost
from ..fields.spec import FieldSpec
from ..hashing.chacha import ChaCha8Rng
from .target import NUM_ROUTED_WIRES, NUM_WIRES, Wire


class TargetPartitions:
    def __init__(self):
        self._id: Dict[object, int] = {}
        self._targets: List[object] = []
        self._parent: List[int] = []
        self._next: List[int] = []    # linked-list successor, -1 = end
        self._head: List[int] = []    # valid at roots
        self._tail: List[int] = []    # valid at roots

    def add_partition(self, target):
        i = len(self._targets)
        self._id[target] = i
        self._targets.append(target)
        self._parent.append(i)
        self._next.append(-1)
        self._head.append(i)
        self._tail.append(i)

    def add_partitions(self, targets: List[object]):
        """Bulk singleton creation (one dict update + array extends)."""
        base = len(self._targets)
        ids = range(base, base + len(targets))
        self._id.update(zip(targets, ids))
        self._targets.extend(targets)
        self._parent.extend(ids)
        self._next.extend([-1] * len(targets))
        self._head.extend(ids)
        self._tail.extend(ids)

    def _find(self, i: int) -> int:
        parent = self._parent
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    def merge(self, a, b):
        """Append a's partition onto b's (reference: partition.rs:37-52)."""
        ra = self._find(self._id[a])
        rb = self._find(self._id[b])
        if ra != rb:
            self._next[self._tail[rb]] = self._head[ra]
            self._tail[rb] = self._tail[ra]
            self._parent[ra] = rb

    def _iter_ids(self, root: int):
        i = self._head[root]
        nxt = self._next
        while i != -1:
            yield i
            i = nxt[i]

    def get_partition(self, target) -> List[object]:
        root = self._find(self._id[target])
        targets = self._targets
        return [targets[i] for i in self._iter_ids(root)]

    def to_wire_partitions(self) -> "WirePartitions":
        partitions = []
        for i in range(len(self._targets)):
            if self._find(i) == i:
                part = [self._targets[j] for j in self._iter_ids(i)
                        if type(self._targets[j]) is Wire]
                partitions.append(part)
        wp = WirePartitions(partitions)
        wp.assert_valid()
        return wp


class WirePartitions:
    def __init__(self, partitions: List[List[Wire]]):
        self.partitions = partitions
        self._neighbor: Dict[Wire, Wire] = {}
        for part in partitions:
            n = len(part)
            for i, w in enumerate(part):
                self._neighbor[w] = part[(i + 1) % n]

    def assert_valid(self):
        for part in self.partitions:
            for w in part:
                if w.input >= NUM_ROUTED_WIRES:
                    assert len(part) == 1, \
                        "Non-routed wires should not share a partition"

    def get_neighbor(self, wire: Wire) -> Wire:
        return self._neighbor[wire]

    def to_sigma(self) -> List[int]:
        """sigma: [6n] -> [6n] (reference: partition.rs:120-136)."""
        num_gates = len(self._neighbor) // NUM_WIRES
        sigma = []
        nb_map = self._neighbor
        for inp in range(NUM_ROUTED_WIRES):
            for gate in range(num_gates):
                nb = nb_map[Wire(gate, inp)]
                sigma.append(nb.input * num_gates + nb.gate)
        return sigma


def get_subgroup_shift(spec: FieldSpec, i: int) -> int:
    """k_i: ChaCha8(seed=i)-derived coset shift (reference: partition.rs:140-154)."""
    rng = ChaCha8Rng.seed_from_u64(i)
    return fhost.rand_from_rng(spec, rng)


def sigma_values_host(spec: FieldSpec, sigma, degree: int,
                      subgroup_generator: int):
    """sigma indices -> field values: k_{x//n} * g^(x%n), chunked per wire
    (reference: src/plonk_util.rs:264-280 sigma_polynomials)."""
    p = spec.p
    shifts = [get_subgroup_shift(spec, i) for i in range(NUM_ROUTED_WIRES)]
    # precompute g powers
    powers = [1] * degree
    for j in range(1, degree):
        powers[j] = powers[j - 1] * subgroup_generator % p
    out = []
    for c in range(0, len(sigma), degree):
        chunk = sigma[c:c + degree]
        out.append([shifts[x // degree] * powers[x % degree] % p for x in chunk])
    return out
