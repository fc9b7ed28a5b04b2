"""Results of the JAX package that tier-1 tests hold the port against.

The JAX package is the frozen reference, and its MSMs and proofs cost
minutes of XLA compiles on the CPU.  So a tier-1 test that compares the
port with a JAX result that depends only on its pinned seeds reads that
result from tests/fixtures/jax_<group>.json (one entry a case), and a test
marked slow beside it makes the entry again through the JAX package and
holds it equal (with PLONKY_WRITE_FIXTURES=1 it writes the entry first).
"""

import hashlib
import json
import os

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _path(group: str) -> str:
    return os.path.join(FIXTURES, f"jax_{group}.json")


def load(group: str, key: str):
    """The JAX package's result `key` of fixture group `group`."""
    with open(_path(group)) as f:
        return json.load(f)[key]


def check(group: str, key: str, value) -> None:
    """`value`, made by the JAX package now, equals the committed entry
    (PLONKY_WRITE_FIXTURES=1 writes it first)."""
    if os.environ.get("PLONKY_WRITE_FIXTURES"):
        data = {}
        if os.path.exists(_path(group)):
            with open(_path(group)) as f:
                data = json.load(f)
        data[key] = value
        with open(_path(group), "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
    assert load(group, key) == value, (group, key)


def points(pts) -> list:
    """Affine points (curves/host.py's AffinePoint, either package's) as
    JSON: None for the identity, else [x, y] in hex."""
    return [None if p.zero else [hex(p.x), hex(p.y)] for p in pts]


def digest(ints) -> str:
    """sha256 of canonical ints (a large result, row-major)."""
    return hashlib.sha256(",".join(hex(int(v)) for v in ints).encode()).hexdigest()
