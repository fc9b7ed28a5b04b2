"""ChaCha8 CSPRNG, stream-compatible with Rust's `rand_chacha 0.2.2`.

The reference derives all its deterministic setup randomness from
`ChaCha8Rng::seed_from_u64(seed)` (Rescue round constants, seed 1337,
reference: src/rescue.rs:105; permutation-argument subgroup shifts, seed = i,
reference: src/partition.rs:152).  To produce identical constants we
replicate:

* `SeedableRng::seed_from_u64`'s default seed expansion (PCG32 output
  function over a splitmix-style LCG, rand_core 0.5),
* the djb ChaCha variant with a 64-bit block counter at words 12-13 and a
  64-bit stream id (zero) at words 14-15, 8 rounds,
* `BlockRng::next_u64`: two consecutive u32 keystream words, low then high.
"""

from __future__ import annotations

import struct

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.5 SeedableRng::seed_from_u64 default implementation."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    for _ in range(8):  # 32-byte seed in 4-byte chunks
        state = (state * MUL + INC) & MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32
        out += struct.pack("<I", x)
    return bytes(out)


def _chacha_block(key_words, counter: int, rounds: int = 8):
    """One ChaCha block: 16 output u32 words."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & MASK32, (counter >> 32) & MASK32,
        0, 0,  # stream id
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + state[i]) & MASK32 for i in range(16)]


class ChaCha8Rng:
    """Keystream-equivalent of rand_chacha::ChaCha8Rng."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.counter = 0
        self.buf: list[int] = []  # pending u32 words

    @classmethod
    def seed_from_u64(cls, seed: int) -> "ChaCha8Rng":
        return cls(seed_from_u64(seed))

    def _refill(self):
        self.buf = _chacha_block(self.key, self.counter)
        self.counter += 1

    def next_u32(self) -> int:
        if not self.buf:
            self._refill()
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)
