"""Pure-python BLAKE3 (hash + XOF), byte-compatible with the `blake3` crate.

Used only at setup time to derive the Pedersen commitment bases G_i, H, U
deterministically (reference: src/hash_to_curve.rs:13-76,
src/circuit_builder.rs:1127-1129), so a host implementation is appropriate;
inputs are ~50 bytes.  Follows the BLAKE3 reference implementation structure.
"""

from __future__ import annotations

import struct

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

MSG_PERMUTATION = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

MASK32 = 0xFFFFFFFF
BLOCK_LEN = 64
CHUNK_LEN = 1024


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state, m):
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        *cv,
        *IV[:4],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r != 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [
        *(state[i] ^ state[i + 8] for i in range(8)),
        *((state[i + 8] ^ cv[i]) & MASK32 for i in range(8)),
    ]


def _words_from_block(block: bytes):
    block = block.ljust(BLOCK_LEN, b"\x00")
    return list(struct.unpack("<16I", block))


class _Output:
    def __init__(self, cv, block_words, counter, block_len, flags):
        self.cv = cv
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self):
        return _compress(self.cv, self.block_words, self.counter,
                         self.block_len, self.flags)[:8]

    def root_bytes(self, n: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < n:
            words = _compress(self.cv, self.block_words, counter,
                              self.block_len, self.flags | ROOT)
            out += struct.pack("<16I", *words)
            counter += 1
        return bytes(out[:n])


def _chunk_output(chunk: bytes, chunk_counter: int) -> _Output:
    cv = list(IV)
    blocks = [chunk[i:i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    for i, blk in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            return _Output(cv, _words_from_block(blk), chunk_counter, len(blk), flags)
        cv = _compress(cv, _words_from_block(blk), chunk_counter, len(blk), flags)[:8]
    raise AssertionError


def _parent_output(left_cv, right_cv) -> _Output:
    return _Output(list(IV), left_cv + right_cv, 0, BLOCK_LEN, PARENT)


def _root_output(data: bytes) -> _Output:
    chunks = [data[i:i + CHUNK_LEN] for i in range(0, max(len(data), 1), CHUNK_LEN)]
    if not chunks:
        chunks = [b""]
    outputs = [_chunk_output(c, i) for i, c in enumerate(chunks)]
    # Build the binary tree: repeatedly merge, left subtree a full power of two.
    while len(outputs) > 1:
        merged = []
        i = 0
        while i < len(outputs):
            if i + 1 < len(outputs):
                merged.append(_parent_output(outputs[i].chaining_value(),
                                             outputs[i + 1].chaining_value()))
                i += 2
            else:
                merged.append(outputs[i])
                i += 1
        outputs = merged
    return outputs[0]


def blake3_hash(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash / XOF of `data` with out_len output bytes."""
    return _root_output(data).root_bytes(out_len)
