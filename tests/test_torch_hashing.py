"""The port's ChaCha core and BLAKE3 (plonky_tpu_torch/hashing/chacha.py,
blake3.py) against the published vectors of tests/test_hashing.py and the
JAX package's host implementations."""

from plonky_tpu.hashing import ChaCha8Rng as JChaCha8Rng
from plonky_tpu.hashing import blake3_hash as j_blake3_hash
from plonky_tpu_torch.hashing import ChaCha8Rng, blake3_hash
from plonky_tpu_torch.hashing.chacha import _chacha_block


def test_chacha_block_vectors():
    """The ChaCha20 zero-key keystream and the first half of the eSTREAM
    ChaCha8 zero-key vector; the stream equal to the JAX package's."""
    words20 = _chacha_block([0] * 8, 0, rounds=20)
    assert b"".join(w.to_bytes(4, "little") for w in words20) == bytes.fromhex(
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
        "da41597c5157488d7724e03fb8d84a376a43b8f41518a11cc387b669b2ee6586")
    words8 = _chacha_block([0] * 8, 0, rounds=8)
    assert b"".join(w.to_bytes(4, "little") for w in words8)[:32] == bytes.fromhex(
        "3e00ef2f895f40d67f5bb8e81f09a5a12c840ec3ce9a7f3b181be188ef711a1e")
    ours, theirs = ChaCha8Rng.seed_from_u64(7), JChaCha8Rng.seed_from_u64(7)
    assert [ours.next_u64() for _ in range(40)] == [theirs.next_u64()
                                                   for _ in range(40)]


def test_blake3_vectors():
    """Official BLAKE3 vectors (input bytes i % 251), the XOF prefix
    property, and multi-chunk inputs equal to the JAX package's."""
    assert blake3_hash(b"", 32).hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")
    assert blake3_hash(bytes([0]), 32).hex() == (
        "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213")
    assert blake3_hash(b"abc", 64)[:32] == blake3_hash(b"abc", 32)
    for n in (1023, 1024, 1025, 4097):
        data = bytes(i % 251 for i in range(n))
        assert blake3_hash(data, 72) == j_blake3_hash(data, 72)
