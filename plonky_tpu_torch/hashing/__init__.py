from .blake3 import blake3_hash
from .chacha import ChaCha8Rng
from .challenger import Challenger
from .rescue import (
    RESCUE_SPONGE_RATE,
    RESCUE_SPONGE_WIDTH,
    mds_matrix,
    recommended_rounds,
    rescue_constants,
    rescue_hash_n_to_1_host,
    rescue_permutation,
    rescue_permutation_host,
    rescue_sponge_host,
)
from .hash_to_curve import (
    blake_hash_base_field_to_curve,
    blake_hash_usize_to_curve,
    hash_base_field_to_curve,
    hash_usize_to_curve,
)


def rescue_prf_host(spec, x: int, security_bits: int = 128) -> int:
    """RescuePrf (reference: src/pseudorandom.rs:3-44, src/rescue.rs:6-28)."""
    return rescue_hash_n_to_1_host(spec, [x], security_bits)
