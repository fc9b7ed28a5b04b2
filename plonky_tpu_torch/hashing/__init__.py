from .blake3 import blake3_hash
from .chacha import ChaCha8Rng
from .challenger import Challenger
from .rescue import (
    RESCUE_SPONGE_RATE,
    RESCUE_SPONGE_WIDTH,
    mds_matrix,
    recommended_rounds,
    rescue_constants,
    rescue_permutation_host,
)
from .hash_to_curve import (
    blake_hash_base_field_to_curve,
    blake_hash_usize_to_curve,
)
