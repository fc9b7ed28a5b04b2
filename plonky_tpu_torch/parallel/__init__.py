from .mesh import Mesh, default_mesh
from .fft import fft_sharded_batch, fft_sharded_domain
from .msm import msm_sharded, shard_basis
from .distributed import hybrid_mesh, initialize, process_local_slice
