"""Sharding of NUFFT transforms over a device mesh, one process driving
every device (see the sharded module)."""

from tensorflow_nufft_tpu_torch.parallel.mesh import Mesh
from tensorflow_nufft_tpu_torch.parallel.sharded import (
    ShardedPlannedNufft, sharded_nufft, sharded_nufft_grid,
    sharded_nufft_type3)

__all__ = ["Mesh", "ShardedPlannedNufft", "sharded_nufft",
           "sharded_nufft_grid", "sharded_nufft_type3"]
