"""Multi-device distribution: device meshes, particle sharding, halo
exchange (counterpart of dieselfluid_tpu/parallel/)."""

from dieselfluid_tpu_torch.parallel.mesh import (  # noqa: F401
    DistMesh,
    LocalMesh,
)
from dieselfluid_tpu_torch.parallel.sharding import (  # noqa: F401
    particle_mesh,
    shard_state,
    sharded_train_step,
)
