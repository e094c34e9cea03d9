"""Device meshes (counterpart of avatarcap_tpu/parallel/)."""

from avatarcap_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, replicate, shard_batch, shard_points)
