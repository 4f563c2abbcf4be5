"""Multi-process execution on ``torch.distributed``: start-up, meshes,
sharded align (counterpart of ``point_cloud_registration_tpu/parallel``)."""

from point_cloud_registration_tpu_torch.parallel import distributed
from point_cloud_registration_tpu_torch.parallel.map_sharded import (
    ShardedMapMeta,
    ShardedVoxelMap,
    align_map_sharded,
    make_map_mesh,
    shard_voxel_map,
    shard_voxel_map_on_mesh,
)
from point_cloud_registration_tpu_torch.parallel.mesh import make_mesh
from point_cloud_registration_tpu_torch.parallel.sharded import (
    STATS_FNS,
    align_batched_fused_sharded,
    align_batched_sharded,
    align_sharded,
)
