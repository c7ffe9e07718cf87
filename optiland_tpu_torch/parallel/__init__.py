from optiland_tpu_torch.parallel.mesh import (
    CHIP_AXIS,
    HOST_AXIS,
    RAY_AXIS,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    pad_to_multiple,
    ray_sharding,
    ray_sharding_2d,
    replicated_sharding,
    shard_rays,
)

__all__ = [
    "RAY_AXIS",
    "HOST_AXIS",
    "CHIP_AXIS",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "pad_to_multiple",
    "ray_sharding",
    "ray_sharding_2d",
    "replicated_sharding",
    "shard_rays",
]
