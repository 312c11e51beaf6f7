"""Scale-out over ``torch.distributed`` (port of ``cut3r_slam_tpu/
parallel/``): one process per device, SPMD. ``mesh`` holds the process
group and mesh helpers, ``mapping`` the view-parallel Gaussian mapping,
``inference`` the batch-sharded and tensor-parallel CUT3R forwards."""
from .mesh import (init_distributed, make_mesh, shard_batch,  # noqa: F401
                   replicate, fsdp_shard_params, mesh_size)
