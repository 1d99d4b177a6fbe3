"""Training and extraction across GPUs: the process group, the mesh
(``data`` and ``model`` axes), the collectives, and the parameter layouts
(DDP, ZeRO-1, FSDP2, head-parallel tensor parallelism) (counterpart of
:mod:`bvc_tpu.parallel`, slices 7a and 7b of the port)."""

from bvc_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_grad,
    all_gather_objects,
    all_reduce_grad,
    copy_to_model,
    psum_scalar,
    reduce_from_model,
    sync_hosts,
)
from bvc_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    current_mesh,
    data_rank,
    data_size,
    distributed_init,
    make_mesh,
    rank,
    world_size,
)
from bvc_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingPlan,
    host_local_batch_slice,
    param_shardings,
    wrap_data_parallel,
)
