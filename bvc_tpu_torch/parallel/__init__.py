"""Data-parallel training and extraction across GPUs: the process group, the
mesh, the collectives and DDP (counterpart of :mod:`bvc_tpu.parallel`,
slice 7a of the port)."""

from bvc_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_grad,
    all_gather_objects,
    all_reduce_grad,
    psum_scalar,
    sync_hosts,
)
from bvc_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    distributed_init,
    make_mesh,
    rank,
    world_size,
)
from bvc_tpu_torch.parallel.sharding import (  # noqa: F401
    host_local_batch_slice,
    param_shardings,
    wrap_data_parallel,
)
