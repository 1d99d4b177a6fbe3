"""Training and extraction across GPUs (counterpart of
:mod:`bvc_tpu.parallel`): the process group, the mesh (``data``, ``seq``,
``model`` and ``pipe`` axes), the collectives, the parameter layouts (DDP,
ZeRO-1, FSDP2, head-parallel tensor parallelism), the sequence-parallel
steps and embeds (``seqpar``), the GPipe step (``pipeline``), and the
accounting of what each layout communicates (``analysis``:
:func:`record_collectives`, :class:`CommReport`, each step's
``comm_report``)."""

from bvc_tpu_torch.parallel.analysis import (  # noqa: F401
    CollectiveOp,
    CommReport,
    UnrecordedCollective,
    comm_report,
    record_collectives,
    tree_bytes,
)

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
