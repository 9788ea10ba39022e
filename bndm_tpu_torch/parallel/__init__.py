"""Data parallelism over ranks (``torch.distributed``), the counterpart of
``bndm_tpu/parallel``."""

from bndm_tpu_torch.parallel.distributed import (
    barrier,
    global_mesh,
    groups_by_host,
    host_shard_info,
    hybrid_layout,
    hybrid_mesh,
    init_distributed,
    shutdown,
)
from bndm_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    auto_layout,
    auto_mesh,
    block_rows,
    data_shard,
    gather_batch,
    local_rows,
    replicate,
    run_mesh,
    shard_batch,
    wrap_ddp,
)

__all__ = [
    "auto_mesh",
    "auto_layout",
    "shard_batch",
    "gather_batch",
    "local_rows",
    "replicate",
    "run_mesh",
    "data_shard",
    "block_rows",
    "all_reduce_sum_",
    "wrap_ddp",
    "init_distributed",
    "global_mesh",
    "hybrid_mesh",
    "hybrid_layout",
    "groups_by_host",
    "host_shard_info",
    "barrier",
    "shutdown",
]
