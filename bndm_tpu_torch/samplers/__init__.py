from bndm_tpu_torch.samplers.ddim import DDIMScheduler, sample_ddim
from bndm_tpu_torch.samplers.iadb import (
    IADBScheduler, iadb_step, sample_iadb, sample_iadb_cached, sample_iadb_microbatched,
)

__all__ = ["sample_iadb", "sample_iadb_cached", "sample_iadb_microbatched", "IADBScheduler",
           "iadb_step", "DDIMScheduler", "sample_ddim"]
