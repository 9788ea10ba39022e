from bndm_tpu_torch.samplers.iadb import iadb_step, sample_iadb

__all__ = ["sample_iadb", "iadb_step"]
