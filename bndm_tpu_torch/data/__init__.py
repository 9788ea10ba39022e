from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset
from bndm_tpu_torch.data.latent_cache import LatentCacheDataset, LatentCacheWriter

__all__ = ["BatchLoader", "ImageFolderDataset", "LatentCacheWriter", "LatentCacheDataset"]
