from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset

__all__ = ["BatchLoader", "ImageFolderDataset"]
