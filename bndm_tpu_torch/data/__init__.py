from bndm_tpu_torch.data.imagefolder import ImageFolderDataset

__all__ = ["ImageFolderDataset"]
