from bndm_tpu_torch.utils.image import resize_bilinear_align_corners, superres_condition
from bndm_tpu_torch.utils.metrics import psnr, ssim

__all__ = ["resize_bilinear_align_corners", "superres_condition", "ssim", "psnr"]
