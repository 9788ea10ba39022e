from bndm_tpu_torch.utils.image import resize_bilinear_align_corners, superres_condition
from bndm_tpu_torch.utils.metrics import psnr, ssim
from bndm_tpu_torch.utils.timing import Timer, timed_call

__all__ = ["resize_bilinear_align_corners", "superres_condition", "ssim", "psnr", "Timer",
           "timed_call"]
