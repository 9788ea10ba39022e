from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, unet_config_for_res

__all__ = ["UNet2D", "UNet2DConfig", "unet_config_for_res"]
