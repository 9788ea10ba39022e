"""PyTorch/CUDA port of bndm_tpu for NVIDIA Hopper GPUs (see README.md)."""

__version__ = "0.1.0"

# the lazy top-level surface of bndm_tpu/__init__.py, name for name
_SURFACE = {
    "get_noise": ("bndm_tpu_torch.ops.noise", "get_noise"),
    "get_noise_v2": ("bndm_tpu_torch.ops.noise", "get_noise_v2"),
    "alpha_schedule": ("bndm_tpu_torch.ops.schedules", "alpha_schedule"),
    "gamma_schedule": ("bndm_tpu_torch.ops.schedules", "gamma_schedule"),
    "make_cov_L": ("bndm_tpu_torch.ops.cov", "make_cov_L"),
    "load_cov_L": ("bndm_tpu_torch.ops.cov", "load_cov_L"),
    "UNet2D": ("bndm_tpu_torch.models.unet2d", "UNet2D"),
    "UNet2DConfig": ("bndm_tpu_torch.models.unet2d", "UNet2DConfig"),
    "unet_config_for_res": ("bndm_tpu_torch.models.unet2d", "unet_config_for_res"),
    "AutoencoderKL": ("bndm_tpu_torch.models.vae", "AutoencoderKL"),
    "sample_iadb": ("bndm_tpu_torch.samplers.iadb", "sample_iadb"),
    "sample_iadb_microbatched": ("bndm_tpu_torch.samplers.iadb", "sample_iadb_microbatched"),
    "sample_iadb_cached": ("bndm_tpu_torch.samplers.iadb", "sample_iadb_cached"),
    "make_serving_sampler": ("bndm_tpu_torch.serving", "make_serving_sampler"),
    "make_validated_serving_sampler": ("bndm_tpu_torch.serving",
                                       "make_validated_serving_sampler"),
    "serving_model_pair": ("bndm_tpu_torch.serving", "serving_model_pair"),
    "make_serving_sampler_ddim": ("bndm_tpu_torch.serving", "make_serving_sampler_ddim"),
    "IADBScheduler": ("bndm_tpu_torch.samplers.iadb", "IADBScheduler"),
    "DDIMScheduler": ("bndm_tpu_torch.samplers.ddim", "DDIMScheduler"),
    "sample_ddim": ("bndm_tpu_torch.samplers.ddim", "sample_ddim"),
    "sample_ddim_cached": ("bndm_tpu_torch.samplers.ddim", "sample_ddim_cached"),
    "PixelTrainer": ("bndm_tpu_torch.train.pixel", "PixelTrainer"),
    "TrainConfig": ("bndm_tpu_torch.train.pixel", "TrainConfig"),
    "CheckpointManager": ("bndm_tpu_torch.ckpt.manager", "CheckpointManager"),
}


def __getattr__(name):
    """Lazy top-level re-exports (``import bndm_tpu_torch`` stays light)."""
    if name in _SURFACE:
        import importlib

        module, attr = _SURFACE[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'bndm_tpu_torch' has no attribute {name!r}")
