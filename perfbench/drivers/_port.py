"""The program's model configurations from a configuration file's ``port``
entry: its constructor arguments, lists read as tuples."""

from __future__ import annotations


def _args(entries):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in entries.items()}


def unet_config(port):
    """``UNet2DConfig`` from ``unet_config`` (every field) or from
    ``unet_config_for_res`` (the program's per-resolution layouts)."""
    from bndm_tpu_torch.models.unet2d import UNet2DConfig, unet_config_for_res

    if "unet_config" in port:
        return UNet2DConfig(**_args(port["unet_config"]))
    return unet_config_for_res(**port["unet_config_for_res"])


def vae_config(port):
    from bndm_tpu_torch.models.vae import VAEConfig

    return VAEConfig(**_args(port["vae_config"]))
