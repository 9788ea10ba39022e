"""AutoencoderKL in PyTorch: the SD VAE of the latent pipeline.

Counterpart of ``bndm_tpu/models/vae.py``: down/up blocks (128, 256, 512,
512), layers_per_block=2, GroupNorm(32, eps=1e-6), silu, the downsample's
asymmetric (0, 1) pad and stride-2 VALID conv, the single-head mid
attention over all channels, the upsample as nearest-2x + 3x3 conv (the
same function as the JAX VAE's subpixel form), ``conv_out``
in fp32, logvar clipped to (-30, 20), and the SD scaling 0.18215. Module
names are the diffusers state_dict names (``encoder.down_blocks.N...``,
``decoder.up_blocks.N...``, ``quant_conv``, ``post_quant_conv``), so a JAX
VAE's params cross through ``models/convert.py::state_dict_from_flax``.
Layout is NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bndm_tpu_torch.models.unet2d import (ACT, AttentionBlock, Conv2d, GroupNorm,
                                          ResnetBlock2D, Upsample2D)
from bndm_tpu_torch.utils.timing import span

SD_SCALING = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    act_fn: str = "silu"
    dtype: str = "float32"

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)


def _resnet(cfg, cin, cout):
    return ResnetBlock2D(cin, cout, None, cfg.act_fn, cfg.norm_num_groups, cfg.norm_eps,
                         cfg.compute_dtype)


class _Downsample(nn.Module):
    """Right/bottom pad by one, then a stride-2 VALID 3x3 conv."""

    def __init__(self, channels, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Block(nn.Module):
    """An encoder down block or a decoder up block: resnets, then the
    resampler (``downsamplers`` or ``upsamplers``) if any."""

    def __init__(self, cfg, cin, cout, num_layers, resample):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cfg, cin if i == 0 else cout, cout)
                                      for i in range(num_layers)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Downsample(cout, cfg.compute_dtype)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(cout, cfg.compute_dtype)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x, None)
        for s in getattr(self, "downsamplers", ()) or getattr(self, "upsamplers", ()):
            x = s(x)
        return x


class _Mid(nn.Module):
    def __init__(self, cfg, c):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cfg, c, c), _resnet(cfg, c, c)])
        # single-head attention over the full channel dimension
        self.attentions = nn.ModuleList([AttentionBlock(
            c, head_dim=c, groups=cfg.norm_num_groups, eps=cfg.norm_eps,
            dtype=cfg.compute_dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x, None)), None)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        boc = cfg.block_out_channels
        self.act = ACT[cfg.act_fn]
        self.dtype = dt
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, dt)
        self.down_blocks = nn.ModuleList([
            _Block(cfg, boc[max(i - 1, 0)], c, cfg.layers_per_block,
                   "down" if i < len(boc) - 1 else None) for i, c in enumerate(boc)])
        self.mid_block = _Mid(cfg, boc[-1])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[-1], cfg.norm_eps, torch.float32)
        self.conv_out = Conv2d(boc[-1], 2 * cfg.latent_channels, 3, dt)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(self.act(self.conv_norm_out(h)).to(self.dtype))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.compute_dtype
        rev = tuple(reversed(cfg.block_out_channels))
        self.act = ACT[cfg.act_fn]
        self.dtype = dt
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, dt)
        self.mid_block = _Mid(cfg, rev[0])
        self.up_blocks = nn.ModuleList([
            _Block(cfg, rev[max(i - 1, 0)], c, cfg.layers_per_block + 1,
                   "up" if i < len(rev) - 1 else None) for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1], cfg.norm_eps, torch.float32)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, torch.float32)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(self.act(self.conv_norm_out(h)).to(self.dtype))


class AutoencoderKL(nn.Module):
    """``encode`` (images in [-1, 1] -> scaled latents) and ``decode``
    (scaled latents -> images), NCHW. Parameters are created on ``device``
    in fp32; the modules compute in ``cfg.dtype``."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        with torch.device(device or "cpu"):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, dt,
                                     padding=0)
            self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1, dt,
                                          padding=0)

    def encode_moments(self, x):
        """x in [-1, 1] -> (mean, logvar), each (B, latent_c, H/8, W/8), fp32."""
        m = self.quant_conv(self.encoder(x.to(self.cfg.compute_dtype))).float()
        mean, logvar = torch.chunk(m, 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, generator=None, eps=None):
        """The posterior's mean (neither ``generator`` nor ``eps``), or a
        sample ``mean + exp(logvar / 2) * eps`` with ``eps`` given or drawn
        from ``generator``; scaled by 0.18215."""
        mean, logvar = self.encode_moments(x)
        if eps is None and generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        return SD_SCALING * z

    def decode(self, z):
        """Scaled latents -> image in [-1, 1] (fp32)."""
        h = self.post_quant_conv((z / SD_SCALING).to(self.cfg.compute_dtype))
        return self.decoder(h)

    def forward(self, x, generator=None):
        return self.decode(self.encode(x, generator))


def make_decoder(vae, microbatch=None):
    """``decode(z)`` under ``torch.no_grad``, optionally microbatched.

    The full-batch 512^2 decode holds (B, 256, 512, 512) activations at
    once; with ``microbatch`` set the batch is decoded in chunks of that
    size, one chunk's activations alive at a time. A batch the microbatch
    does not divide is zero-padded to the next multiple, so every chunk has
    the same shape, and cut back. Decoding is per sample (GroupNorm
    normalizes within each sample), so the chunks give the full batch's
    values; bit for bit where the library's convolutions compute a sample
    the same way at either batch size (XLA's do; oneDNN's on one CPU thread
    do at a batch of 2 and more, not at 1; cuDNN may choose another
    algorithm per batch size)."""

    def chunk(z):
        with span("vae.decode"):
            return vae.decode(z)

    @torch.no_grad()
    def decode(z):
        if not microbatch:
            return chunk(z)
        b = z.shape[0]
        mb = min(microbatch, b)
        pad = (-b) % mb
        if pad:
            z = torch.cat([z, z.new_zeros((pad,) + tuple(z.shape[1:]))])
        return torch.cat([chunk(zc) for zc in torch.split(z, mb)])[:b]

    return decode
