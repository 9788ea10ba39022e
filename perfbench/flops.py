"""Operations of the models' forward passes, counted from the reference's
modules at a cell's shapes (``torch.utils.flop_counter`` over tensors on
the meta device: no memory, no arithmetic). A multiply-add is two
operations; the counter counts convolutions, matrix products and
attention's two products, nothing elementwise."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import nets


def _meta(spec):
    return {k: torch.empty(s, device="meta") for k, s in spec.items()}


def _count(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@functools.cache
def _unet(key, batch, res):
    cfg = dict(key)
    x = torch.empty((batch, cfg["in_channels"], res, res), device="meta")
    t = torch.empty((batch,), device="meta")
    return _count(nets.unet, _meta(nets.unet_spec(cfg)), cfg, x, t)


def unet_forward(cfg, batch, res):
    """FLOPs of one UNet forward of ``cfg`` at (batch, res, res)."""
    return _unet(_key(cfg), batch, res)


@functools.cache
def _vae(key, batch, res):
    cfg = dict(key)
    z = torch.empty((batch, cfg["latent_channels"], res, res), device="meta")
    return _count(nets.vae_decode, _meta(nets.vae_decode_spec(cfg)), cfg, z)


def vae_decode(cfg, batch, latent_res):
    """FLOPs of decoding ``batch`` latents of ``latent_res``^2."""
    return _vae(_key(cfg), batch, latent_res)


def _key(cfg):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()))
