"""UNet2D in PyTorch: the diffusers ``UNet2DModel`` subset the pipelines use.

Counterpart of ``bndm_tpu/models/unet2d.py``: DownBlock2D / AttnDownBlock2D /
UpBlock2D / AttnUpBlock2D, UNetMidBlock2D with attention, layers_per_block=2,
a sinusoidal timestep embedding that accepts *float* timesteps (IADB passes
the continuous blend factor alpha), GroupNorm(32, eps=1e-5) and the
per-resolution block layouts of the reference.

Numerics follow the JAX package. ``dtype`` is the compute dtype of convs,
linears and activations (parameters may stay fp32 and are cast at use, or
once with :meth:`UNet2D.cast_params_`); GroupNorm runs in ``norm_dtype``;
the attention softmax in ``attn_softmax_dtype``; ``conv_out`` in
``conv_out_dtype``. Module names are the diffusers state_dict names, so the
weights of the JAX package (through :mod:`bndm_tpu_torch.models.convert`) and
the reference's torch checkpoints load with ``strict=True``. Layout is NCHW
throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _mish(x):
    return x * torch.tanh(F.softplus(x))


ACT = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "mish": _mish,
    "relu": F.relu,
}

# fields of later tiers: they exist so configurations carry over, and a
# non-default value raises until its ROADMAP item lands
_LATER = {
    "conv_int8": (False, "the int8 serving tier (ROADMAP queue 1, item 9b)"),
    "int8_wide": (False, "the int8 serving tier (ROADMAP queue 1, item 9b)"),
    "fast_upsample": (False, "the latent pipeline's subpixel upsample "
                             "(ROADMAP queue 1, item 11)"),
    "gn_mode": ("dynamic", "the GroupNorm serving tiers (ROADMAP queue 1, "
                           "items 9c-9e)"),
    "cache_depth": (1, "the feature-reuse serving tier (ROADMAP queue 1, "
                       "item 9a)"),
    "dropout": (0.0, "training (ROADMAP queue 1, item 5)"),
}


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """Mirror of the diffusers UNet2DModel constructor subset in use."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "DownBlock2D", "DownBlock2D", "DownBlock2D",
        "AttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "AttnUpBlock2D", "UpBlock2D", "UpBlock2D",
        "UpBlock2D", "UpBlock2D",
    )
    layers_per_block: int = 2
    act_fn: str = "silu"
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    add_attention: bool = True  # mid-block attention
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    dropout: float = 0.0
    dtype: str = "float32"  # compute dtype ("bfloat16" for serving)
    norm_dtype: str = "float32"  # GroupNorm compute dtype (fp32 = diffusers parity)
    conv_int8: bool = False
    int8_mode: str = "dynamic"
    int8_wide: bool = False
    fast_upsample: bool = False
    gn_mode: str = "dynamic"
    gn_steps: int = 0
    conv_out_dtype: str = "float32"  # the final conv's compute/output dtype
    attn_softmax_dtype: str = "float32"  # fp32 = diffusers upcast_softmax
    cache_depth: int = 1

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def gn_dtype(self):
        return getattr(torch, self.norm_dtype)

    @property
    def softmax_dtype(self):
        return getattr(torch, self.attn_softmax_dtype)

    def check_supported(self):
        for name, (default, item) in _LATER.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"UNet2DConfig.{name}={getattr(self, name)!r} needs {item}, "
                    "which the PyTorch port does not have yet")


def unet_config_for_res(res, in_channels=3, out_channels=3, act_fn="silu", dtype="float32",
                        norm_dtype="float32", conv_int8=False,
                        int8_mode="dynamic"):
    """Per-resolution block layouts of the reference.

    res 64:  6 blocks (128,128,256,256,512,512), attn 5th down / 2nd up
    res 128: 7 blocks (128,128,128,256,256,512,512), attn 6th down / 2nd up
    res 256: 8 blocks (128,128,128,128,256,256,512,512), attn 7th down / 2nd up
    latent32 (256^2 pixels): 3 blocks (128,256,256), attn 3rd down / 1st up
    """
    if res == 64:
        boc = (128, 128, 256, 256, 512, 512)
        attn_down, attn_up = 4, 1
    elif res == 128:
        boc = (128, 128, 128, 256, 256, 512, 512)
        attn_down, attn_up = 5, 1
    elif res == 256:
        boc = (128, 128, 128, 128, 256, 256, 512, 512)
        attn_down, attn_up = 6, 1
    elif res == "latent32":
        boc = (128, 256, 256)
        attn_down, attn_up = 2, 0
    else:
        raise NotImplementedError(f"res {res}")
    n = len(boc)
    down = tuple(
        "AttnDownBlock2D" if i == attn_down else "DownBlock2D" for i in range(n)
    )
    up = tuple("AttnUpBlock2D" if i == attn_up else "UpBlock2D" for i in range(n))
    return UNet2DConfig(
        in_channels=in_channels,
        out_channels=out_channels,
        block_out_channels=boc,
        down_block_types=down,
        up_block_types=up,
        act_fn=act_fn,
        dtype=dtype,
        norm_dtype=norm_dtype,
        conv_int8=conv_int8,
        int8_mode=int8_mode,
    )


def get_timestep_embedding(timesteps, embedding_dim, flip_sin_to_cos=True,
                           downscale_freq_shift=0.0, max_period=10000.0):
    """Sinusoidal embedding of (possibly float) timesteps: (B,) -> (B, dim).

    diffusers ``get_timestep_embedding`` with UNet2DModel defaults: exponents
    over half_dim, then [cos | sin] when flipped.
    """
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``."""

    def __init__(self, in_features, out_features, compute_dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``."""

    def __init__(self, in_channels, out_channels, kernel_size, compute_dtype,
                 stride=1, padding=1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that normalizes in ``compute_dtype`` and returns it."""

    def __init__(self, num_groups, num_channels, eps, compute_dtype):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim, dtype):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, dtype)
        self.linear_2 = Linear(dim, dim, dtype)

    def forward(self, temb):
        return self.linear_2(F.silu(self.linear_1(temb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, act_fn="silu",
                 groups=32, eps=1e-5, dtype=torch.float32, norm_dtype=torch.float32):
        super().__init__()
        self.act = ACT[act_fn]
        self.dtype = dtype
        self.norm1 = GroupNorm(groups, in_channels, eps, norm_dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, dtype)
        self.time_emb_proj = Linear(temb_channels, out_channels, dtype)
        self.norm2 = GroupNorm(groups, out_channels, eps, norm_dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, dtype)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1, dtype, padding=0)
        else:
            self.conv_shortcut = None

    def forward(self, x, temb):
        h = self.act(self.norm1(x)).to(self.dtype)
        h = self.conv1(h)
        t = self.time_emb_proj(self.act(temb).to(self.dtype))
        h = h + t[:, :, None, None]
        h = self.act(self.norm2(h)).to(self.dtype)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over (H*W) tokens with a residual: the diffusers
    Attention module as the UNet2D blocks build it (bias, upcast softmax,
    heads = channels // attention_head_dim), written out as product,
    softmax, product."""

    def __init__(self, channels, head_dim=8, groups=32, eps=1e-5, dtype=torch.float32,
                 norm_dtype=torch.float32, softmax_dtype=torch.float32):
        super().__init__()
        self.heads = max(1, channels // head_dim)
        self.dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.group_norm = GroupNorm(groups, channels, eps, norm_dtype)
        self.to_q = Linear(channels, channels, dtype)
        self.to_k = Linear(channels, channels, dtype)
        self.to_v = Linear(channels, channels, dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        heads = self.heads
        dh = c // heads
        residual = x
        h = self.group_norm(x).to(self.dtype).reshape(b, c, hh * ww).transpose(1, 2)
        q = self.to_q(h).reshape(b, -1, heads, dh)
        k = self.to_k(h).reshape(b, -1, heads, dh)
        v = self.to_v(h).reshape(b, -1, heads, dh)
        scale = 1.0 / math.sqrt(dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(self.softmax_dtype) * scale
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, hh * ww, c)
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(b, c, hh, ww) + residual


class Downsample2D(nn.Module):
    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _resnet(cfg, cin, cout, temb_channels):
    return ResnetBlock2D(cin, cout, temb_channels, cfg.act_fn, cfg.norm_num_groups,
                         cfg.norm_eps, cfg.compute_dtype, cfg.gn_dtype)


def _attention(cfg, channels):
    return AttentionBlock(channels, cfg.attention_head_dim, cfg.norm_num_groups,
                          cfg.norm_eps, cfg.compute_dtype, cfg.gn_dtype,
                          cfg.softmax_dtype)


class DownBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers,
                 with_attn, add_downsample, cfg):
        super().__init__()
        self.resnets = nn.ModuleList([
            _resnet(cfg, in_channels if i == 0 else out_channels, out_channels,
                    temb_channels)
            for i in range(num_layers)])
        if with_attn:
            self.attentions = nn.ModuleList(
                [_attention(cfg, out_channels) for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_channels, cfg.compute_dtype)])

    def forward(self, x, temb):
        skips = []
        attentions = getattr(self, "attentions", None)
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if attentions is not None:
                x = attentions[i](x)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock2D(nn.Module):
    """``resnet_in_channels[i]``: channels of concat([x, skip]) at resnet i."""

    def __init__(self, resnet_in_channels, out_channels, temb_channels, with_attn,
                 add_upsample, cfg):
        super().__init__()
        self.resnets = nn.ModuleList([
            _resnet(cfg, cin, out_channels, temb_channels) for cin in resnet_in_channels])
        if with_attn:
            self.attentions = nn.ModuleList(
                [_attention(cfg, out_channels) for _ in resnet_in_channels])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, cfg.compute_dtype)])

    def forward(self, x, skips, temb):
        attentions = getattr(self, "attentions", None)
        for i, resnet in enumerate(self.resnets):
            skip = skips.pop()
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
            x = resnet(x, temb)
            if attentions is not None:
                x = attentions[i](x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels, temb_channels, cfg):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_resnet(cfg, channels, channels, temb_channels) for _ in range(2)])
        if cfg.add_attention:
            self.attentions = nn.ModuleList([_attention(cfg, channels)])

    def forward(self, x, temb):
        x = self.resnets[0](x, temb)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class UNet2D(nn.Module):
    """Full UNet: ``forward(x_NCHW, timesteps) -> out_NCHW``.

    Parameters are created on ``device`` (``"meta"`` allocates nothing) in
    fp32; the output is in ``cfg.conv_out_dtype``.
    """

    def __init__(self, cfg: UNet2DConfig, device=None):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        dt = cfg.compute_dtype
        boc = cfg.block_out_channels
        n = len(boc)
        temb_dim = boc[0] * 4
        with torch.device(device or "cpu"):
            self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, dt)
            self.time_embedding = TimestepEmbedding(boc[0], temb_dim, dt)
            skip_ch = [boc[0]]
            ch = boc[0]
            self.down_blocks = nn.ModuleList()
            for i, c in enumerate(boc):
                self.down_blocks.append(DownBlock2D(
                    ch, c, temb_dim, cfg.layers_per_block,
                    with_attn=cfg.down_block_types[i] == "AttnDownBlock2D",
                    add_downsample=i < n - 1, cfg=cfg))
                skip_ch += [c] * (cfg.layers_per_block + (i < n - 1))
                ch = c
            self.mid_block = UNetMidBlock2D(ch, temb_dim, cfg)
            self.up_blocks = nn.ModuleList()
            for i, c in enumerate(reversed(boc)):
                ins = []
                for _ in range(cfg.layers_per_block + 1):
                    ins.append(ch + skip_ch.pop())
                    ch = c
                self.up_blocks.append(UpBlock2D(
                    ins, c, temb_dim,
                    with_attn=cfg.up_block_types[i] == "AttnUpBlock2D",
                    add_upsample=i < n - 1, cfg=cfg))
            self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], cfg.norm_eps,
                                           cfg.gn_dtype)
            self.conv_out = Conv2d(boc[0], cfg.out_channels, 3,
                                   getattr(torch, cfg.conv_out_dtype))
        self.act = ACT[cfg.act_fn]

    def cast_params_(self):
        """Store each conv/linear weight in the dtype it computes in (the
        norms and ``conv_out`` stay as configured): the same rounding as the
        per-call cast, done once. Returns self."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d, GroupNorm)):
                m.to(m.compute_dtype)
        return self

    def forward(self, x, timesteps):
        cfg = self.cfg
        dt = cfg.compute_dtype
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                      cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb)

        h = self.conv_in(x.to(dt))
        skips = [h]
        for block in self.down_blocks:
            h, s = block(h, temb)
            skips.extend(s)
        h = self.mid_block(h, temb)
        for block in self.up_blocks:
            h = block(h, skips, temb)
        h = self.act(self.conv_norm_out(h)).to(dt)
        return self.conv_out(h)
