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
throughout. ``dropout`` drops inside each resnet in train mode only;
``fast_upsample`` is accepted for the JAX config's sake: its subpixel form
is the same function as the plain nearest-2x + 3x3 conv, computed so.

Serving tiers (the JAX package's ``UNet2D`` fields of the same names):
``conv_int8``/``int8_mode``/``int8_wide`` swap conv sites for
:class:`~bndm_tpu_torch.ops.int8.Int8Conv2d`, ``gn_mode``/``gn_steps``
swap the GroupNorms for :class:`~bndm_tpu_torch.ops.static_norm.CalGroupNorm`,
and ``cache_depth`` sets the split point of the feature-reuse forward
(``return_deep`` / ``deep_feature``). Their calibrated constants and
carried statistics are buffers outside the state_dict:
:meth:`UNet2D.quant_state` / :meth:`UNet2D.load_quant` and
:meth:`UNet2D.gnstats` / :meth:`UNet2D.load_gnstats`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bndm_tpu_torch.ops.int8 import Int8Conv2d
from bndm_tpu_torch.ops.static_norm import CalGroupNorm, gn_step_index


def _mish(x):
    return x * torch.tanh(F.softplus(x))


ACT = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "mish": _mish,
    "relu": F.relu,
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
    def int8_arg(self):
        """Value for the conv sites: False (fp conv) or the int8 mode."""
        return self.int8_mode if self.conv_int8 else False

    @property
    def int8_wide_arg(self):
        """int8 mode for the normally-fp sites (shortcut, downsampler,
        conv_in), only under int8_wide."""
        return self.int8_mode if (self.conv_int8 and self.int8_wide) else False

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def gn_dtype(self):
        return getattr(torch, self.norm_dtype)

    @property
    def softmax_dtype(self):
        return getattr(torch, self.attn_softmax_dtype)


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
    """``nn.GroupNorm`` that normalizes in ``compute_dtype`` and returns it.
    ``step_idx`` is accepted and unused, as by the calibrated norms."""

    def __init__(self, num_groups, num_channels, eps, compute_dtype):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x, step_idx=None):
        dt = self.compute_dtype
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


def _gn(groups, channels, eps, dtype, mode="dynamic", steps=0):
    """The dynamic GroupNorm, or a CalGroupNorm in ``mode``."""
    if mode == "dynamic":
        return GroupNorm(groups, channels, eps, dtype)
    return CalGroupNorm(groups, channels, eps, dtype, mode, steps)


def _conv(int8, cin, cout, kernel_size, dtype, stride=1, padding=1):
    """The fp conv, or an Int8Conv2d when ``int8`` names a mode (True means
    'dynamic'); both have the same parameters."""
    if int8:
        mode = int8 if isinstance(int8, str) else "dynamic"
        return Int8Conv2d(cin, cout, kernel_size, dtype, mode, stride=stride, padding=padding)
    return Conv2d(cin, cout, kernel_size, dtype, stride=stride, padding=padding)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim, dtype):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, dtype)
        self.linear_2 = Linear(dim, dim, dtype)

    def forward(self, temb):
        return self.linear_2(F.silu(self.linear_1(temb)))


class ResnetBlock2D(nn.Module):
    """``int8``: the int8 mode of conv1/conv2 (False: fp); the shortcut
    takes it too only under ``int8_wide``. ``temb_channels=None``: no time
    conditioning (the VAE's resnets). ``dropout`` > 0 drops after the
    second norm in train mode only."""

    def __init__(self, in_channels, out_channels, temb_channels, act_fn="silu",
                 groups=32, eps=1e-5, dtype=torch.float32, norm_dtype=torch.float32,
                 *, int8=False, int8_wide=False, gn_mode="dynamic", gn_steps=0, dropout=0.0):
        super().__init__()
        self.act = ACT[act_fn]
        self.dtype = dtype
        self.norm1 = _gn(groups, in_channels, eps, norm_dtype, gn_mode, gn_steps)
        self.conv1 = _conv(int8, in_channels, out_channels, 3, dtype)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, out_channels, dtype)
        self.norm2 = _gn(groups, out_channels, eps, norm_dtype, gn_mode, gn_steps)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        self.conv2 = _conv(int8, out_channels, out_channels, 3, dtype)
        if in_channels != out_channels:
            self.conv_shortcut = _conv(int8 if int8_wide else False, in_channels,
                                       out_channels, 1, dtype, padding=0)
        else:
            self.conv_shortcut = None

    def forward(self, x, temb, step_idx=None):
        h = self.act(self.norm1(x, step_idx)).to(self.dtype)
        h = self.conv1(h)
        if temb is not None:
            t = self.time_emb_proj(self.act(temb).to(self.dtype))
            h = h + t[:, :, None, None]
        h = self.act(self.norm2(h, step_idx)).to(self.dtype)
        if self.dropout is not None:
            h = self.dropout(h)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _softmax(logits):
    """Softmax over the last axis in ``logits``' dtype. fp32: one
    ``torch.softmax``. Narrower: the JAX package's rounding points as XLA
    fuses ``jax.nn.softmax`` there: the difference from the row max and the
    numerator's exp round to the dtype, the row sum adds the unrounded exp
    in fp32 and rounds once, and the quotient stays fp32 (the caller's cast
    rounds it)."""
    if logits.dtype == torch.float32:
        return torch.softmax(logits, dim=-1)
    dt = logits.dtype
    d = (logits - logits.amax(dim=-1, keepdim=True)).float()
    e = torch.exp(d)
    s = e.sum(dim=-1, keepdim=True).to(dt).float()
    return e.to(dt).float() / s


class AttentionBlock(nn.Module):
    """Spatial self-attention over (H*W) tokens with a residual: the diffusers
    Attention module as the UNet2D blocks build it (bias, upcast softmax,
    heads = channels // attention_head_dim), written out as product,
    softmax, product."""

    def __init__(self, channels, head_dim=8, groups=32, eps=1e-5, dtype=torch.float32,
                 norm_dtype=torch.float32, softmax_dtype=torch.float32, *,
                 gn_mode="dynamic", gn_steps=0):
        super().__init__()
        self.heads = max(1, channels // head_dim)
        self.dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.group_norm = _gn(groups, channels, eps, norm_dtype, gn_mode, gn_steps)
        self.to_q = Linear(channels, channels, dtype)
        self.to_k = Linear(channels, channels, dtype)
        self.to_v = Linear(channels, channels, dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype)])

    def forward(self, x, step_idx=None):
        b, c, hh, ww = x.shape
        heads = self.heads
        dh = c // heads
        residual = x
        h = self.group_norm(x, step_idx).to(self.dtype).reshape(b, c, hh * ww).transpose(1, 2)
        q = self.to_q(h).reshape(b, -1, heads, dh)
        k = self.to_k(h).reshape(b, -1, heads, dh)
        v = self.to_v(h).reshape(b, -1, heads, dh)
        scale = 1.0 / math.sqrt(dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(self.softmax_dtype) * scale
        attn = _softmax(logits).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, hh * ww, c)
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(b, c, hh, ww) + residual


class Downsample2D(nn.Module):
    def __init__(self, channels, dtype=torch.float32, int8=False):
        super().__init__()
        self.conv = _conv(int8, channels, channels, 3, dtype, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv. The JAX package's subpixel form
    (its ``fast_upsample``, and the VAE's upsample) is the same function:
    here both are computed this way."""

    def __init__(self, channels, dtype=torch.float32, int8=False):
        super().__init__()
        self.conv = _conv(int8, channels, channels, 3, dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _resnet(cfg, cin, cout, temb_channels):
    return ResnetBlock2D(cin, cout, temb_channels, cfg.act_fn, cfg.norm_num_groups,
                         cfg.norm_eps, cfg.compute_dtype, cfg.gn_dtype, int8=cfg.int8_arg,
                         int8_wide=cfg.int8_wide, gn_mode=cfg.gn_mode, gn_steps=cfg.gn_steps,
                         dropout=cfg.dropout)


def _attention(cfg, channels):
    return AttentionBlock(channels, cfg.attention_head_dim, cfg.norm_num_groups,
                          cfg.norm_eps, cfg.compute_dtype, cfg.gn_dtype,
                          cfg.softmax_dtype, gn_mode=cfg.gn_mode, gn_steps=cfg.gn_steps)


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
            # fp even under conv_int8 unless int8_wide, as in the JAX package
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_channels, cfg.compute_dtype, cfg.int8_wide_arg)])

    def forward(self, x, temb, step_idx=None, downsample=True):
        """``downsample=False`` leaves the downsampler out (the shallow
        forward's innermost shell block, whose downsampled output only the
        trunk reads)."""
        skips = []
        attentions = getattr(self, "attentions", None)
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, step_idx)
            if attentions is not None:
                x = attentions[i](x, step_idx)
            skips.append(x)
        if downsample and hasattr(self, "downsamplers"):
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
            self.upsamplers = nn.ModuleList(
                [Upsample2D(out_channels, cfg.compute_dtype, cfg.int8_arg)])

    def forward(self, x, skips, temb, step_idx=None):
        attentions = getattr(self, "attentions", None)
        for i, resnet in enumerate(self.resnets):
            skip = skips.pop()
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
            x = resnet(x, temb, step_idx)
            if attentions is not None:
                x = attentions[i](x, step_idx)
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

    def forward(self, x, temb, step_idx=None):
        x = self.resnets[0](x, temb, step_idx)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x, step_idx)
        return self.resnets[1](x, temb, step_idx)


_QUANT_BUFFERS = ("act_amax", "gn_mean", "gn_var")


class UNet2D(nn.Module):
    """Full UNet: ``forward(x_NCHW, timesteps) -> out_NCHW``.

    Parameters are created on ``device`` (``"meta"`` allocates nothing) in
    fp32; the output is in ``cfg.conv_out_dtype``.

    Feature-reuse serving (``cfg.cache_depth``):
      * ``return_deep=True`` also returns the trunk output: the input of the
        outermost ``cache_depth`` up blocks (the output of up block
        n - cache_depth - 1 with its upsampler), NCHW, compute dtype.
      * ``deep_feature=<that tensor>`` runs only the outer shell: conv_in,
        down blocks [0, cache_depth) for their skips, up blocks
        [n - cache_depth, n) and conv_out, with ``deep_feature`` in place of
        the trunk. With the deep feature of the same (x, t) this is the full
        forward; a cached step passes the last full step's.
    """

    def __init__(self, cfg: UNet2DConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        boc = cfg.block_out_channels
        n = len(boc)
        temb_dim = boc[0] * 4
        with torch.device(device or "cpu"):
            # fp even under conv_int8 unless int8_wide (3 input channels)
            self.conv_in = _conv(cfg.int8_wide_arg, cfg.in_channels, boc[0], 3, dt)
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
            self.conv_norm_out = _gn(cfg.norm_num_groups, boc[0], cfg.norm_eps,
                                     cfg.gn_dtype, cfg.gn_mode, cfg.gn_steps)
            self.conv_out = Conv2d(boc[0], cfg.out_channels, 3,
                                   getattr(torch, cfg.conv_out_dtype))
        self.act = ACT[cfg.act_fn]

    def cast_params_(self):
        """Store each conv/linear weight in the dtype it computes in (the
        norms and ``conv_out`` stay as configured; int8 convs and calibrated
        norms keep fp32, which their scales and statistics are computed
        from): the same rounding as the per-call cast, done once. Returns
        self."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d, GroupNorm)):
                m.to(m.compute_dtype)
        return self

    def quant_state(self):
        """The calibrated constants, ``{"<module>.<buffer>": tensor}``: each
        int8 site's ``act_amax`` and each calibrated norm's
        ``gn_mean``/``gn_var`` tables (the buffers themselves)."""
        return {f"{name}.{b}": getattr(m, b) for name, m in self.named_modules()
                for b in _QUANT_BUFFERS if getattr(m, b, None) is not None}

    def load_quant(self, quant):
        """Set every calibrated constant from ``quant`` (as
        :meth:`quant_state` names them; extra entries, such as the GN tables
        a drift carry reads, are left alone). Raises on a missing one."""
        with torch.no_grad():
            for key, buf in self.quant_state().items():
                if key not in quant:
                    raise KeyError(f"no calibrated value for {key}")
                buf.copy_(quant[key])
        return self

    def gnstats(self):
        """The per-sample GroupNorm statistics the last ``gn_mode='record'``
        forward kept: ``{"<module>.mu": (B, G), "<module>.rstd": (B, G)}``."""
        return {f"{name}.{b}": getattr(m, b) for name, m in self.named_modules()
                if isinstance(m, CalGroupNorm) and m.mode == "record" for b in ("mu", "rstd")}

    def load_gnstats(self, stats):
        """Hand a record forward's statistics to this ``gn_mode='reuse'``
        model's norms."""
        for name, m in self.named_modules():
            if isinstance(m, CalGroupNorm) and m.mode == "reuse":
                m.mu, m.rstd = stats[f"{name}.mu"], stats[f"{name}.rstd"]
        return self

    def forward(self, x, timesteps, step_idx=None, deep_feature=None, return_deep=False):
        cfg = self.cfg
        dt = cfg.compute_dtype
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(x.shape[0])
        if step_idx is None and cfg.gn_mode in ("calibrate", "static"):
            # IADB's timestep is alpha = (t+1)/T: with linear alpha this is t
            step_idx = gn_step_index(timesteps, cfg.gn_steps)
        temb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                      cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb)

        h = self.conv_in(x.to(dt))
        skips = [h]
        n = len(cfg.block_out_channels)
        depth = cfg.cache_depth
        shallow = deep_feature is not None
        if shallow and return_deep:
            raise ValueError("a shallow (cached) call cannot return_deep")
        if (shallow or return_deep) and not (1 <= depth < n):
            raise ValueError(f"cache_depth {depth} must be in [1, {n - 1}]")
        for i in range(depth if shallow else n):
            # shallow: block depth-1's downsampled output feeds only the trunk
            ds = (i < depth - 1) if shallow else True
            h, s = self.down_blocks[i](h, temb, step_idx, downsample=ds)
            skips.extend(s)
        if shallow:
            deep = None
            h = deep_feature.to(dt)
        else:
            h = self.mid_block(h, temb, step_idx)
            for block in self.up_blocks[:n - depth]:
                h = block(h, skips, temb, step_idx)
            deep = h  # the trunk output: input of the outer-shell up blocks
        for block in self.up_blocks[n - depth:]:
            h = block(h, skips, temb, step_idx)
        h = self.act(self.conv_norm_out(h, step_idx)).to(dt)
        out = self.conv_out(h)
        return (out, deep) if return_deep else out
