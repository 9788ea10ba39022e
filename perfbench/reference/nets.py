"""Plain float32 forward passes of the diffusers UNet2DModel subset and of
the SD VAE's decoder, written as functions over a dict of parameters named
as the diffusers state_dict names them.

The UNet: conv_in; a sinusoidal embedding of the (float) timestep with cos
first, then linear, SiLU, linear; per resolution ``layers_per_block``
resnets (GroupNorm, SiLU, 3x3 conv, plus the projected embedding,
GroupNorm, SiLU, 3x3 conv, a 1x1 shortcut where the width changes),
self-attention after each resnet of an attention block (heads of
``attention_head_dim`` channels, softmax in float32), a stride-2 3x3 conv
to go down; the middle block resnet, attention, resnet; up blocks of
``layers_per_block + 1`` resnets over the concatenated skips, nearest 2x
and a 3x3 conv to go up; GroupNorm, SiLU, 3x3 conv_out. Its outer shell
(``unet_shell``) runs the outermost blocks around a given trunk output, as
the feature-reuse sampler's cached steps do. The decoder:
post_quant_conv (1x1) of ``z / 0.18215``, conv_in, the middle block with
one single-head attention over all channels, four up blocks of three
resnets (without a time embedding), GroupNorm, SiLU, conv_out.

``q`` is applied to every operand of a convolution and of a linear layer:
the identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SD_SCALING = 0.18215


def exact(t):
    return t


def conv(P, name, x, q, stride=1, padding=None):
    w = P[name + ".weight"]
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(q(x), q(w), q(P[name + ".bias"]), stride=stride, padding=padding)


def linear(P, name, x, q):
    return F.linear(q(x), q(P[name + ".weight"]), q(P[name + ".bias"]))


def group_norm(P, name, x, groups, eps):
    return F.group_norm(x, groups, P[name + ".weight"], P[name + ".bias"], eps)


def resnet(P, name, x, temb, q, groups, eps):
    h = conv(P, name + ".conv1", F.silu(group_norm(P, name + ".norm1", x, groups, eps)), q)
    if temb is not None:
        h = h + linear(P, name + ".time_emb_proj", F.silu(temb), q)[:, :, None, None]
    h = conv(P, name + ".conv2", F.silu(group_norm(P, name + ".norm2", h, groups, eps)), q)
    if x.shape[1] != h.shape[1]:
        x = conv(P, name + ".conv_shortcut", x, q, padding=0)
    return x + h


def attention(P, name, x, q, head_dim, groups, eps):
    b, c, hh, ww = x.shape
    heads = max(1, c // head_dim)
    dh = c // heads
    h = group_norm(P, name + ".group_norm", x, groups, eps).reshape(b, c, hh * ww).transpose(1, 2)
    qq = linear(P, name + ".to_q", h, q).reshape(b, -1, heads, dh)
    kk = linear(P, name + ".to_k", h, q).reshape(b, -1, heads, dh)
    vv = linear(P, name + ".to_v", h, q).reshape(b, -1, heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q(qq), q(kk)) / math.sqrt(dh)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", q(attn), q(vv)).reshape(b, hh * ww, c)
    out = linear(P, name + ".to_out.0", out, q)
    return out.transpose(1, 2).reshape(b, c, hh, ww) + x


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    emb = freqs[None, :] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def _embedding(P, cfg, t, q):
    temb = timestep_embedding(t, cfg["block_out_channels"][0])
    return linear(P, "time_embedding.linear_2",
                  F.silu(linear(P, "time_embedding.linear_1", temb, q)), q)


def _down_block(P, cfg, i, h, temb, skips, q, downsample):
    """Down block ``i``: its resnets (and attentions), each output kept in
    ``skips``; then, where ``downsample``, the stride-2 conv, kept too."""
    groups, eps, hd = cfg["norm_num_groups"], cfg["norm_eps"], cfg["attention_head_dim"]
    pre = f"down_blocks.{i}"
    for j in range(cfg["layers_per_block"]):
        h = resnet(P, f"{pre}.resnets.{j}", h, temb, q, groups, eps)
        if cfg["down_block_types"][i] == "AttnDownBlock2D":
            h = attention(P, f"{pre}.attentions.{j}", h, q, hd, groups, eps)
        skips.append(h)
    if downsample:
        h = conv(P, f"{pre}.downsamplers.0.conv", h, q, stride=2)
        skips.append(h)
    return h


def _up_block(P, cfg, i, h, temb, skips, q):
    """Up block ``i``: its resnets over the concatenated skips (and
    attentions), then, but for the last block, nearest 2x and a conv."""
    groups, eps, hd = cfg["norm_num_groups"], cfg["norm_eps"], cfg["attention_head_dim"]
    pre = f"up_blocks.{i}"
    for j in range(cfg["layers_per_block"] + 1):
        h = resnet(P, f"{pre}.resnets.{j}", torch.cat([h, skips.pop()], dim=1), temb, q,
                   groups, eps)
        if cfg["up_block_types"][i] == "AttnUpBlock2D":
            h = attention(P, f"{pre}.attentions.{j}", h, q, hd, groups, eps)
    if i < len(cfg["block_out_channels"]) - 1:
        h = conv(P, f"{pre}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0), q)
    return h


def _out(P, cfg, h, q):
    h = F.silu(group_norm(P, "conv_norm_out", h, cfg["norm_num_groups"], cfg["norm_eps"]))
    return conv(P, "conv_out", h, q)


def unet(P, cfg, x, t, q=exact, depth=None):
    """The UNet of ``cfg`` (the configuration file's ``unet`` entry):
    ``x`` (B, in, H, W) and timesteps ``t`` (B,) -> (B, out, H, W).
    ``depth``: also return the trunk output at that depth, the input of the
    outermost ``depth`` up blocks (see :func:`unet_shell`)."""
    groups, eps, hd = cfg["norm_num_groups"], cfg["norm_eps"], cfg["attention_head_dim"]
    n = len(cfg["block_out_channels"])
    temb = _embedding(P, cfg, t, q)
    h = conv(P, "conv_in", x, q)
    skips = [h]
    for i in range(n):
        h = _down_block(P, cfg, i, h, temb, skips, q, downsample=i < n - 1)
    h = resnet(P, "mid_block.resnets.0", h, temb, q, groups, eps)
    h = attention(P, "mid_block.attentions.0", h, q, hd, groups, eps)
    h = resnet(P, "mid_block.resnets.1", h, temb, q, groups, eps)
    for i in range(n - (depth or 0)):
        h = _up_block(P, cfg, i, h, temb, skips, q)
    deep = h
    for i in range(n - (depth or 0), n):
        h = _up_block(P, cfg, i, h, temb, skips, q)
    out = _out(P, cfg, h, q)
    return (out, deep) if depth else out


def unet_shell(P, cfg, x, t, deep, depth=1, q=exact):
    """The outer shell of :func:`unet` around a trunk output ``deep`` (the
    feature-reuse forward): conv_in, down blocks [0, depth) for their skips
    (the last of them without its downsampler, whose output feeds only the
    trunk), ``deep`` in place of the trunk, up blocks [n - depth, n) and
    conv_out. With the trunk output of the same (x, t) this is :func:`unet`;
    a cached step passes an earlier step's."""
    n = len(cfg["block_out_channels"])
    temb = _embedding(P, cfg, t, q)
    h = conv(P, "conv_in", x, q)
    skips = [h]
    for i in range(depth):
        h = _down_block(P, cfg, i, h, temb, skips, q, downsample=i < depth - 1)
    h = deep
    for i in range(n - depth, n):
        h = _up_block(P, cfg, i, h, temb, skips, q)
    return _out(P, cfg, h, q)


def vae_decode(P, cfg, z, q=exact):
    """The VAE of ``cfg`` (the configuration file's ``vae`` entry): scaled
    latents ``z`` (B, 4, h, w) -> images in about [-1, 1], (B, 3, 8h, 8w)."""
    groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    per = cfg["layers_per_block"] + 1
    n = len(cfg["block_out_channels"])
    h = conv(P, "post_quant_conv", z / SD_SCALING, q, padding=0)
    h = conv(P, "decoder.conv_in", h, q)
    h = resnet(P, "decoder.mid_block.resnets.0", h, None, q, groups, eps)
    h = attention(P, "decoder.mid_block.attentions.0", h, q, h.shape[1], groups, eps)
    h = resnet(P, "decoder.mid_block.resnets.1", h, None, q, groups, eps)
    for i in range(n):
        pre = f"decoder.up_blocks.{i}"
        for j in range(per):
            h = resnet(P, f"{pre}.resnets.{j}", h, None, q, groups, eps)
        if i < n - 1:
            h = conv(P, f"{pre}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0), q)
    h = F.silu(group_norm(P, "decoder.conv_norm_out", h, groups, eps))
    return conv(P, "decoder.conv_out", h, q)


def fp8(t):
    """The control's precision: each operand rounded to float8 e4m3 under a
    per-tensor scale (its largest magnitude onto e4m3's 448); the gradient
    passes through the rounding unchanged."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    r = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (r - t).detach()


def _conv_spec(spec, name, cin, cout, k):
    spec[name + ".weight"] = (cout, cin, k, k)
    spec[name + ".bias"] = (cout,)


def _vec_spec(spec, name, c):
    spec[name + ".weight"] = (c,)
    spec[name + ".bias"] = (c,)


def _resnet_spec(spec, name, cin, cout, temb):
    _vec_spec(spec, name + ".norm1", cin)
    _conv_spec(spec, name + ".conv1", cin, cout, 3)
    if temb:
        spec[name + ".time_emb_proj.weight"] = (cout, temb)
        spec[name + ".time_emb_proj.bias"] = (cout,)
    _vec_spec(spec, name + ".norm2", cout)
    _conv_spec(spec, name + ".conv2", cout, cout, 3)
    if cin != cout:
        _conv_spec(spec, name + ".conv_shortcut", cin, cout, 1)


def _attention_spec(spec, name, c):
    _vec_spec(spec, name + ".group_norm", c)
    for part in ("to_q", "to_k", "to_v", "to_out.0"):
        spec[f"{name}.{part}.weight"] = (c, c)
        spec[f"{name}.{part}.bias"] = (c,)


def unet_spec(cfg):
    """{name: shape} of every parameter :func:`unet` reads."""
    boc = cfg["block_out_channels"]
    n, per = len(boc), cfg["layers_per_block"]
    temb = 4 * boc[0]
    spec = {}
    _conv_spec(spec, "conv_in", cfg["in_channels"], boc[0], 3)
    spec["time_embedding.linear_1.weight"] = (temb, boc[0])
    spec["time_embedding.linear_1.bias"] = (temb,)
    spec["time_embedding.linear_2.weight"] = (temb, temb)
    spec["time_embedding.linear_2.bias"] = (temb,)
    skips, ch = [boc[0]], boc[0]
    for i, c in enumerate(boc):
        for j in range(per):
            _resnet_spec(spec, f"down_blocks.{i}.resnets.{j}", ch, c, temb)
            if cfg["down_block_types"][i] == "AttnDownBlock2D":
                _attention_spec(spec, f"down_blocks.{i}.attentions.{j}", c)
            ch = c
            skips.append(c)
        if i < n - 1:
            _conv_spec(spec, f"down_blocks.{i}.downsamplers.0.conv", c, c, 3)
            skips.append(c)
    for j in range(2):
        _resnet_spec(spec, f"mid_block.resnets.{j}", ch, ch, temb)
    _attention_spec(spec, "mid_block.attentions.0", ch)
    for i, c in enumerate(reversed(boc)):
        for j in range(per + 1):
            _resnet_spec(spec, f"up_blocks.{i}.resnets.{j}", ch + skips.pop(), c, temb)
            if cfg["up_block_types"][i] == "AttnUpBlock2D":
                _attention_spec(spec, f"up_blocks.{i}.attentions.{j}", c)
            ch = c
        if i < n - 1:
            _conv_spec(spec, f"up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    _vec_spec(spec, "conv_norm_out", boc[0])
    _conv_spec(spec, "conv_out", boc[0], cfg["out_channels"], 3)
    return spec


def vae_decode_spec(cfg):
    """{name: shape} of every parameter :func:`vae_decode` reads."""
    rev = list(reversed(cfg["block_out_channels"]))
    lat = cfg["latent_channels"]
    spec = {}
    _conv_spec(spec, "post_quant_conv", lat, lat, 1)
    _conv_spec(spec, "decoder.conv_in", lat, rev[0], 3)
    for j in range(2):
        _resnet_spec(spec, f"decoder.mid_block.resnets.{j}", rev[0], rev[0], 0)
    _attention_spec(spec, "decoder.mid_block.attentions.0", rev[0])
    ch = rev[0]
    for i, c in enumerate(rev):
        for j in range(cfg["layers_per_block"] + 1):
            _resnet_spec(spec, f"decoder.up_blocks.{i}.resnets.{j}", ch, c, 0)
            ch = c
        if i < len(rev) - 1:
            _conv_spec(spec, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    _vec_spec(spec, "decoder.conv_norm_out", rev[-1])
    _conv_spec(spec, "decoder.conv_out", rev[-1], cfg["out_channels"], 3)
    return spec
