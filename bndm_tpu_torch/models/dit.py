"""DiT, the diffusion transformer (Peebles & Xie, *Scalable Diffusion Models
with Transformers*, ICCV 2023), as the latent pipeline's second backbone.

The equations are those of ``facebookresearch/DiT`` ``models.py`` (``DiT``,
``DiTBlock``, ``FinalLayer``, ``TimestepEmbedder``) with timm's
``PatchEmbed``, ``Attention`` and ``Mlp``:

* ``x_embedder``: a ``patch_size`` x ``patch_size`` conv of stride
  ``patch_size`` to ``hidden_size``, flattened row-major into tokens, plus
  the fixed 2-D sin-cos ``pos_embed``;
* ``t_embedder``: ``[cos, sin]`` of ``t * exp(-ln(1e4) i / 128)``, then
  Linear(256, D), SiLU, Linear(D, D): the conditioning vector ``c``;
* each block: ``shift1, scale1, gate1, shift2, scale2, gate2 =
  Linear(SiLU(c)).chunk(6)``; ``x += gate1 * Attn(LN(x) (1 + scale1) +
  shift1)``; ``x += gate2 * MLP(LN(x) (1 + scale2) + shift2)``; LayerNorm
  without an affine, eps 1e-6; ``qkv`` split into ``num_heads`` heads,
  ``softmax(q k^T / sqrt(d)) v``, ``proj``; the MLP ``fc1``, tanh GELU,
  ``fc2`` at ``mlp_ratio`` times the width;
* the final layer: ``shift, scale = Linear(SiLU(c)).chunk(2)``, then
  ``linear(LN(x) (1 + scale) + shift)`` and ``unpatchify``.

Three departures from ``models.py``: the model is unconditional (no
``y_embedder``: ``c`` is the time embedding alone); ``pos_embed`` is a
non-persistent buffer (``models.py`` keeps it as a frozen parameter); and the
pipelines feed the IADB blend factor alpha in [0, 1] as ``t`` (DiT's recipe
feeds integer steps in [0, 999]). The ``state_dict`` names are
``models.py``'s, so a published state dict loads with ``strict=True`` once
its ``y_embedder.*`` and ``pos_embed`` entries are dropped.

Numerics: products (the patch conv and every linear) run in ``dtype`` over
the parameters as stored (float32 master weights cast at use, or once with
:meth:`DiT.cast_params_`); LayerNorm over the float32 residual stream, the
modulation, the attention and the MLP in ``dtype``; the residual stream and
the output in float32. Attention goes through
``F.scaled_dot_product_attention`` (flash or cuDNN on the card, the math
path on the CPU); ``attention.calls`` counts its calls. The forward opens
the spans ``dit.embed``, ``dit.block`` (one a block) and ``dit.final``.

On the card (the float32 residual stream on CUDA, :func:`fuses_adaln`) the
adaLN sub-layers run as the fused units of ``ops/adaln.py``: each residual
update ``x + gate * branch`` is done in the pass of the LayerNorm and
modulation that follow it, so a block hands its MLP update ``(y, gate)`` on
to the next block's attention LayerNorm, and the last block's to the final
layer's (``DiTBlock.forward_fused``, ``FinalLayer.forward_fused``). The
units hold the modulation and the gate product in float32 and round once;
the CPU runs the plain sequence above.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from bndm_tpu_torch.models.unet2d import Conv2d, Linear, get_timestep_embedding
from bndm_tpu_torch.ops.adaln import adaln
from bndm_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32  # latent side
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    learn_sigma: bool = True  # 2 x in_channels outputs: BNDM's two heads
    frequency_embedding_size: int = 256
    norm_eps: float = 1e-6
    dtype: str = "float32"  # compute dtype of the products

    @property
    def out_channels(self):
        return 2 * self.in_channels if self.learn_sigma else self.in_channels

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)


# the published size, and a tiny one for CPU tests (the same kinds of layer)
PRESETS = {
    "DiT-XL/2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "tiny": dict(depth=2, hidden_size=64, patch_size=2, num_heads=4),
}


def dit_config(preset, **fields):
    """``DiTConfig`` of ``preset`` ("DiT-XL/2" or "tiny") with ``fields``
    (input size, channels, dtypes) set."""
    return DiTConfig(**PRESETS[preset], **fields)


def sincos_pos_embed(dim, grid):
    """``models.py::get_2d_sincos_pos_embed`` of a ``grid`` x ``grid`` patch
    grid, (grid^2, dim) float32 on the CPU: the first half of each row from
    the token's column, the second from its row, each [sin | cos] of the
    position times ``1 / 10000^(i / (dim / 4))``."""
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 4, dtype=torch.float64) / (dim / 4.0))
    pos = torch.arange(grid, dtype=torch.float64)
    col = pos.repeat(grid)  # meshgrid(w, h)[0], flattened row-major
    row = pos.repeat_interleave(grid)

    def one(p):
        out = p[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one(col), one(row)], dim=1).float()


def attention(q, k, v):
    """``softmax(q k^T / sqrt(d)) v`` over (B, heads, N, d) through
    ``F.scaled_dot_product_attention``; ``attention.calls`` counts the
    calls."""
    attention.calls += 1
    return F.scaled_dot_product_attention(q, k, v)


attention.calls = 0


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


class PatchEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        p = cfg.patch_size
        self.proj = Conv2d(cfg.in_channels, cfg.hidden_size, p, cfg.compute_dtype, stride=p,
                           padding=0)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dt, d = cfg.compute_dtype, cfg.hidden_size
        self.freq = cfg.frequency_embedding_size
        self.mlp = nn.Sequential(Linear(self.freq, d, dt), nn.SiLU(), Linear(d, d, dt))

    def forward(self, t):
        # ``TimestepEmbedder.timestep_embedding``: [cos | sin] of t times
        # exp(-ln(1e4) i / (freq / 2)), the UNet's embedding at its defaults
        return self.mlp(get_timestep_embedding(t, self.freq))


class Attention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.compute_dtype
        self.heads = cfg.num_heads
        self.qkv = Linear(d, 3 * d, dt)
        self.proj = Linear(d, d, dt)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.compute_dtype
        hidden = int(d * cfg.mlp_ratio)
        self.fc1 = Linear(d, hidden, dt)
        self.fc2 = Linear(hidden, d, dt)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _norm(x, cfg):
    """LayerNorm without an affine over the float32 residual stream, the
    result in the compute dtype."""
    return F.layer_norm(x, (cfg.hidden_size,), eps=cfg.norm_eps).to(cfg.compute_dtype)


class DiTBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.compute_dtype
        self.cfg = cfg
        self.attn = Attention(cfg)
        self.mlp = Mlp(cfg)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(d, 6 * d, dt))

    def forward(self, x, c):
        shift1, scale1, gate1, shift2, scale2, gate2 = self.adaLN_modulation(c)[:, None].chunk(
            6, dim=2)
        x = x + gate1 * self.attn(_modulate(_norm(x, self.cfg), shift1, scale1))
        return x + gate2 * self.mlp(_modulate(_norm(x, self.cfg), shift2, scale2))

    def forward_fused(self, x, c, pending):
        """The block through fused adaLN units: ``pending`` is the previous
        block's MLP update ``(y, gate)``, or ``()`` before the first block;
        returns the stream before this block's MLP update, and that update."""
        shift1, scale1, gate1, shift2, scale2, gate2 = self.adaLN_modulation(c)[:, None].chunk(
            6, dim=2)
        eps = self.cfg.norm_eps
        x, z = adaln(x, shift1, scale1, eps, *pending)
        x, z = adaln(x, shift2, scale2, eps, self.attn(z), gate1)
        return x, (self.mlp(z), gate2)


class FinalLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.compute_dtype
        self.cfg = cfg
        self.linear = Linear(d, cfg.patch_size ** 2 * cfg.out_channels, dt)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(d, 2 * d, dt))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c)[:, None].chunk(2, dim=2)
        return self.linear(_modulate(_norm(x, self.cfg), shift, scale))

    def forward_fused(self, x, c, pending):
        """The final layer through a fused adaLN unit that first adds the
        last block's MLP update ``pending``."""
        shift, scale = self.adaLN_modulation(c)[:, None].chunk(2, dim=2)
        return self.linear(adaln(x, shift, scale, self.cfg.norm_eps, *pending)[1])


def fuses_adaln(h):
    """Whether the forward of the (float32) residual stream ``h`` takes the
    fused adaLN kernels: on CUDA."""
    return h.is_cuda


class DiT(nn.Module):
    """``forward(x, t) -> out``: ``x`` (B, in_channels, input_size,
    input_size), ``t`` (B,) or a scalar; ``out`` (B, out_channels,
    input_size, input_size), float32, in ``unpatchify``'s order.

    Parameters are created on ``device`` (``"meta"`` allocates nothing) in
    float32 with DiT's ``initialize_weights`` (adaLN-Zero: the modulations
    and the final layer start at zero, so the output does too)."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        with torch.device(device or "cpu"):
            self.x_embedder = PatchEmbed(cfg)
            self.t_embedder = TimestepEmbedder(cfg)
            self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
            self.final_layer = FinalLayer(cfg)
        grid = cfg.input_size // cfg.patch_size
        self.register_buffer("pos_embed", sincos_pos_embed(cfg.hidden_size, grid)[None].to(
            device or "cpu"), persistent=False)
        self.initialize_weights()

    @torch.no_grad()
    def initialize_weights(self):
        """``models.py::DiT.initialize_weights`` without the label table."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        nn.init.normal_(self.t_embedder.mlp[0].weight, std=0.02)
        nn.init.normal_(self.t_embedder.mlp[2].weight, std=0.02)
        for m in [b.adaLN_modulation[-1] for b in self.blocks] + [
                self.final_layer.adaLN_modulation[-1], self.final_layer.linear]:
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def cast_params_(self):
        """Store each product's weight in the dtype it computes in: the same
        rounding as the per-call cast, done once (serving). Returns self."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d)):
                m.to(m.compute_dtype)
        return self

    def unpatchify(self, x):
        """(B, N, p * p * C) tokens to (B, C, H, W) images."""
        c, p = self.cfg.out_channels, self.cfg.patch_size
        h = w = int(round(x.shape[1] ** 0.5))
        x = x.reshape(x.shape[0], h, w, p, p, c)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(x.shape[0], c, h * p, w * p)

    def forward(self, x, t):
        t = torch.as_tensor(t, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        with span("dit.embed"):
            h = self.x_embedder(x).float() + self.pos_embed
            c = self.t_embedder(t)
        if fuses_adaln(h):
            pending = ()
            for block in self.blocks:
                with span("dit.block"):
                    h, pending = block.forward_fused(h, c, pending)
            with span("dit.final"):
                return self.unpatchify(self.final_layer.forward_fused(h, c, pending)).float()
        for block in self.blocks:
            with span("dit.block"):
                h = block(h, c)
        with span("dit.final"):
            return self.unpatchify(self.final_layer(h, c)).float()


def save_tree(dirpath, state_dict, cfg):
    """Write ``state_dict`` as ``dirpath/dit/model.safetensors`` and ``cfg``
    as ``dirpath/dit/config.json``."""
    from bndm_tpu_torch.models.convert import save_safetensors

    sub = os.path.join(dirpath, "dit")
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(dict(dataclasses.asdict(cfg), _class_name="DiT"), f, indent=2, sort_keys=True)
    save_safetensors({k: v.float() for k, v in state_dict.items()},
                     os.path.join(sub, "model.safetensors"))


def load_tree(dirpath):
    """(state_dict, DiTConfig) written by :func:`save_tree`; the state dict
    as float32 tensors on the CPU."""
    from bndm_tpu_torch.models.convert import load_safetensors

    sub = os.path.join(dirpath, "dit")
    with open(os.path.join(sub, "config.json")) as f:
        fields = json.load(f)
    fields.pop("_class_name")
    sd = {k: torch.from_numpy(v) for k, v in
          load_safetensors(os.path.join(sub, "model.safetensors")).items()}
    return sd, DiTConfig(**fields)
