"""Plain float32 forward pass of DiT (Peebles & Xie, *Scalable Diffusion
Models with Transformers*, ICCV 2023; ``facebookresearch/DiT`` ``models.py``,
``DiT_XL_2``), written as a function over a dict of parameters named as
``models.py``'s state dict names them.

``x_embedder.proj``: a p x p conv of stride p, flattened row-major into N
tokens, plus the fixed 2-D sin-cos position table (per token, the first
half from its column and the second from its row, each [sin | cos] of the
position times 1 / 10000^(i / (D / 4))). ``t_embedder``: [cos | sin] of
t exp(-ln(10^4) i / (F / 2)) over F = ``frequency_embedding_size``, then
linear, SiLU, linear: the conditioning vector c. Each of ``depth`` blocks:
shift1, scale1, gate1, shift2, scale2, gate2 = linear(SiLU(c)) in six;
x += gate1 attn(LN(x) (1 + scale1) + shift1); x += gate2 mlp(LN(x) (1 +
scale2) + shift2), LayerNorm without an affine at ``norm_eps``; attn: qkv
split into ``num_heads`` heads, softmax(q k^T / sqrt(d)) v written out (two
products, the softmax in float32), proj; mlp: fc1, tanh GELU, fc2. The
final layer: shift, scale = linear(SiLU(c)) in two, linear(LN(x) (1 +
scale) + shift), then unpatchify (tokens (h, w, p, q, C) to (C, h p, w q)).

Departures from ``models.py``, as the configuration file's ``changed``
states them: no label table (``y_embedder``): the model is unconditional and
c is the time embedding alone; the position table is fixed and not counted
among the parameters (``models.py`` keeps it as a frozen parameter); t is
the IADB blend factor alpha in [0, 1] (DiT's recipe feeds integer steps in
[0, 999]).

``q`` is applied to every operand of every product (the patch conv, each
linear, both attention products): the identity for the reference, a lower
precision for the control. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _outs(s):
    return 2 * s["in_channels"] if s["learn_sigma"] else s["in_channels"]


def dit_spec(s):
    """{name: shape} of the parameters of the DiT with settings ``s``."""
    d, p, c = s["hidden_size"], s["patch_size"], s["in_channels"]
    hidden = int(d * s["mlp_ratio"])
    f = s["frequency_embedding_size"]
    spec = {"x_embedder.proj.weight": (d, c, p, p), "x_embedder.proj.bias": (d,),
            "t_embedder.mlp.0.weight": (d, f), "t_embedder.mlp.0.bias": (d,),
            "t_embedder.mlp.2.weight": (d, d), "t_embedder.mlp.2.bias": (d,),
            "final_layer.linear.weight": (p * p * _outs(s), d),
            "final_layer.linear.bias": (p * p * _outs(s),),
            "final_layer.adaLN_modulation.1.weight": (2 * d, d),
            "final_layer.adaLN_modulation.1.bias": (2 * d,)}
    for i in range(s["depth"]):
        b = f"blocks.{i}."
        for name, (o, n) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                             "mlp.fc1": (hidden, d), "mlp.fc2": (d, hidden),
                             "adaLN_modulation.1": (6 * d, d)}.items():
            spec[b + name + ".weight"] = (o, n)
            spec[b + name + ".bias"] = (o,)
    return spec


def pos_table(d, grid):
    """The fixed 2-D sin-cos position table, (grid^2, d), float32."""
    omega = 1.0 / 10000.0 ** (np.arange(d // 4, dtype=np.float64) / (d / 4.0))
    rows, cols = np.meshgrid(np.arange(grid, dtype=np.float64),
                             np.arange(grid, dtype=np.float64), indexing="ij")

    def half(pos):
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return torch.from_numpy(np.concatenate([half(cols), half(rows)], axis=1).astype(np.float32))


def linear(P, name, x, q):
    return F.linear(q(x), q(P[name + ".weight"]), q(P[name + ".bias"]))


def layer_norm(x, eps):
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def attention(P, name, x, heads, q):
    b, n, d = x.shape
    dh = d // heads
    qkv = linear(P, name + ".qkv", x, q).reshape(b, n, 3, heads, dh)
    qq, kk, vv = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q(qq), q(kk)) / math.sqrt(dh)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", q(attn), q(vv)).reshape(b, n, d)
    return linear(P, name + ".proj", out, q)


def block(P, name, x, c, s, q):
    mod = linear(P, name + ".adaLN_modulation.1", F.silu(c), q)[:, None]
    shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=2)
    eps = s["norm_eps"]
    h = layer_norm(x, eps) * (1 + scale1) + shift1
    x = x + gate1 * attention(P, name + ".attn", h, s["num_heads"], q)
    h = layer_norm(x, eps) * (1 + scale2) + shift2
    h = F.gelu(linear(P, name + ".mlp.fc1", h, q), approximate="tanh")
    return x + gate2 * linear(P, name + ".mlp.fc2", h, q)


def dit(P, s, x, t, q):
    """The float32 DiT of settings ``s`` over ``x`` (B, C, H, W) at ``t``
    (B,): (B, out channels, H, W)."""
    b, _, hh, ww = x.shape
    p, d = s["patch_size"], s["hidden_size"]
    w = P["x_embedder.proj.weight"]
    h = F.conv2d(q(x), q(w), q(P["x_embedder.proj.bias"]), stride=p)
    h = h.flatten(2).transpose(1, 2) + pos_table(d, hh // p).to(x.device)
    half = s["frequency_embedding_size"] // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=x.device) / half)
    args = t.float()[:, None] * freqs[None]
    c = linear(P, "t_embedder.mlp.0", torch.cat([torch.cos(args), torch.sin(args)], dim=-1), q)
    c = linear(P, "t_embedder.mlp.2", F.silu(c), q)
    for i in range(s["depth"]):
        h = block(P, f"blocks.{i}", h, c, s, q)
    shift, scale = linear(P, "final_layer.adaLN_modulation.1", F.silu(c), q)[:, None].chunk(
        2, dim=2)
    h = linear(P, "final_layer.linear", layer_norm(h, s["norm_eps"]) * (1 + scale) + shift, q)
    co = _outs(s)
    h = h.reshape(b, hh // p, ww // p, p, p, co)
    return torch.einsum("nhwpqc->nchpwq", h).reshape(b, co, hh, ww)
