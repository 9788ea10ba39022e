"""Seeded random weights, made on the device in one draw.

The leaves are taken in the order of their sorted names. Every leaf gets
standard normal values from one ``torch.randn`` on a generator of the
device, then: a weight of two or more dimensions is scaled to a standard
deviation of ``1 / sqrt(3 fan_in)`` (PyTorch's default initialisation has
that spread); a norm's scale is ``1 + 0.05 z``; every other vector (a bias,
a norm's shift) is ``0.05 z``. The same (seed, names, shapes) give the same
values on the same device, to the program and to the reference alike.
"""

from __future__ import annotations

import math

import torch


def _scale_and_shift(name, shape):
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return 1.0 / math.sqrt(3.0 * fan_in), 0.0
    if "norm" in name and name.endswith(".weight"):
        return 0.05, 1.0
    return 0.05, 0.0


def make(spec, seed, device, dtype=torch.float32):
    """``spec``: {name: shape}. Returns {name: tensor of ``dtype``} on
    ``device``, rounded to ``dtype`` from float32 values."""
    names = sorted(spec)
    if not names:
        return {}
    shapes = [tuple(spec[n]) for n in names]
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.tensor([_scale_and_shift(n, s)[0] for n, s in zip(names, shapes)],
                         device=device)
    shift = torch.tensor([_scale_and_shift(n, s)[1] for n, s in zip(names, shapes)],
                         device=device)
    counts = torch.tensor(sizes, device=device)
    flat = flat * scale.repeat_interleave(counts) + shift.repeat_interleave(counts)
    flat = flat.to(dtype)
    return {n: v.view(s) for n, v, s in zip(names, flat.split(sizes), shapes)}


def spec_of(module):
    """{name: shape} of a module's parameters."""
    return {n: tuple(p.shape) for n, p in module.named_parameters()}
