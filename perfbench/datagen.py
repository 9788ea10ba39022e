"""The general traffic generator: every input a cell feeds the program,
made from the run's seed by the parameters of the cell's traffic file.

* ``procedural_images``: smooth random colour fields (2-4 sinusoid colour
  gradients and 1-3 soft Gaussian blobs, stretched to 0..255), uint8
  (n, res, res, 3), drawn on the device in a few tensor operations.
* ``write_pngs``: one PNG a image in ``<root>/class0/img_<i>.png``.
* ``normal``: standard normal tensors of a shape, drawn on the device from
  a generator of (seed, stream).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch


def procedural_images(seed, n, res, device="cpu"):
    """uint8 (n, res, res, 3) on the host, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + 101) % 2**63)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    grid = torch.arange(res, device=device, dtype=torch.float32) / res
    yy, xx = grid[:, None], grid[None, :]
    img = torch.zeros((n, res, res, 3), device=device)
    waves = torch.randint(2, 5, (n,), generator=gen, device=device)
    for k in range(4):
        on = (k < waves).float()[:, None, None, None]
        fx, fy = u(-3, 3, 2, n, 1, 1)
        wave = torch.sin(2 * math.pi * (fx * xx + fy * yy) + u(0, 2 * math.pi, n, 1, 1))
        img += on * wave[..., None] * u(0.1, 0.5, n, 1, 1, 3)
    blobs = torch.randint(1, 4, (n,), generator=gen, device=device)
    for k in range(3):
        on = (k < blobs).float()[:, None, None, None]
        cx, cy = u(0.1, 0.9, 2, n, 1, 1)
        s = u(0.05, 0.25, n, 1, 1)
        blob = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
        img += on * blob[..., None] * u(-0.8, 0.8, n, 1, 1, 3)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    span = img.amax(dim=(1, 2, 3), keepdim=True) - lo
    return ((img - lo) / (span + 1e-8) * 255).to(torch.uint8).cpu().numpy()


def write_pngs(images, root, threads=8):
    from PIL import Image

    cls = os.path.join(root, "class0")
    os.makedirs(cls, exist_ok=True)

    def save(i):
        Image.fromarray(images[i]).save(os.path.join(cls, f"img_{i:05d}.png"), compress_level=1)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(save, range(len(images))))
    return root


def normal(seed, stream, shape, device, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)
    return torch.randn(shape, generator=gen, device=device).to(dtype)
