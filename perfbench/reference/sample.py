"""The plain IADB sampler step and the images a decode is served as.

With linear alpha = gamma = t / T, step i (t = T - 1 - i) calls the model at
``a = (t + 1) / T`` and updates ``x += da * d[:, :C] + dg * d[:, C:]`` with
``da = dg = (t + 1) / T - t / T`` in float32. Served images are
``uint8(255 * clip((x + 1) / 2, 0, 1))``, truncated.
"""

from __future__ import annotations

import torch


def coefficients(nb_steps):
    """Per step i: the model's timestep and the update's two differences."""
    ts = torch.arange(nb_steps - 1, -1, -1, dtype=torch.float32)
    a_s, a_e = (ts + 1.0) / nb_steps, ts / nb_steps
    return a_s.tolist(), (a_s - a_e).tolist(), (a_s - a_e).tolist()


def update(x, d, da, dg):
    c = x.shape[1]
    return x + da * d[:, :c] + dg * d[:, c:]


def to_uint8(img):
    return (((img + 1.0) / 2.0).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
