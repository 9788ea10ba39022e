"""Image ops with torch semantics.

``resize_bilinear_align_corners`` is
``torch.nn.functional.interpolate(mode='bilinear', align_corners=True)``,
the op the reference's super-res conditioning uses (down x4, then back up);
the JAX package writes the same corner-aligned sampling out by hand.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear_align_corners(x, out_h, out_w):
    """x: (..., H, W) -> (..., out_h, out_w), corner-aligned bilinear."""
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, x.shape[-2], x.shape[-1])
    out = F.interpolate(x4, size=(out_h, out_w), mode="bilinear", align_corners=True)
    return out.reshape(*lead, out_h, out_w)


def superres_condition(x1, downscale=4):
    """Low-res conditioning image: bilinear down xN then back up, both
    corner-aligned."""
    h, w = x1.shape[-2], x1.shape[-1]
    small = resize_bilinear_align_corners(x1, h // downscale, w // downscale)
    return resize_bilinear_align_corners(small, h, w)
