"""Image quality metrics in PyTorch.

Counterpart of ``bndm_tpu/utils/metrics.py`` and of the reference's ``piq``
calls in the super-res eval: gaussian-windowed SSIM (kernel 11, sigma 1.5,
k1=0.01, k2=0.03, 'valid' depthwise filtering) and PSNR over the full image,
both with an explicit ``data_range`` and per-sample reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel(size=11, sigma=1.5, device=None):
    r = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d(x, kernel):
    """Depthwise 'valid' 2D correlation. x: (B, C, H, W), kernel: (k, k)."""
    c = x.shape[1]
    k = kernel.shape[0]
    kern = kernel.to(x.dtype).expand(c, 1, k, k)
    return F.conv2d(x, kern, groups=c)


def ssim(x, y, data_range=1.0, kernel_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """Per-sample SSIM, shape (B,). x, y: (B, C, H, W) in [0, data_range]."""
    x = x.float() / data_range
    y = y.float() / data_range
    kern = _gaussian_kernel(kernel_size, sigma, device=x.device)
    c1 = k1**2
    c2 = k2**2
    mu_x = _filter2d(x, kern)
    mu_y = _filter2d(y, kern)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d(x * x, kern) - mu_xx
    sigma_yy = _filter2d(y * y, kern) - mu_yy
    sigma_xy = _filter2d(x * y, kern) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ss = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1) * cs
    return torch.mean(ss, dim=(1, 2, 3))


def psnr(x, y, data_range=1.0):
    """Per-sample PSNR in dB, shape (B,)."""
    x = x.float()
    y = y.float()
    mse = torch.mean((x - y) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
