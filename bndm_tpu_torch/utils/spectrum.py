"""Fourier spectra for noise analysis (``torch.fft``).

Counterpart of ``bndm_tpu/utils/spectrum.py`` (the reference's cuFFT
``compute_fft``, scripts/fig_main_3_4_inset_10_supp_1_2.py:31-36): the
per-channel centered 2-D FFT, the power spectrum, and the radial power
profile of the paper's spectral analyses. The JAX side runs XLA's FFT, no
Pallas kernel, so the library's FFT is the counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_fft(x):
    """Per-channel centered 2-D FFT: (B, C, H, W) -> complex (B, C, H, W),
    ``fftshift(fft2(channel))``."""
    return torch.fft.fftshift(torch.fft.fft2(x, dim=(-2, -1)), dim=(-2, -1))


def power_spectrum(x):
    """|FFT|^2 averaged over batch and channels: (B, C, H, W) -> (H, W)."""
    return torch.mean(torch.abs(compute_fft(x)) ** 2, dim=(0, 1))


def radial_power_profile(x, nbins=16, exclude_dc=True):
    """Radially binned mean power, as numpy ``(centers, profile)``. A rising
    profile is the signature of blue noise, a falling one of red."""
    p = power_spectrum(x).detach().cpu().numpy().copy()
    h, w = p.shape
    fy = np.fft.fftshift(np.fft.fftfreq(h))
    fx = np.fft.fftshift(np.fft.fftfreq(w))
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    if exclude_dc:
        p[r == 0] = np.nan
    bins = np.linspace(0, r.max() + 1e-9, nbins + 1)
    idx = np.digitize(r.ravel(), bins) - 1
    prof = np.full(nbins, np.nan)
    for i in range(nbins):
        vals = p.ravel()[idx == i]
        vals = vals[~np.isnan(vals)]
        if vals.size:
            prof[i] = vals.mean()
    centers = 0.5 * (bins[:-1] + bins[1:])
    return centers, prof
