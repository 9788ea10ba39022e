"""Covariance square-root (L matrix) IO and generation.

The port's own numpy copy of ``bndm_tpu/ops/cov.py`` (the port imports
nothing of the JAX package). The reference ships no generator: its
4096x4096 lower-triangular L matrices (Cholesky factors of a 64x64 Gaussian
blue/red-noise covariance) are artifacts loaded from
``bluenoise/cov_gaussian{BN,RN}_L_res64_d3.npz`` under key ``'x'``. This
module:

  1. loads those artifacts when present (``load_cov_L``), and
  2. *generates* compatible L matrices from a target radial power spectrum
     (``make_cov_L``): a stationary periodic Gaussian field with spectral
     density S has block-circulant covariance C = F^-1 diag(S) F; the
     diagonal is normalized to unit variance and the (lower-triangular)
     Cholesky factor taken, matching the artifact's contract:
     ``noise_bn = L @ white`` applied per channel to flattened (H*W,) pixels.
"""

from __future__ import annotations

import os

import numpy as np


def radial_spectrum_profile(res, kind="blue", power=2.0, floor=1e-3):
    """Target power-spectral density over the (res, res) FFT grid.

    blue: energy rises with radial frequency (high-pass) — low-frequency
          noise is suppressed, which is what makes blue noise perceptually
          "even". red: energy falls with radial frequency (low-pass).
    ``floor`` keeps the spectrum strictly positive so the covariance stays
    positive-definite.
    """
    f = np.fft.fftfreq(res)  # cycles/pixel in [-0.5, 0.5)
    fx, fy = np.meshgrid(f, f, indexing="ij")
    r = np.sqrt(fx * fx + fy * fy)
    r_norm = r / r.max()
    if kind == "blue":
        s = r_norm**power
    elif kind == "red":
        # falls off with frequency; regularize the DC pole
        s = 1.0 / (floor + r_norm) ** power
    elif kind == "white":
        s = np.ones_like(r_norm)
    else:
        raise ValueError(f"unknown spectrum kind: {kind}")
    s = s / s.mean()
    return np.maximum(s, floor)


def make_cov_L(res=64, kind="blue", power=2.0, floor=1e-3, jitter=1e-6, dtype=np.float32):
    """Generate a (res*res, res*res) lower-triangular covariance factor L.

    C = F^-1 diag(S) F for the stationary periodic field (block-circulant,
    built from the inverse FFT of the spectrum = the autocorrelation),
    normalized to unit per-pixel variance, then Cholesky-factored.

    The result plays the same role as the reference's downloaded
    ``cov_gaussianBN_L_res64_d3.npz['x']``: left-multiplying flattened white
    noise yields Gaussian noise with the target (blue/red) spectrum.
    """
    n = res * res
    s = radial_spectrum_profile(res, kind=kind, power=power, floor=floor)
    # autocorrelation = inverse FFT of the PSD (real, even)
    acf = np.fft.ifft2(s).real  # (res, res), acf[0,0] = mean power = variance
    acf = acf / acf[0, 0]  # unit variance

    # block-circulant covariance: C[p, q] = acf[(hp-hq) % res, (wp-wq) % res]
    idx = np.arange(res)
    dh = (idx[:, None] - idx[None, :]) % res  # (res, res)
    # row-major flattening p = h*res + w
    c = acf[dh[:, None, :, None], dh[None, :, None, :]]  # (res, res, res, res) [hp, wp, hq, wq]
    c = c.reshape(n, n)

    # Cholesky with escalating jitter for numerical safety
    eye = np.eye(n)
    jit = jitter
    for _ in range(8):
        try:
            L = np.linalg.cholesky(c + jit * eye)
            break
        except np.linalg.LinAlgError:
            jit *= 10.0
    else:  # pragma: no cover
        raise np.linalg.LinAlgError("covariance not positive definite")
    return L.astype(dtype)


def load_cov_L(path=None, *, res=64, dimension=3, kind="blue", search_dirs=(".", "bluenoise"), generate_if_missing=True, cache_dir=None):
    """Load an L matrix artifact, or generate (and cache) one.

    Looks for the reference artifact naming scheme
    ``cov_gaussian{BN,RN}_L_res{res}_d{dimension}.npz`` (key 'x') in
    ``search_dirs`` — exactly the files the reference downloads
    (iadb_bn.py:83-86) — so users with the published artifacts get
    bit-identical noise. Falls back to ``make_cov_L``.
    """
    if path is not None:
        return np.load(path)["x"].astype(np.float32)

    tag = {"blue": "BN", "red": "RN"}[kind]
    fname = f"cov_gaussian{tag}_L_res{res}_d{dimension}.npz"
    for d in search_dirs:
        cand = os.path.join(d, fname)
        if os.path.exists(cand):
            return np.load(cand)["x"].astype(np.float32)

    if not generate_if_missing:
        raise FileNotFoundError(fname)

    if cache_dir is not None:
        cached = os.path.join(cache_dir, f"generated_{fname}")
        if os.path.exists(cached):
            return np.load(cached)["x"].astype(np.float32)
        L = make_cov_L(res=res, kind=kind)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cached, x=L)
        return L
    return make_cov_L(res=res, kind=kind)
