"""The noise a BNDM train step draws, worked out again from the step's key.

* The key of step ``k`` of a run is ``(seed, k)``. A generator of a path of
  integers is seeded with ``numpy.random.SeedSequence(path)``'s first 64-bit
  word; t comes from a CPU generator of ``key``, the white noise from one of
  ``(*key, 2)`` on the data's device (``torch.randn``), except for a fresh
  64x64 draw on CUDA, whose white noise is the fused kernel's generator:
  Philox4x32-10 (Salmon et al., SC'11) at counter (row, column, 0, 0) with
  the two seeds that ``torch.randint(0, 2**31 - 1, (2,))`` draws from a CPU
  generator of ``(*key, 1)``; words 0 and 1 become u1, u2 by
  ``(bits >> 8) * 2**-24 + 2**-25``, and ``wn = sqrt(-2 ln u1) cos(2 pi u2)``,
  one row a pixel and one column a (sample, channel).
* t: antithetic, ``t ~ U{1..T}`` for half the batch, then ``T - t + 1``.
* Blue noise is ``L @ white`` per (sample, channel) over the 4096 pixels of
  a 64x64 tile; a 32x32 input draws a 64x64 tile and keeps its top-left
  quarter. The mix is ``bn * (1 - gamma) + wn * gamma``.
* ``L`` is the lower Cholesky factor of the block-circulant covariance of a
  stationary field with the radial power spectrum ``r**2`` (floored at 1e-3,
  mean 1), normalised to unit variance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def generator(device, *path):
    s = int(np.random.SeedSequence([int(v) for v in path]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def antithetic_t(key, batch, nb_steps):
    half = max((batch + 1) // 2, 1)
    t = torch.randint(1, nb_steps + 1, (half,), generator=generator("cpu", *key))
    return torch.cat([t, nb_steps - t + 1])[:batch]


def _mulhilo(a, b):
    lo16, hi16 = a * (b & 0xFFFF), a * (b >> 16)
    return (hi16 + (lo16 >> 16)) >> 16, (((hi16 & 0xFFFF) << 16) + lo16) & _MASK32


def philox_white(n, m, seeds, device):
    """(n, m) float32 white noise of the fused generator."""
    c0 = torch.arange(n, dtype=torch.int64, device=device)[:, None].expand(n, m)
    c1 = torch.arange(m, dtype=torch.int64, device=device)[None, :].expand(n, m)
    c2 = torch.zeros((n, m), dtype=torch.int64, device=device)
    c3 = c2
    k0, k1 = seeds[0] & _MASK32, seeds[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32

    def unit(bits):
        return (bits >> 8).to(torch.float64) * 2.0**-24 + 2.0**-25

    return (torch.sqrt(-2.0 * torch.log(unit(c0))) * torch.cos(2.0 * math.pi * unit(c1))).float()


def make_L(res=64, power=2.0, floor=1e-3, jitter=1e-6, device="cpu"):
    """The (res*res, res*res) blue-noise factor, float32, computed in
    float64 on ``device``."""
    f = torch.fft.fftfreq(res, dtype=torch.float64, device=device)
    r = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    s = (r / r.max()) ** power
    s = torch.clamp(s / s.mean(), min=floor)
    acf = torch.fft.ifft2(s).real
    acf = acf / acf[0, 0]
    idx = torch.arange(res, device=device)
    dh = (idx[:, None] - idx[None, :]) % res
    c = acf[dh[:, None, :, None], dh[None, :, None, :]].reshape(res * res, res * res)
    eye = torch.eye(res * res, dtype=torch.float64, device=device)
    for _ in range(8):
        L, info = torch.linalg.cholesky_ex(c + jitter * eye)
        if int(info) == 0:
            return L.float()
        jitter *= 10.0
    raise ValueError("the blue-noise covariance is not positive definite")


def _tile_noise(white, L):
    """(B, C, 64, 64) white -> blue, ``L`` per (sample, channel), float64."""
    b, c = white.shape[:2]
    w = white.reshape(b * c, 4096).T.double()
    return (L.double() @ w).T.reshape(b, c, 64, 64).float()


def train_noise(key, shape, gamma, L, device):
    """(noise, bn, wn) of a train step's fresh draw for data of ``shape``
    (B, C, H, W), H = W in {32, 64}, with the mix ``gamma`` (B,)."""
    b, c, h, w = shape
    if h == 64 and torch.device(device).type == "cuda":
        gen = generator("cpu", *key, 1)
        seeds = tuple(torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist())
        wn = philox_white(4096, b * c, seeds, device).reshape(64, 64, b, c).permute(2, 3, 0, 1)
    else:
        wn = torch.randn((b, c, 64, 64), generator=generator(device, *key, 2), device=device)
    bn = _tile_noise(wn, L)
    g = gamma.reshape(-1, 1, 1, 1)
    noise = bn * (1.0 - g) + wn * g
    return tuple(v[:, :, :h, :w] for v in (noise, bn, wn))
