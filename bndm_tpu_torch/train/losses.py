"""Training objectives and batch tricks of the BNDM pipelines.

Counterpart of ``bndm_tpu/train/losses.py``:

  forward blend   x_alpha = alpha * x0 + (1 - alpha) * x1   (x1 = data, x0 = noise)
  antithetic t    t ~ U{1..T} for ceil(bs/2), then concat(t, T - t + 1)[:bs]
  gaussian/GBN    sum (d - (x1 - x0))^2
  BN/RN, C out    target = x1 - x0 + alpha_{t-1} * (noise_bn - noise_wn)
  BN/RN, 2C out   d1 <- x1 - x0;  d2 <- alpha_{t-1} * (noise_bn - noise_wn),
                  loss = sum|d1-tar1|^2 + sum|d2-tar2|^2 * (dgamma_t/dalpha_t)
  remap           greedy nearest-neighbour reassignment of data to noise
                  within the batch
  DDIM baseline   epsilon MSE, or the SNR-weighted sample loss (means)

The IADB/BNDM losses are sums (not means), matching the reference's
magnitudes. Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def antithetic_timesteps(generator, batch_size, nb_steps, low=1):
    """t ~ U{low..T} for ceil(bs/2), then mirrored: concat(t, T - t + 1)[:bs]
    (int64, on the generator's device)."""
    half = max((batch_size + 1) // 2, 1)
    t = torch.randint(low, nb_steps + 1, (half,), generator=generator,
                      device=generator.device)
    return torch.cat([t, nb_steps - t + 1])[:batch_size]


def antithetic_timesteps_ddim(generator, batch_size, nb_steps):
    """DDIM variant: t ~ U{0..T-1}, mirror T - t - 1."""
    half = max((batch_size + 1) // 2, 1)
    t = torch.randint(0, nb_steps, (half,), generator=generator, device=generator.device)
    return torch.cat([t, nb_steps - t - 1])[:batch_size]


def _bc(v):
    return v.reshape(-1, 1, 1, 1)


def iadb_loss(d, x1, x0):
    """Plain IADB objective for gaussian/GBN."""
    return torch.sum((d - (x1 - x0)) ** 2)


def bndm_loss(d, x1, x0, noise_bn, noise_wn, alpha, alpha_prev, gamma, gamma_prev, two_head):
    """BNDM objective for gaussianBN/RN. ``two_head``: the model predicts 2*C
    channels (the paper's setting); the channels split at the midpoint."""
    if not two_head:
        tar = x1 - x0 + _bc(alpha_prev) * (noise_bn - noise_wn)
        return torch.sum((d - tar) ** 2)
    c = d.shape[1] // 2
    d1, d2 = d[:, :c], d[:, c:]
    tar1 = x1 - x0
    tar2 = _bc(alpha_prev) * (noise_bn - noise_wn)
    delta_gamma = gamma - gamma_prev
    delta_alpha = alpha - alpha_prev
    loss1 = torch.sum((d1 - tar1) ** 2, dim=(1, 2, 3))
    loss2 = torch.sum((d2 - tar2) ** 2, dim=(1, 2, 3))
    # the reference multiplies loss1 by dalpha/dalpha ("weight is simply 1")
    # and loss2 by dgamma/dalpha
    return torch.sum(loss1) + torch.sum(loss2 * delta_gamma / delta_alpha)


def ddim_loss(model_output, noise, clean, timesteps, alphas_cumprod, prediction_type="epsilon"):
    """The DDIM baseline's losses: epsilon MSE or the SNR-weighted sample
    loss (``alphas_cumprod`` on the timesteps' device)."""
    if prediction_type == "epsilon":
        return torch.mean((model_output - noise) ** 2)
    if prediction_type == "sample":
        acp = _bc(alphas_cumprod[timesteps])
        snr = acp / (1.0 - acp)
        return torch.mean(snr * (model_output - clean) ** 2)
    raise NotImplementedError(prediction_type)


@torch.no_grad()
def remap_batch(x0, x1, masked_value=10000.0):
    """Greedy nearest-neighbour batch-OT: the permutation ``mapping`` (int64)
    such that x1[mapping] pairs each noise x0[i] with its (greedy) closest
    remaining data sample. Sequential by construction; the argmin stays on
    the device, so the loop reads nothing back to the host."""
    b = x0.shape[0]
    diff = x0.reshape(b, -1)[:, None, :] - x1.reshape(b, -1)[None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff ** 2, dim=-1), min=0.0))
    mapping = torch.zeros(b, dtype=torch.int64, device=x0.device)
    for i in range(b):
        j = torch.argmin(dist[i]).reshape(1)
        mapping[i:i + 1] = j
        dist.index_fill_(1, j, masked_value)
    return mapping
