"""Calibrated and carried GroupNorm statistics for the sampling path.

Counterpart of ``bndm_tpu/ops/static_norm.py``. Dynamic GroupNorm reads
its input once to reduce mean/var and again to normalize; the serving tiers
replace the reduction:

  dynamic   -- exact per-sample GroupNorm (the parity path; the UNet's own
               ``GroupNorm`` module serves it)
  calibrate -- exact GroupNorm, recording the batch-mean mean/var of each
               step into the (T, G) tables ``gn_mean``/``gn_var``
  static    -- normalize with the tables' row of the current step, folded
               into one per-channel affine:
               y = x * (scale * rstd[t]) + (bias - mean[t] * rstd[t] * scale)
  record    -- exact GroupNorm, keeping this call's per-sample (B, G)
               ``mu``/``rstd``
  reuse     -- normalize with the per-sample ``mu``/``rstd`` a record
               forward kept (set through ``UNet2D.load_gnstats``)

record/reuse is the GN-stats carry of the cached sampler: the group's full
step records, its shallow steps reuse. The statistics of every mode but
dynamic follow the JAX package's formula, var = E[x^2] - mu^2 in fp32 over
(H, W, the group's channels), so that tables and carried statistics match
the reference's.

Step index: IADB passes alpha = (t+1)/T as the timestep; with the linear
alpha schedule ``round(alpha * T) - 1`` recovers t (:func:`gn_step_index`),
so calibrate/static need the linear schedule.

The tables and the carried statistics are buffers of the module, outside
the state_dict (``UNet2D.quant_state`` / ``load_quant`` and ``gnstats`` /
``load_gnstats`` read and set them), so checkpoints are unchanged.
"""

from __future__ import annotations

import torch
from torch import nn


def gn_step_index(timesteps, gn_steps):
    """The calibrated tables' row for an IADB timestep batch: round(t[0] *
    T) - 1 in fp32 (a 0-d int64 tensor on the timesteps' device)."""
    return torch.round(timesteps.float()[0] * gn_steps).long() - 1


def _box_smooth(a, window):
    """Truncated box filter along axis 0 of a (T, G) table: each row becomes
    the mean of the rows within +-window//2, the window clipped at the
    ends (every output is a mean of real entries)."""
    if window <= 1:
        return a
    t = a.shape[0]
    c = torch.cumsum(torch.cat([a.new_zeros((1,) + tuple(a.shape[1:])), a]), dim=0)
    half = window // 2
    idx = torch.arange(t, device=a.device)
    lo = torch.clamp(idx - half, 0, t)
    hi = torch.clamp(idx + half + 1, 0, t)
    return ((c[hi] - c[lo]).double() / (hi - lo).double()[:, None]).to(a.dtype)


def smooth_gn_tables(quant, window):
    """Smooth every calibrated (T, G) ``gn_mean``/``gn_var`` table of a quant
    dict (``UNet2D.quant_state`` names) along the step axis with a
    truncated box of ``window`` steps. ``window <= 1`` returns the dict
    unchanged; other entries (int8 amax scalars) pass through."""
    if window <= 1:
        return quant
    return {k: _box_smooth(v, window) if k.rsplit(".", 1)[-1] in ("gn_mean", "gn_var")
            and v.dim() == 2 else v for k, v in quant.items()}


def drift_correct_gnstats(gnstats, quant, idx_cur, idx_ref, epsilon=1e-5):
    """Shift the per-sample statistics recorded at a cached group's full
    step (``idx_ref``) to the current shallow step (``idx_cur``) with the
    calibrated batch-mean tables:

        mu'   = mu_rec   + (gn_mean[t] - gn_mean[t_ref])
        rstd' = rstd_rec * sqrt((gn_var[t_ref] + eps) / (gn_var[t] + eps))

    ``gnstats``: ``{"<site>.mu": (B, G), "<site>.rstd": (B, G)}`` as
    ``UNet2D.gnstats`` returns it; ``quant``: the calibrated dict with
    ``"<site>.gn_mean"``/``"<site>.gn_var"``. Sites without tables pass
    through. The indices may be ints or 0-d tensors; they are clipped to
    the tables."""
    out = {}
    for key, val in gnstats.items():
        site, leaf = key.rsplit(".", 1)
        mean_t, var_t = quant.get(f"{site}.gn_mean"), quant.get(f"{site}.gn_var")
        if leaf not in ("mu", "rstd") or mean_t is None or var_t is None:
            out[key] = val
            continue
        last = mean_t.shape[0] - 1
        t = torch.clamp(torch.as_tensor(idx_cur, device=mean_t.device), 0, last)
        r = torch.clamp(torch.as_tensor(idx_ref, device=mean_t.device), 0, last)
        if leaf == "mu":
            out[key] = val + (mean_t[t] - mean_t[r])[None, :]
        else:
            out[key] = val * torch.sqrt((var_t[r] + epsilon) / (var_t[t] + epsilon))[None, :]
    return out


class CalGroupNorm(nn.GroupNorm):
    """GroupNorm with calibrated or carried statistics (see the module doc).
    Parameters as ``nn.GroupNorm`` (``weight``, ``bias``), kept fp32; the
    output is in ``compute_dtype``. ``steps``: the tables' length T
    (calibrate/static)."""

    MODES = ("calibrate", "static", "record", "reuse")

    def __init__(self, num_groups, num_channels, eps, compute_dtype, mode, steps=0):
        if mode not in self.MODES:
            raise ValueError(f"unknown CalGroupNorm mode {mode!r}")
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype
        self.mode = mode
        if mode in ("calibrate", "static"):
            if steps <= 0:
                raise ValueError("CalGroupNorm calibrate/static needs steps > 0")
            self.register_buffer("gn_mean", torch.zeros(steps, num_groups), persistent=False)
            self.register_buffer("gn_var", torch.ones(steps, num_groups), persistent=False)
        else:
            self.register_buffer("mu", None, persistent=False)
            self.register_buffer("rstd", None, persistent=False)

    def _stats(self, x):
        """Per-sample, per-group mean and E[x^2] - mean^2, fp32, (B, G)."""
        xf = x.float().reshape(x.shape[0], self.num_groups, -1)
        mu = torch.mean(xf, dim=2)
        var = torch.mean(torch.square(xf), dim=2) - torch.square(mu)
        return mu, var

    def _per_channel(self, v):
        """(..., G) -> (..., C): each group's value repeated over its channels."""
        return torch.repeat_interleave(v, self.num_channels // self.num_groups, dim=-1)

    def _normalize(self, x, mu, rstd):
        mu_c = self._per_channel(mu)[:, :, None, None]
        rstd_c = self._per_channel(rstd)[:, :, None, None]
        w = self.weight.float()[None, :, None, None]
        b = self.bias.float()[None, :, None, None]
        return ((x.float() - mu_c) * rstd_c * w + b).to(self.compute_dtype)

    def forward(self, x, step_idx=None):
        if self.mode == "reuse":
            if self.mu is None or self.rstd is None:
                raise ValueError("CalGroupNorm(mode='reuse') needs the statistics of a "
                                 "mode='record' forward (UNet2D.load_gnstats)")
            return self._normalize(x, self.mu, self.rstd)
        if self.mode == "static":
            if step_idx is None:
                raise ValueError("static mode needs step_idx")
            idx = torch.clamp(torch.as_tensor(step_idx, device=x.device), 0,
                              self.gn_mean.shape[0] - 1)
            mu_c = self._per_channel(self.gn_mean[idx])
            rstd_c = self._per_channel(torch.rsqrt(self.gn_var[idx] + self.eps))
            scale, bias = self.weight.float(), self.bias.float()
            w = (scale * rstd_c).to(self.compute_dtype)[None, :, None, None]
            b = (bias - mu_c * rstd_c * scale).to(self.compute_dtype)[None, :, None, None]
            return x.to(self.compute_dtype) * w + b
        mu, var = self._stats(x)
        rstd = torch.rsqrt(var + self.eps)
        if self.mode == "record":
            self.mu, self.rstd = mu, rstd
        else:  # calibrate: batch-mean constants for this (site, step)
            if step_idx is None:
                raise ValueError("calibrate mode needs step_idx")
            idx = torch.clamp(torch.as_tensor(step_idx, device=x.device), 0,
                              self.gn_mean.shape[0] - 1)
            with torch.no_grad():
                self.gn_mean[idx] = torch.mean(mu, dim=0)
                self.gn_var[idx] = torch.mean(var, dim=0)
        return self._normalize(x, mu, rstd)
