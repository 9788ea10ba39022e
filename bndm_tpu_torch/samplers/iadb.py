"""IADB/BNDM reverse samplers as Python loops over UNet calls.

Counterpart of ``bndm_tpu/samplers/iadb.py``: the plain chain
(``sample_iadb``), the feature-reuse chain (``sample_iadb_cached``), the
chain over microbatches (``sample_iadb_microbatched``) and the latent
pipeline's ``IADBScheduler``. Update rule per step t = T-1 .. 0:
    a_s = alpha(t+1), a_e = alpha(t); g_s = gamma(t+1), g_e = gamma(t)
    d   = model(x, a_s)
    two-head BNDM (out = 2*C): x += (a_s - a_e) * d[:, :C] + (g_s - g_e) * d[:, C:]
    single-head / gaussian / GBN: x += (a_s - a_e) * d

Intermediate frames: x[0:1] every ``log_freq`` steps (100 if T == 1000 else
25) plus at t = T-1, written *after* the update.
"""

from __future__ import annotations

from typing import Optional

import torch

from bndm_tpu_torch.ops.schedules import alpha_schedule, gamma_schedule
from bndm_tpu_torch.utils.timing import span


def _frame_slots(nb_steps, log_freq):
    """slot[t] = frame index in t-descending order, or -1."""
    steps = [t for t in reversed(range(nb_steps)) if t % log_freq == 0 or t == nb_steps - 1]
    slots = [-1] * nb_steps
    for i, t in enumerate(steps):
        slots[t] = i
    return slots, len(steps)


def iadb_step(x, d, a_s, a_e, g_s, g_e, *, two_head):
    """One reverse-Euler IADB update."""
    if two_head:
        c = x.shape[1]
        return x + (a_s - a_e) * d[:, :c] + (g_s - g_e) * d[:, c:]
    return x + (a_s - a_e) * d


def _coefficients(nb_steps, scheduler_alpha, alpha_param, scheduler_gamma, gamma_params):
    """Per step i (t = T-1-i): the model's timestep alpha(t+1) and the
    update's fp32 differences alpha(t+1) - alpha(t), gamma(t+1) - gamma(t),
    evaluated on the host as the JAX sampler does inside its scan."""
    ts = torch.arange(nb_steps - 1, -1, -1, dtype=torch.float32)
    gp = torch.as_tensor(gamma_params, dtype=torch.float32)
    a_s = alpha_schedule(ts + 1.0, nb_steps, scheduler_alpha, alpha_param)
    a_e = alpha_schedule(ts, nb_steps, scheduler_alpha, alpha_param)
    g_s = gamma_schedule(ts + 1.0, nb_steps, scheduler_gamma, gp)
    g_e = gamma_schedule(ts, nb_steps, scheduler_gamma, gp)
    return a_s.tolist(), (a_s - a_e).tolist(), (g_s - g_e).tolist()


def _timestep(x, a):
    return torch.full((x.shape[0],), a, dtype=torch.float32, device=x.device)


def _plain_chain(model, x, coefs, *, two_head, x_c=None, frames=None, slots=None):
    a_now, da, dg = coefs
    nb_steps = len(da)
    with span("sample.chain"):
        for i in range(nb_steps):
            with span("sample.step"):
                inp = x if x_c is None else torch.cat([x, x_c], dim=1)
                d = model(inp, _timestep(x, a_now[i]))
                # the differences are fp32 values; x is fp32, so the products are too
                x = iadb_step(x, d, da[i], 0.0, dg[i], 0.0, two_head=two_head)
                t = nb_steps - 1 - i
                if frames is not None and slots[t] >= 0:
                    frames[slots[t]] = x[0:1].to(frames.dtype)
    return x


@torch.no_grad()
def sample_iadb(
    model,
    x0,
    *,
    nb_steps,
    scheduler_alpha="linear",
    alpha_param=0.02,
    scheduler_gamma="linear",
    gamma_params=(1.0, 0.0, 3.0),
    two_head=False,
    x_c: Optional[torch.Tensor] = None,
    collect_frames=False,
    log_freq=None,
):
    """Deterministic reverse sampling. Returns (x, frames | None).

    ``model(x, t)`` is the UNet; with ``x_c`` (super-res conditioning) it
    sees ``cat([x, x_c], 1)``. ``frames`` are the logged intermediates of
    sample 0, shape (n_frames, 1, C, H, W), in t-descending order.

    The schedules are evaluated in fp32 on the host, as the JAX sampler does
    inside its scan; each step's coefficient differences stay fp32 values.
    """
    if log_freq is None:
        log_freq = 100 if nb_steps == 1000 else 25
    coefs = _coefficients(nb_steps, scheduler_alpha, alpha_param, scheduler_gamma,
                          gamma_params)
    frames = slots = None
    if collect_frames:
        slots, n_frames = _frame_slots(nb_steps, log_freq)
        frames = torch.zeros((n_frames, 1) + tuple(x0.shape[1:]), dtype=x0.dtype,
                             device=x0.device)
    x = _plain_chain(model, x0, coefs, two_head=two_head, x_c=x_c, frames=frames,
                     slots=slots)
    return x, frames


def _cached_chain(apply_full, apply_shallow, x, coefs, *, cache_interval, two_head,
                  x_c=None, carry_dtype=None):
    """The feature-reuse chain: groups of ``cache_interval`` steps, each one
    full forward (which also returns the trunk output) and then
    ``cache_interval - 1`` shallow forwards reusing it; the trailing group
    of ``nb_steps % cache_interval`` steps starts with a full forward too.

    ``apply_full(x, t) -> (d, deep)``; ``apply_shallow(x, t, deep) -> d``;
    ``deep`` is opaque here (the GN-stats carry packs its statistics in
    it). ``x_c`` is seen by full and shallow forwards. ``carry_dtype``:
    keep x in this dtype between steps (the step's arithmetic stays fp32,
    only the stored x is rounded); None keeps x0's dtype.
    """
    a_now, da, dg = coefs
    out_dtype = x.dtype
    if carry_dtype is not None:
        x = x.to(carry_dtype)
    deep = None
    with span("sample.chain"):
        for i in range(len(da)):
            with span("sample.step"):
                inp = x if x_c is None else torch.cat([x, x_c], dim=1)
                t = _timestep(x, a_now[i])
                if i % cache_interval == 0:  # a group's first step
                    d, deep = apply_full(inp, t)
                else:
                    d = apply_shallow(inp, t, deep)
                x = iadb_step(x, d, da[i], 0.0, dg[i], 0.0, two_head=two_head)
                if carry_dtype is not None:
                    x = x.to(carry_dtype)
    return x.to(out_dtype) if carry_dtype is not None else x


@torch.no_grad()
def sample_iadb_cached(
    apply_full,
    apply_shallow,
    x0,
    *,
    nb_steps,
    cache_interval,
    scheduler_alpha="linear",
    alpha_param=0.02,
    scheduler_gamma="linear",
    gamma_params=(1.0, 0.0, 3.0),
    two_head=False,
    x_c: Optional[torch.Tensor] = None,
    carry_dtype=None,
):
    """Feature-reuse (block-caching) serving sampler: every
    ``cache_interval``-th step runs the full UNet and keeps its trunk output
    (``apply_full(x, t) -> (d, deep)``, e.g. ``UNet2D(..., return_deep=
    True)``); the steps between recompute only the outer shell around it
    (``apply_shallow(x, t, deep) -> d``, ``UNet2D(..., deep_feature=
    deep)``). ``cache_interval=1`` is the plain sampler. No frames.
    """
    if cache_interval < 1:
        raise ValueError(f"cache_interval {cache_interval} must be >= 1")
    coefs = _coefficients(nb_steps, scheduler_alpha, alpha_param, scheduler_gamma,
                          gamma_params)
    return _cached_chain(apply_full, apply_shallow, x0, coefs, cache_interval=cache_interval,
                         two_head=two_head, x_c=x_c, carry_dtype=carry_dtype)


@torch.no_grad()
def sample_iadb_microbatched(
    model,
    x0,
    *,
    microbatch,
    nb_steps,
    scheduler_alpha="linear",
    alpha_param=0.02,
    scheduler_gamma="linear",
    gamma_params=(1.0, 0.0, 3.0),
    two_head=False,
    apply_shallow=None,
    cache_interval=None,
    carry_dtype=None,
):
    """Gallery-scale serving: an effective batch of ``K * microbatch``
    samples denoised one microbatch at a time, each through the whole
    chain, so that only one microbatch's UNet activations are alive.

    With ``cache_interval`` each microbatch runs the feature-reuse chain
    (then ``model(x, t)`` returns ``(d, deep)`` and ``apply_shallow(x, t,
    deep) -> d``). x0 is (B, C, H, W) with B divisible by ``microbatch``,
    or already (K, mb, C, H, W); the result has the same layout. x0 is left
    as it is: each microbatch's result is written into a copy of it. No
    frames.
    """
    squeeze = x0.dim() == 4
    if squeeze:
        b = x0.shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
        x0 = x0.reshape((b // microbatch, microbatch) + tuple(x0.shape[1:]))
    coefs = _coefficients(nb_steps, scheduler_alpha, alpha_param, scheduler_gamma,
                          gamma_params)
    buf = x0.clone()
    for k in range(buf.shape[0]):
        if cache_interval:
            buf[k] = _cached_chain(model, apply_shallow, buf[k], coefs,
                                   cache_interval=cache_interval, two_head=two_head,
                                   carry_dtype=carry_dtype)
        else:
            buf[k] = _plain_chain(model, buf[k], coefs, two_head=two_head)
    return buf.reshape((-1,) + tuple(buf.shape[2:])) if squeeze else buf


class IADBScheduler:
    """diffusers-style scheduler facade of the latent pipeline: linear
    alpha = gamma = t / num_inference_steps, the two-head step when the
    model predicts 2*C channels, and the forward blend
    ``add_noise = (1 - alpha) * clean + alpha * noise``."""

    def __init__(self, num_train_timesteps: int = 1000):
        self.num_train_timesteps = num_train_timesteps
        self.num_inference_steps = None

    def set_timesteps(self, num_inference_steps: int):
        self.num_inference_steps = num_inference_steps

    @property
    def timesteps(self):
        return list(reversed(range(self.num_inference_steps)))

    def step(self, model_output, timestep, x_alpha, *, two_head=False):
        if self.num_inference_steps is None:
            raise ValueError("call set_timesteps first")
        n = self.num_inference_steps
        a = (timestep + 1) / n
        a_next = timestep / n
        return iadb_step(x_alpha, model_output, a, a_next, a, a_next, two_head=two_head)

    def add_noise(self, original_samples, noise, alpha):
        a = torch.as_tensor(alpha, dtype=torch.float32,
                            device=original_samples.device).reshape(-1, 1, 1, 1)
        return (1.0 - a) * original_samples + a * noise

    def __len__(self):
        return self.num_train_timesteps
