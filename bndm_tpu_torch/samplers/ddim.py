"""DDIM scheduler and samplers in PyTorch (the reference's comparison
baseline).

Counterpart of ``bndm_tpu/samplers/ddim.py``: the subset of diffusers'
``DDIMScheduler`` the reference exercises (num_train_timesteps,
beta_schedule, prediction_type; eta = 0), with diffusers defaults:
beta_start=1e-4, beta_end=0.02, linear / scaled_linear / squaredcos_cap_v2
betas, clip_sample=True, set_alpha_to_one=True, steps_offset=0, "leading"
timestep spacing. Timesteps are int64 tensors on the scheduler's device;
``step`` looks the cumulative alphas up there (a timestep below 0 takes the
final alpha), so no value is read back to the host. The model sees each
timestep as fp32, as the JAX sampler passes it. The samplers are Python
loops over UNet calls.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch


def _make_betas(num_train_timesteps, beta_schedule, beta_start, beta_end):
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return (np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float32) ** 2)
    if beta_schedule == "squaredcos_cap_v2":
        def f(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [min(1 - f((i + 1) / num_train_timesteps) / f(i / num_train_timesteps), 0.999)
                 for i in range(num_train_timesteps)]
        return np.asarray(betas, dtype=np.float32)
    raise NotImplementedError(beta_schedule)


class DDIMScheduler:
    def __init__(
        self,
        num_train_timesteps=1000,
        beta_start=1e-4,
        beta_end=0.02,
        beta_schedule="linear",
        prediction_type="epsilon",
        clip_sample=True,
        clip_sample_range=1.0,
        set_alpha_to_one=True,
        steps_offset=0,
        timestep_spacing="leading",
    ):
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.steps_offset = steps_offset
        self.timestep_spacing = timestep_spacing
        acp = np.cumprod(1.0 - _make_betas(num_train_timesteps, beta_schedule, beta_start,
                                           beta_end))
        self.alphas_cumprod = torch.from_numpy(acp)  # fp32
        self.final_alpha_cumprod = torch.tensor(1.0 if set_alpha_to_one else float(acp[0]),
                                                dtype=torch.float32)
        self.num_inference_steps = None
        self.timesteps = None
        self.timesteps_np = None  # the host copy, for bookkeeping without a device read

    @classmethod
    def from_config(cls, config: dict):
        """Build from a diffusers ``scheduler_config.json`` dict; unknown keys
        are ignored, as diffusers does."""
        keys = set(inspect.signature(cls.__init__).parameters) - {"self"}
        return cls(**{k: v for k, v in config.items() if k in keys})

    def to(self, device):
        """Move the tables (and the timesteps, once set) to ``device``."""
        self.alphas_cumprod = self.alphas_cumprod.to(device)
        self.final_alpha_cumprod = self.final_alpha_cumprod.to(device)
        if self.timesteps is not None:
            self.timesteps = self.timesteps.to(device)
        return self

    @property
    def device(self):
        return self.alphas_cumprod.device

    def set_timesteps(self, num_inference_steps):
        self.num_inference_steps = num_inference_steps
        if self.timestep_spacing == "leading":
            step_ratio = self.num_train_timesteps // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
            ts += self.steps_offset
        elif self.timestep_spacing == "trailing":
            step_ratio = self.num_train_timesteps / num_inference_steps
            ts = np.round(np.arange(self.num_train_timesteps, 0, -step_ratio)).astype(np.int64)
            ts -= 1
        else:
            raise NotImplementedError(self.timestep_spacing)
        self.timesteps_np = ts
        self.timesteps = torch.from_numpy(ts.copy()).to(self.device)
        return self.timesteps

    def _alpha_prod(self, t):
        """alphas_cumprod[t] with the final alpha for t < 0. The lookup is a
        gather over t's elements: indexing with a 0-d tensor would read the
        index back to the host, a sync a step."""
        safe = torch.clamp(t, 0, self.num_train_timesteps - 1)
        acp = self.alphas_cumprod[safe.reshape(-1)].reshape(safe.shape)
        return torch.where(t >= 0, acp, self.final_alpha_cumprod)

    def step(self, model_output, timestep, sample, eta=0.0):
        """Deterministic DDIM step (eta = 0, the reference's usage).
        ``timestep``: an int or an int64 tensor on the scheduler's device."""
        if eta != 0.0:
            raise NotImplementedError("stochastic DDIM is not used by the reference")
        t = torch.as_tensor(timestep, dtype=torch.int64, device=self.device)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        alpha_prod_t = self._alpha_prod(t)
        alpha_prod_prev = self._alpha_prod(prev_t)
        beta_prod_t = 1.0 - alpha_prod_t

        if self.prediction_type == "epsilon":
            pred_x0 = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
            pred_eps = model_output
        elif self.prediction_type == "sample":
            pred_x0 = model_output
            pred_eps = (sample - alpha_prod_t**0.5 * pred_x0) / beta_prod_t**0.5
        elif self.prediction_type == "v_prediction":
            pred_x0 = alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
            pred_eps = alpha_prod_t**0.5 * model_output + beta_prod_t**0.5 * sample
        else:
            raise NotImplementedError(self.prediction_type)

        if self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -self.clip_sample_range, self.clip_sample_range)
            # diffusers recomputes eps from the clipped x0
            pred_eps = (sample - alpha_prod_t**0.5 * pred_x0) / beta_prod_t**0.5

        dir_xt = (1.0 - alpha_prod_prev) ** 0.5 * pred_eps
        return alpha_prod_prev**0.5 * pred_x0 + dir_xt

    def add_noise(self, original_samples, noise, timesteps):
        """Forward process: sqrt(acp)*x0 + sqrt(1-acp)*eps (DDPM training)."""
        acp = self.alphas_cumprod[timesteps].reshape(-1, 1, 1, 1)
        return acp**0.5 * original_samples + (1.0 - acp) ** 0.5 * noise


def _call(fn, x, t, i, pass_step_idx, *extra):
    """``fn(x, t_fp32[, *extra], step_idx=i)``: the timestep broadcast over
    the batch as fp32; the scan position ``i`` (a 0-d device tensor) only
    under ``pass_step_idx``."""
    tt = t.to(torch.float32).expand(x.shape[0])
    if pass_step_idx:
        return fn(x, tt, *extra, step_idx=i)
    return fn(x, tt, *extra)


@torch.no_grad()
def sample_ddim(model, x0, *, scheduler, num_inference_steps, collect_frames=False,
                pass_step_idx=False):
    """The DDIM reverse loop. Returns (x, frames | None).

    Frames follow the reference test loop: the initial noise x0[0:1], then
    x[0:1] after each update whose t % 100 == 0, shape (n_frames, 1, C, H,
    W).

    ``pass_step_idx``: call ``model(x, t, step_idx=i)`` with the scan
    position i (0 = the first, highest-t step): the index the
    static-calibrated GroupNorm tables are keyed on for DDIM, whose integer
    timesteps do not encode their position (calibrate with
    ``ops/int8.py::calibrate_sampling_ddim``).
    """
    scheduler.to(x0.device)
    ts = scheduler.set_timesteps(num_inference_steps)
    ts_host = scheduler.timesteps_np.tolist()
    idx = torch.arange(len(ts_host), device=x0.device)
    frames = None
    if collect_frames:
        slot_of = {t: k + 1 for k, t in enumerate(t for t in ts_host if t % 100 == 0)}
        frames = torch.zeros((1 + len(slot_of), 1) + tuple(x0.shape[1:]), dtype=x0.dtype,
                             device=x0.device)
        frames[0] = x0[0:1]
    x = x0
    for i, t_host in enumerate(ts_host):
        d = _call(model, x, ts[i], idx[i], pass_step_idx)
        x = scheduler.step(d, ts[i], x)
        if frames is not None and t_host in slot_of:
            frames[slot_of[t_host]] = x[0:1].to(frames.dtype)
    return x, frames


@torch.no_grad()
def sample_ddim_cached(apply_full, apply_shallow, x0, *, scheduler, num_inference_steps,
                       cache_interval, pass_step_idx=False):
    """Feature-reuse (block-caching) DDIM sampler, the DDIM counterpart of
    :func:`~bndm_tpu_torch.samplers.iadb.sample_iadb_cached`.

    Every ``cache_interval``-th step runs the full UNet and keeps its trunk
    output (``apply_full(x, t[, step_idx]) -> (d, deep)``); the steps
    between recompute only the outer shell around it (``apply_shallow(x, t,
    deep[, step_idx]) -> d``); the trailing short group starts with a full
    step too. The DDIM update is unchanged, so every prediction type works.
    ``pass_step_idx`` threads the absolute scan position into the model.
    Serving only: no frames.
    """
    if cache_interval < 2:
        raise ValueError(f"cache_interval {cache_interval} must be >= 2")
    scheduler.to(x0.device)
    ts = scheduler.set_timesteps(num_inference_steps)
    idx = torch.arange(len(ts), device=x0.device)
    x, deep = x0, None
    for i in range(len(ts)):
        if i % cache_interval == 0:
            d, deep = _call(apply_full, x, ts[i], idx[i], pass_step_idx)
        else:
            d = _call(apply_shallow, x, ts[i], idx[i], pass_step_idx, deep)
        x = scheduler.step(d, ts[i], x)
    return x
