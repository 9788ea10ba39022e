"""DDPM/DDIM baseline training (the reference's comparison pipeline).

Counterpart of ``bndm_tpu/train/ddim.py``: antithetic t in [0, T-1], DDPM
forward noising through the beta schedule, the epsilon-MSE (or SNR-weighted
sample) loss, AdamW + HF LR schedule + grad-clip 1.0 (``HFAdamW``), and the
EMA, which steps on every call, as in the JAX step. Randomness comes from a
key, a tuple of ints such as (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bndm_tpu_torch.cli.common import make_generator
from bndm_tpu_torch.samplers.ddim import DDIMScheduler
from bndm_tpu_torch.train.ema import EmaState, ema_init, ema_update
from bndm_tpu_torch.train.losses import antithetic_timesteps_ddim, ddim_loss
from bndm_tpu_torch.train.schedules_lr import HFAdamW


@dataclasses.dataclass(frozen=True)
class DDIMTrainConfig:
    ddpm_num_steps: int = 1000
    ddpm_beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
    use_ema: bool = False
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    ema_max_decay: float = 0.9999


@dataclasses.dataclass
class HFTrainState:
    """The train state of the HF-style pipelines (DDIM and latent); the step
    updates it in place. ``state_dict``/``load_state_dict`` hold all of it
    (the optimizer's accumulation buffers and schedule count included) for
    the checkpoint manager."""

    model: torch.nn.Module
    opt: HFAdamW
    ema: Optional[EmaState]
    step: int = 0

    def state_dict(self):
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict(),
                "ema": None if self.ema is None else self.ema.state_dict(), "step": self.step}

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"])
        self.step = int(sd["step"])

    def eval_state_dict(self):
        """The weights the pipelines save and sample with: the EMA's under
        --use_ema (the reference copies them into the saved unet/), else the
        live ones."""
        if self.ema is None:
            return self.model.state_dict()
        return {k: self.ema.params.get(k, v) for k, v in self.model.state_dict().items()}


def apply_update(state: HFTrainState, cfg):
    """The optimizer on the gradients in ``.grad``, then the EMA, then the
    step count (shared by the DDIM and latent steps)."""
    state.opt.step()
    if state.ema is not None:
        ema_update(state.ema, state.model, cfg.ema_max_decay, cfg.ema_inv_gamma, cfg.ema_power)
    state.step += 1


def make_ddim_train_step(cfg: DDIMTrainConfig, make_optimizer):
    """``train_step(state, batch01, key) -> {"loss"}`` and
    ``init_state(model)``; ``make_optimizer(params) -> HFAdamW``
    (``train/schedules_lr.py::hf_adamw``). ``batch01``: images in [0, 1]
    on the model's device. t comes from a CPU generator of ``key``, the
    noise from a generator of ``(*key, 2)`` on the device."""
    scheduler = DDIMScheduler(num_train_timesteps=cfg.ddpm_num_steps,
                              beta_schedule=cfg.ddpm_beta_schedule,
                              prediction_type=cfg.prediction_type)

    def loss_fn(model, clean, t, noise):
        scheduler.to(clean.device)
        noisy = scheduler.add_noise(clean, noise, t)
        d = model(noisy, t.to(torch.float32))
        return ddim_loss(d, noise, clean, t, scheduler.alphas_cumprod, cfg.prediction_type)

    def train_step(state: HFTrainState, batch01, key):
        clean = batch01.to(torch.float32) * 2.0 - 1.0
        t = antithetic_timesteps_ddim(make_generator("cpu", *key), clean.shape[0],
                                      cfg.ddpm_num_steps).to(clean.device)
        noise = torch.randn(clean.shape, generator=make_generator(clean.device, *key, 2),
                            device=clean.device)
        state.opt.zero_grad()
        loss = loss_fn(state.model, clean, t, noise)
        loss.backward()
        apply_update(state, cfg)
        return {"loss": loss.detach()}

    def init_state(model):
        return HFTrainState(model=model, opt=make_optimizer(model.parameters()),
                            ema=ema_init(model) if cfg.use_ema else None)

    train_step.loss_fn = loss_fn
    train_step.scheduler = scheduler
    return train_step, init_state
