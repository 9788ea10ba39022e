"""DDPM/DDIM baseline training (the reference's comparison pipeline).

Counterpart of ``bndm_tpu/train/ddim.py``: antithetic t in [0, T-1], DDPM
forward noising through the beta schedule, the epsilon-MSE (or SNR-weighted
sample) loss, AdamW + HF LR schedule + grad-clip 1.0 (``HFAdamW``), and the
EMA, which steps on every call, as in the JAX step. Randomness comes from a
key, a tuple of ints such as (seed, step).

Data parallel (a ``mesh``): each rank draws t and the noise for the global
batch from the key and keeps its rows; its loss is its rows' share of the
global mean, so the gradient ``DistributedDataParallel`` sums over the
ranks is the global batch's (``HFAdamW`` clips it after the sum).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bndm_tpu_torch.cli.common import make_generator
from bndm_tpu_torch.parallel.mesh import all_reduce_sum_, data_shard, local_rows, wrap_ddp
from bndm_tpu_torch.samplers.ddim import DDIMScheduler
from bndm_tpu_torch.train.ema import EmaState, ema_init, ema_update
from bndm_tpu_torch.train.losses import antithetic_timesteps_ddim, ddim_loss
from bndm_tpu_torch.train.schedules_lr import HFAdamW
from bndm_tpu_torch.utils.timing import span


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
    the checkpoint manager. ``forward`` is the module the step calls: the
    model, or its ``DistributedDataParallel`` wrapper (not saved)."""

    model: torch.nn.Module
    opt: HFAdamW
    ema: Optional[EmaState]
    step: int = 0
    forward: Optional[torch.nn.Module] = None

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
    with span("train.optimizer"):
        state.opt.step()
        if state.ema is not None:
            ema_update(state.ema, state.model, cfg.ema_max_decay, cfg.ema_inv_gamma,
                       cfg.ema_power)
    state.step += 1


def backward_global(state: HFTrainState, loss_fn, mesh, *args):
    """Zero the gradients, backpropagate ``loss_fn(forward, *args)`` (this
    rank's share; DDP sums the gradient over the ranks) and return the
    global loss (shared by the DDIM and latent steps)."""
    with span("train.zero_grad"):
        state.opt.zero_grad()
    with span("train.forward"):
        loss = loss_fn(state.forward or state.model, *args)
    with span("train.backward"):
        loss.backward()
    loss = loss.detach()
    all_reduce_sum_(mesh, [loss])
    return loss


def make_ddim_train_step(cfg: DDIMTrainConfig, make_optimizer, mesh=None):
    """``train_step(state, batch01, key) -> {"loss"}`` and
    ``init_state(model)``; ``make_optimizer(params) -> HFAdamW``
    (``train/schedules_lr.py::hf_adamw``). ``batch01``: images in [0, 1]
    on the model's device (with a ``mesh``, this rank's rows of the global
    batch). t comes from a CPU generator of ``key``, the noise from a
    generator of ``(*key, 2)`` on the device, both for the global batch."""
    scheduler = DDIMScheduler(num_train_timesteps=cfg.ddpm_num_steps,
                              beta_schedule=cfg.ddpm_beta_schedule,
                              prediction_type=cfg.prediction_type)
    count = data_shard(mesh)[1]

    def loss_fn(model, clean, t, noise):
        """This rank's share of the global mean loss: ``clean`` holds its
        rows, ``t`` and ``noise`` the global batch's draw."""
        t, noise = local_rows(mesh, t, noise)
        scheduler.to(clean.device)
        noisy = scheduler.add_noise(clean, noise, t)
        d = model(noisy, t.to(torch.float32))
        loss = ddim_loss(d, noise, clean, t, scheduler.alphas_cumprod, cfg.prediction_type)
        return loss / count if count > 1 else loss

    def train_step(state: HFTrainState, batch01, key):
        with span("train.step"):
            clean = batch01.to(torch.float32) * 2.0 - 1.0
            shape = (clean.shape[0] * count,) + tuple(clean.shape[1:])
            with span("train.draw"):
                t = antithetic_timesteps_ddim(make_generator("cpu", *key), shape[0],
                                              cfg.ddpm_num_steps).to(clean.device)
                noise = torch.randn(shape, generator=make_generator(clean.device, *key, 2),
                                    device=clean.device)
            loss = backward_global(state, loss_fn, mesh, clean, t, noise)
            apply_update(state, cfg)
        return {"loss": loss}

    def init_state(model):
        return HFTrainState(model=model, opt=make_optimizer(model.parameters()),
                            ema=ema_init(model) if cfg.use_ema else None,
                            forward=wrap_ddp(model, mesh))

    train_step.loss_fn = loss_fn
    train_step.scheduler = scheduler
    return train_step, init_state
