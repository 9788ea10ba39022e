"""Latent-space IADB/BNDM training (512^2 / 256^2 pixels as 64^2 / 32^2
latents).

Counterpart of ``bndm_tpu/train/latent.py``: latents come from the latent
cache (the VAE runs once, offline); the step draws antithetic t, sets the
linear alpha = gamma = t/T, draws the noise through the noise engine on the
(B, 4, 32|64, 32|64) latents (on CUDA K1 at res 32, K2 at res 64), blends
as the IADB scheduler's ``add_noise``, takes the midpoint-split two-head
BNDM loss (or the IADB loss), then AdamW + HF LR schedule + grad-clip 1.0
and the EMA. Data parallel (a ``mesh``) as the pixel step: t and the noise
drawn for the global batch (K2 at the global M), each rank's rows' share of
the summed loss, the gradient summed over the ranks.
"""

from __future__ import annotations

import dataclasses

import torch

from bndm_tpu_torch.cli.common import make_generator
from bndm_tpu_torch.ops.noise import get_noise
from bndm_tpu_torch.parallel.mesh import data_shard, local_rows, wrap_ddp
from bndm_tpu_torch.train.ddim import HFTrainState, apply_update, backward_global
from bndm_tpu_torch.train.ema import ema_init
from bndm_tpu_torch.train.losses import antithetic_timesteps, bndm_loss, iadb_loss
from bndm_tpu_torch.train.pixel import draw_noise, global_like
from bndm_tpu_torch.utils.timing import span

# the noise engine: K2 for a fresh 64^2 draw on CUDA (ops/noise.py::takes_fused),
# the unfused path (K1 on CUDA) elsewhere; the JAX package's latent step keeps
# its "xla" default, which on a TPU would not take its fused kernel
ENGINE = "auto"


@dataclasses.dataclass(frozen=True)
class LatentTrainConfig:
    ddpm_num_steps: int = 1000
    noise_type: str = "gaussianBN"
    out_channels: int = 8  # already doubled for BN
    latent_channels: int = 4
    use_ema: bool = False
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    ema_max_decay: float = 0.9999

    @property
    def two_head(self):
        return (self.noise_type in ("gaussianBN", "gaussianRN")
                and self.out_channels == 2 * self.latent_channels)


def make_latent_train_step(cfg: LatentTrainConfig, L, make_optimizer, mesh=None):
    """``train_step(state, latents, key) -> {"loss"}`` and
    ``init_state(model)``; ``L`` on the model's device,
    ``make_optimizer(params) -> HFAdamW``. t comes from a CPU generator of
    ``key``, the noise from ``train/pixel.py::draw_noise`` of ``key``, both
    for the global batch (``latents`` are this rank's rows of it)."""
    correlated = cfg.noise_type in ("gaussianBN", "gaussianRN", "GBN")
    T = cfg.ddpm_num_steps
    count = data_shard(mesh)[1]

    def loss_fn(model, clean, t, noise):
        """This rank's share of the summed loss over its rows ``clean``;
        ``t`` and ``noise`` (K2's seeds, a tuple, or the white draw, a
        tensor) are the global batch's."""
        draw = {"seeds": noise} if isinstance(noise, tuple) else {"white": noise}
        with span("train.noise"):
            r = get_noise(global_like(clean, count), L, t / T, noise_type=cfg.noise_type,
                          train=True, inplace=False, engine=ENGINE, **draw)
        r = type(r)(*local_rows(mesh, *r))
        (t,) = local_rows(mesh, t)
        alpha = t / T  # linear, hardcoded in the reference
        gamma = t / T
        a = alpha.reshape(-1, 1, 1, 1)
        noisy = (1.0 - a) * clean + a * r.noise  # IADBScheduler.add_noise
        d = model(noisy, alpha)
        if correlated and cfg.noise_type != "GBN":
            # two heads split at the midpoint; tar1 = clean - noise
            prev = (t - 1.0) / T
            return bndm_loss(d, clean, r.noise, r.noise_bn, r.noise_wn, alpha, prev, gamma,
                             prev, cfg.two_head)
        return iadb_loss(d, clean, r.noise)

    def train_step(state: HFTrainState, latents, key):
        with span("train.step"):
            clean = latents.to(L.device, torch.float32)
            like = global_like(clean, count)
            with span("train.draw"):
                t = antithetic_timesteps(make_generator("cpu", *key), like.shape[0], T)
                t = t.to(L.device, torch.float32)
                noise = draw_noise(like, key, cfg.noise_type, ENGINE)
            loss = backward_global(state, loss_fn, mesh, clean, t, noise)
            apply_update(state, cfg)
        return {"loss": loss}

    def init_state(model):
        return HFTrainState(model=model, opt=make_optimizer(model.parameters()),
                            ema=ema_init(model) if cfg.use_ema else None,
                            forward=wrap_ddp(model, mesh))

    train_step.loss_fn = loss_fn
    return train_step, init_state
