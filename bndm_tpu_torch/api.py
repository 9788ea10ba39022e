"""The reference-shaped convenience API in PyTorch (the reference's
``utils.py``: get_model :7-84, get_scheduler :94-116, get_scheduler_gamma
:120-174, sample_iadb :180-240).

Counterpart of ``bndm_tpu/api.py``: the model factory, both schedules, the
noise engine and the sampler, with explicit parameters instead of a global
``opt``. In PyTorch's idiom the model is an ``nn.Module`` that holds its
weights, so :func:`sample_iadb` takes the module where the JAX API takes
``(model, params)``.
"""

from __future__ import annotations

import torch

from bndm_tpu_torch.cli.common import resolve_device
from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
from bndm_tpu_torch.ops.noise import get_noise, get_noise_v2  # noqa: F401 (re-export)
from bndm_tpu_torch.ops.schedules import alpha_schedule, gamma_schedule
from bndm_tpu_torch.samplers.iadb import sample_iadb as _sample_iadb


def get_model(res=64, inp_channel=3, out_channel=3, activation="silu", dtype="bfloat16",
              device="cuda"):
    """The UNet2D with the reference's per-resolution block layout, an
    ``nn.Module`` on ``device``: CUDA unless the caller asks for another
    (raises when CUDA is missing; ``"meta"`` builds it without memory)."""
    return UNet2D(unet_config_for_res(res, inp_channel, out_channel, act_fn=activation,
                                      dtype=dtype), device=resolve_device(device))


def get_scheduler(x, scheduler, nb_steps=1000, scheduler_param=0.02):
    """The alpha schedule."""
    return alpha_schedule(torch.as_tensor(x), nb_steps, scheduler, scheduler_param)


def get_scheduler_gamma(x, scheduler, scheduler_params, nb_steps=1000):
    """The gamma schedule with an explicit (tau, s, e)."""
    return gamma_schedule(torch.as_tensor(x), nb_steps, scheduler, scheduler_params)


def sample_iadb(model, x0, nb_step, scheduler_params=(1.0, 0.0, 3.0),
                scheduler_alpha="linear", scheduler_gamma="linear", noise_type="gaussian",
                out_channel=3, x_c=None, collect_frames=False, log_freq=None):
    """The reverse IADB/BNDM loop with explicit parameters; ``model`` is the
    module with its weights (``model(x, t)``), where the JAX API takes
    ``(model, params)``. Returns (x, frames | None)."""
    two_head = noise_type in ("gaussianBN", "gaussianRN") and out_channel == 2 * x0.shape[1]
    return _sample_iadb(model, x0, nb_steps=nb_step, scheduler_alpha=scheduler_alpha,
                        scheduler_gamma=scheduler_gamma, gamma_params=scheduler_params,
                        two_head=two_head, x_c=x_c, collect_frames=collect_frames,
                        log_freq=log_freq)
