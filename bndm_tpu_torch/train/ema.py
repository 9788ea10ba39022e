"""EMA of model weights, diffusers-EMAModel-compatible decay schedule.

Counterpart of ``bndm_tpu/train/ema.py``. The DDIM and latent pipelines keep
an EMA copy with warmup:
decay(step) = clip(1 - (1 + step/inv_gamma)^(-power), min_decay, max_decay),
evaluated in fp32 at the step count after the increment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    """The EMA weights by parameter name (copies: they never alias the live
    parameters) and the number of updates taken."""

    params: Dict[str, torch.Tensor]
    step: int = 0

    def state_dict(self):
        return {"params": self.params, "step": self.step}

    def load_state_dict(self, sd):
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(sd["params"][k])
        self.step = int(sd["step"])


def ema_init(model):
    return EmaState({n: p.detach().clone() for n, p in model.named_parameters()})


def ema_decay(step, max_decay=0.9999, inv_gamma=1.0, power=0.75, use_warmup=True,
              min_decay=0.0):
    """The decay at ``step`` as a Python float of the fp32 value."""
    f = np.float32
    if not use_warmup:
        return float(f(max_decay))
    value = f(1.0) - (f(1.0) + f(step) / f(inv_gamma)) ** f(-power)
    return float(np.clip(value, f(min_decay), f(max_decay)))


@torch.no_grad()
def ema_update(state: EmaState, model, max_decay=0.9999, inv_gamma=1.0, power=0.75,
               use_warmup=True):
    """One EMA step in place: e = e * d + p * (1 - d), d at step + 1."""
    state.step += 1
    d = ema_decay(state.step, max_decay, inv_gamma, power, use_warmup)
    one_minus = float(np.float32(1.0) - np.float32(d))
    names = [n for n, _ in model.named_parameters()]
    ema = [state.params[n] for n in names]
    live = [p.detach().to(e.dtype) for (_, p), e in zip(model.named_parameters(), ema)]
    # multi-tensor kernels: a few launches for the whole model, not ~3 a tensor
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, live, alpha=one_minus)
    return state
