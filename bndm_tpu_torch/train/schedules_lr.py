"""HF-diffusers learning-rate schedules and the HF pipelines' AdamW.

Counterpart of ``bndm_tpu/train/schedules_lr.py``. The reference uses
``diffusers.optimization.get_scheduler`` with 'cosine' (default) or
'constant' plus linear warmup; HF cosine is lr * 0.5*(1+cos(pi * progress))
after warmup. The schedules are plain functions of the update count,
evaluated in fp32 as the JAX package evaluates them inside its jit.

:class:`HFAdamW` is the optax chain ``clip_by_global_norm(1.0)`` then
``adamw(schedule)``, wrapped in ``optax.MultiSteps`` when
``gradient_accumulation_steps > 1``, in torch: the learning rate is set
explicitly before each update from the count of updates applied so far (the
count optax evaluates the schedule at, before it increments), and under
accumulation the weights move once every k calls, on the running mean of
the k gradients (MultiSteps' Welford mean), the schedule counting updates.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bndm_tpu_torch.train.pixel import clip_by_global_norm_

_F32 = np.float32


def hf_lr_schedule(kind, base_lr, num_warmup_steps, num_training_steps):
    """``fn(step) -> lr`` (a Python float of the fp32 value) for ``kind`` in
    constant, constant_with_warmup, cosine, linear."""
    kind = kind.lower()
    w = _F32(max(1, num_warmup_steps))
    base = _F32(base_lr)

    def warmup_factor(step):
        return min(step / w, _F32(1.0))

    if kind in ("constant", "constant_with_warmup"):
        def fn(step):
            if num_warmup_steps == 0 and kind == "constant":
                return float(base)
            return float(base * warmup_factor(_F32(step)))
    elif kind == "cosine":
        span = _F32(max(1, num_training_steps - num_warmup_steps))

        def fn(step):
            step = _F32(step)
            if step < num_warmup_steps:
                return float(base * warmup_factor(step))
            progress = min(max((step - _F32(num_warmup_steps)) / span, _F32(0.0)), _F32(1.0))
            cos = max(_F32(0.0), _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi) * progress)))
            return float(base * cos)
    elif kind == "linear":
        span = _F32(max(1, num_training_steps - num_warmup_steps))

        def fn(step):
            step = _F32(step)
            if step < num_warmup_steps:
                return float(base * warmup_factor(step))
            return float(base * max(_F32(0.0), (_F32(num_training_steps) - step) / span))
    else:
        raise NotImplementedError(kind)
    return fn


class HFAdamW:
    """AdamW + the LR schedule + the global-norm clip at ``clip``, with
    optional gradient accumulation over ``accum`` calls (see the module
    doc). Call :meth:`step` after ``backward``; it reads the parameters'
    ``.grad`` and returns whether the weights moved."""

    def __init__(self, params, *, lr, betas, eps, weight_decay, schedule, accum=1, clip=1.0):
        self.params = list(params)
        self.schedule = schedule
        self.accum = max(1, accum)
        self.clip = clip
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=betas, eps=eps,
                                     weight_decay=weight_decay)
        self.count = 0  # updates applied: the schedule's step
        self.mini_step = 0  # micro-batches accumulated since the last update
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum > 1 else None

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is not None:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            n = self.mini_step
            with torch.no_grad():
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        for p, g in zip(self.params, grads):
            p.grad = g
        clip_by_global_norm_(grads, self.clip)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return True

    def state_dict(self):
        return {"adamw": self.opt.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd):
        self.opt.load_state_dict(sd["adamw"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self.acc is not None:
            with torch.no_grad():
                for a, v in zip(self.acc, sd["acc"]):
                    a.copy_(v)


def hf_adamw(args, num_training_steps):
    """The reference's AdamW (betas, eps, weight decay from the HF flags),
    its LR schedule and the fixed grad-clip 1.0 the accelerate loops apply,
    as ``make(params) -> HFAdamW``. ``num_training_steps`` is in
    micro-batches, as in the reference; under accumulation the schedule
    runs over ``num_training_steps // accum`` updates."""
    accum = max(1, args.gradient_accumulation_steps)
    sched = hf_lr_schedule(args.lr_scheduler, args.learning_rate, args.lr_warmup_steps,
                           max(1, num_training_steps // accum))
    return functools.partial(HFAdamW, lr=args.learning_rate,
                             betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_epsilon,
                             weight_decay=args.adam_weight_decay, schedule=sched, accum=accum)
