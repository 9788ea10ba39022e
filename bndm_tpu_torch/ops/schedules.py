"""Alpha (data/noise blend) and gamma (white/blue mix) schedules.

PyTorch counterpart of ``bndm_tpu/ops/schedules.py``: the reference's two
scalar schedules (``get_scheduler`` and ``get_scheduler_gamma``), each mapping
a timestep t in [0, T] to [0, 1]. ``gamma_schedule`` is differentiable with
respect to a ``params`` tensor, so the (tau, s, e) triple can be learned.

Clipping is written as ``minimum(maximum(x, lo), hi)`` rather than
``clamp``: both frameworks then split the gradient evenly where x meets a
bound (at t = 0 the normalized warp is exactly 1), as ``jnp.clip`` does.
"""

from __future__ import annotations

import math

import torch

_CLIP_MIN = 1e-9

ALPHA_KINDS = ("linear", "sigmoid", "cosine")
GAMMA_KINDS = ("linear", "sigmoid", "cosine")


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _sigmoid_warp(t, tau, start, end):
    """Normalized reversed sigmoid, in the tanh form that avoids the fp32
    cancellation of sigmoid(a) - sigmoid(b) at large tau:
    sigmoid(a) - sigmoid(b) == (tanh(a/2) - tanh(b/2)) / 2."""
    u = (t * (end - start) + start) / tau
    us = start / tau
    ue = end / tau
    num = torch.tanh(ue / 2.0) - torch.tanh(u / 2.0)
    den = torch.tanh(ue / 2.0) - torch.tanh(us / 2.0)
    out = _clip(num / den, _CLIP_MIN, 1.0)
    return 1.0 - out


def _cosine_warp(t, tau, start, end):
    """Normalized cosine-power warp."""
    v_start = torch.cos(start * math.pi / 2.0) ** (2.0 * tau)
    v_end = torch.cos(end * math.pi / 2.0) ** (2.0 * tau)
    out = torch.cos((t * (end - start) + start) * math.pi / 2.0) ** (2.0 * tau)
    out = (v_end - out) / (v_end - v_start)
    out = _clip(out, _CLIP_MIN, 1.0)
    return 1.0 - out


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def alpha_schedule(t, nb_steps, kind="linear", param=0.02):
    """alpha(t): blend factor between data and noise.

      - linear:  t / T                        (used by every published config)
      - sigmoid: fixed start=param, end=3, tau=0.9
      - cosine:  fixed start=0.2, end=1, tau=param
    """
    t = torch.as_tensor(t, dtype=torch.float32)
    kind = kind.lower()
    if kind == "linear":
        return t / nb_steps
    if kind == "sigmoid":
        return _sigmoid_warp(t / nb_steps, 0.9, _f32(param, t), _f32(3.0, t))
    if kind == "cosine":
        return _cosine_warp(t / nb_steps, _f32(param, t), _f32(0.2, t), _f32(1.0, t))
    raise NotImplementedError(f"unknown alpha schedule: {kind}")


def gamma_schedule(t, nb_steps, kind="linear", params=(1.0, 0.0, 3.0)):
    """gamma(t): white(1) <-> blue(0) mixing factor.

    ``params`` is the (tau, start, end) triple; pass a tensor that requires
    grad to learn it. ``linear`` ignores params and returns t / T.
    """
    t = torch.as_tensor(t, dtype=torch.float32)
    kind = kind.lower()
    if kind == "linear":
        return t / nb_steps
    params = torch.as_tensor(params, dtype=torch.float32, device=t.device)
    tau, start, end = params[0], params[1], params[2]
    if kind == "sigmoid":
        return _sigmoid_warp(t / nb_steps, tau, start, end)
    if kind == "cosine":
        return _cosine_warp(t / nb_steps, tau, start, end)
    raise NotImplementedError(f"unknown gamma schedule: {kind}")


def gamma_param_ranges(kind, optimize=False, defaults=(0.02, 0.0, 3.0)):
    """(min, max) clamp ranges for the learnable (tau, s, e) params.
    Returns ((tau_min, tau_max), (s_min, s_max), (e_min, e_max))."""
    if not optimize:
        tau, s, e = defaults
        return ((tau, tau), (s, s), (e, e))
    kind = kind.lower()
    if kind == "sigmoid":
        return ((0.01, 10.0), (-3.0, -0.01), (0.01, 3.0))
    if kind == "linear":
        return ((1.0, 1.0), (1.0, 1.0), (1.0, 1.0))
    raise NotImplementedError(f"no learnable ranges for gamma schedule: {kind}")
