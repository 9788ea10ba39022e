"""IADB/BNDM reverse sampler as a Python loop over UNet calls.

Counterpart of ``bndm_tpu/samplers/iadb.py::sample_iadb``. Update rule per
step t = T-1 .. 0:
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
    ts = torch.arange(nb_steps - 1, -1, -1, dtype=torch.float32)
    gp = torch.as_tensor(gamma_params, dtype=torch.float32)
    a_s = alpha_schedule(ts + 1.0, nb_steps, scheduler_alpha, alpha_param)
    a_e = alpha_schedule(ts, nb_steps, scheduler_alpha, alpha_param)
    g_s = gamma_schedule(ts + 1.0, nb_steps, scheduler_gamma, gp)
    g_e = gamma_schedule(ts, nb_steps, scheduler_gamma, gp)
    da = (a_s - a_e).tolist()
    dg = (g_s - g_e).tolist()
    a_now = a_s.tolist()

    frames = slots = None
    if collect_frames:
        slots, n_frames = _frame_slots(nb_steps, log_freq)
        frames = torch.zeros((n_frames, 1) + tuple(x0.shape[1:]), dtype=x0.dtype,
                             device=x0.device)

    x = x0
    for i, t in enumerate(range(nb_steps - 1, -1, -1)):
        tt = torch.full((x.shape[0],), a_now[i], dtype=torch.float32, device=x.device)
        inp = x if x_c is None else torch.cat([x, x_c], dim=1)
        d = model(inp, tt)
        # the differences are fp32 values; x is fp32, so the products are too
        x = iadb_step(x, d, da[i], 0.0, dg[i], 0.0, two_head=two_head)
        if frames is not None and slots[t] >= 0:
            frames[slots[t]] = x[0:1].to(frames.dtype)
    return x, frames
