"""Plain float32 BNDM training steps: the pixel step (sigmoid gamma, two
heads, AdamW with a global-norm clip) and the latent step (linear alpha =
gamma = t / T, two heads, clip 1.0, AdamW at a cosine learning rate).

Both steps: ``alpha = t / T``; the blend ``x_a = alpha * noise + (1 - alpha)
* data``; the model sees ``(x_a, alpha)`` and predicts 2C channels; the
loss is ``sum |d1 - (data - noise)|^2 + sum_b w_b |d2 - alpha(t-1) (bn -
wn)|^2`` with ``w_b = (gamma(t) - gamma(t-1)) / (alpha(t) - alpha(t-1))``.
The gradient is clipped to global norm ``clip`` (left alone below it), then
AdamW: ``p *= 1 - lr wd``; ``m = b1 m + (1 - b1) g``; ``v = b2 v + (1 - b2)
g^2``; ``p -= lr m / (1 - b1^k) / (sqrt(v / (1 - b2^k)) + eps)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import nets
from perfbench.reference.noise import antithetic_t, train_noise


def sigmoid_gamma(t, T, tau, start, end):
    """The normalised reversed sigmoid of t / T with parameters (tau, start,
    end), clipped to [1e-9, 1] before the reversal."""
    u = ((t / T) * (end - start) + start) / tau
    num = math.tanh(end / tau / 2.0) - torch.tanh(u / 2.0)
    den = math.tanh(end / tau / 2.0) - math.tanh(start / tau / 2.0)
    return 1.0 - torch.clamp(num / den, 1e-9, 1.0)


def gamma_of(t, T, spec):
    if spec["scheduler_gamma"] == "linear":
        return t / T
    return sigmoid_gamma(t, T, spec["scheduler_param"], spec["scheduler_param_s"],
                         spec["scheduler_param_e"])


def cosine_lr(step, base, warmup, total):
    """The cosine learning-rate schedule after a linear warm-up, in
    float32."""
    f = np.float32
    if step < warmup:
        return float(f(base) * f(step) / f(max(1, warmup)))
    progress = min(max((f(step) - f(warmup)) / f(max(1, total - warmup)), f(0)), f(1))
    return float(f(base) * max(f(0), f(0.5) * (f(1) + np.cos(f(math.pi) * progress))))


def loss_and_grads(P, forward, settings, spec, data, key, L, q=nets.exact, rows=16,
                   keep=None):
    """The step's summed loss and the gradient of every entry of ``P``, in
    blocks of ``rows`` samples (the loss is a sum over samples), for the
    model ``forward(P, settings, x, t, q)`` (``perfbench.reference.model_of``).
    ``keep`` (the control's fault): only the first ``keep`` samples, their
    loss scaled up to the batch's."""
    T = spec["nb_steps"]
    b = data.shape[0]
    t = antithetic_t(key, b, T).to(data.device, torch.float32)
    alpha, alpha_prev = t / T, (t - 1.0) / T
    gamma, gamma_prev = gamma_of(t, T, spec), gamma_of(t - 1.0, T, spec)
    noise, bn, wn = train_noise(key, data.shape, gamma, L, data.device)
    weight = (gamma - gamma_prev) / (alpha - alpha_prev)
    names = list(P)
    leaves = [P[k].detach().requires_grad_() for k in names]
    params = dict(zip(names, leaves))
    grads = [torch.zeros_like(v) for v in leaves]
    total = 0.0
    c = data.shape[1]
    kept = b if keep is None else keep
    for s in range(0, kept, rows):
        sl = slice(s, min(s + rows, kept))
        a = alpha[sl].reshape(-1, 1, 1, 1)
        x_a = a * noise[sl] + (1.0 - a) * data[sl]
        d = forward(params, settings, x_a, alpha[sl], q)
        loss1 = ((d[:, :c] - (data[sl] - noise[sl])) ** 2).sum(dim=(1, 2, 3))
        tar2 = alpha_prev[sl].reshape(-1, 1, 1, 1) * (bn[sl] - wn[sl])
        loss2 = ((d[:, c:] - tar2) ** 2).sum(dim=(1, 2, 3))
        loss = loss1.sum() + (loss2 * weight[sl]).sum()
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc += g
        total += float(loss.detach().double())
    scale = b / kept
    return total * scale, {n: g * scale for n, g in zip(names, grads)}


def clip_global(grads, max_norm):
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    scale = max_norm / norm
    return {k: (g.double() * scale).float() for k, g in grads.items()}


class AdamW:
    """AdamW over a dict of float32 tensors, updated in place."""

    def __init__(self, P, betas, eps, weight_decay):
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}
        self.k = 0

    def step(self, P, grads, lr):
        self.k += 1
        c1, c2 = 1.0 - self.b1 ** self.k, 1.0 - self.b2 ** self.k
        for name, p in P.items():
            g = grads[name]
            p.mul_(1.0 - lr * self.wd)
            self.m[name].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[name] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[name], denom, value=-lr / c1)


def run_steps(P, forward, settings, spec, batches, keys, L, q=nets.exact, keep=None):
    """Follow the program's first steps of the model ``forward`` with
    ``settings``: ``P`` (the initial weights, float32) is updated in place.
    Returns the losses, the first step's clipped gradient and the weights
    after the last step (``P`` itself)."""
    opt = AdamW(P, tuple(spec["betas"]), spec["eps"], spec["weight_decay"])
    losses, first = [], None
    for k, (data, key) in enumerate(zip(batches, keys)):
        loss, grads = loss_and_grads(P, forward, settings, spec, data, key, L, q, keep=keep)
        grads = clip_global(grads, spec["grad_clip"])
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        lr = spec["lr"] if spec.get("lr_scheduler") is None else cosine_lr(
            k, spec["lr"], spec["lr_warmup_steps"], spec["lr_total_steps"])
        with torch.no_grad():
            opt.step(P, grads, lr)
        losses.append(loss)
    return losses, first, P
