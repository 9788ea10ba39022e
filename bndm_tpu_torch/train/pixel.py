"""Pixel-space IADB/BNDM training (the reference's main workload).

Counterpart of ``bndm_tpu/train/pixel.py``: one train step holds timestep
sampling, the noise engine, the optional batch-OT remap, the UNet forward and
backward, and BOTH optimizers (model AdamW, then AdamW on the learnable
(tau, s, e) gamma parameters with a clamp after the step). One loss is
backpropagated into the model and into (tau, s, e): the gradient reaches the
schedule through the loss weights and through the noise mix, on CUDA through
K3 (:class:`~bndm_tpu_torch.ops.cuda_bluenoise.FusedBlueNoise`).

Parameters stay fp32; the modules compute in their configured dtype (bf16
from the CLI). Randomness comes from a key, a tuple of ints such as
(seed, step), the counterpart of a folded ``jax.random`` key.

Data parallel (a ``mesh`` from ``bndm_tpu_torch/parallel``): each rank holds
its block of rows of the global batch, draws t and the noise for the whole
global batch from the key and keeps its rows (the antithetic pairs span the
global batch; K2 runs at the global M and the rank keeps its columns), and
backpropagates its rows' share of the summed loss. The model's gradient is
summed over the ranks by ``DistributedDataParallel``, the schedule's by one
all-reduce, before the clip: the step is the global batch's, as JAX's
sharded step is.

On one CUDA device (:func:`graphs_unet`) the UNet's forward and backward,
which make most of the step's launches, replay as captured CUDA graphs
(:class:`UNetGraphs`): for that part of the step, the counterpart of the
JAX step's one jitted program. The rest of the step stays eager.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from bndm_tpu_torch.cli.common import make_generator
from bndm_tpu_torch.ops.noise import draw_seeds, fresh_shape, get_noise, takes_fused
from bndm_tpu_torch.ops.schedules import alpha_schedule, gamma_param_ranges, gamma_schedule
from bndm_tpu_torch.parallel.mesh import (all_reduce_sum_, data_shard, gather_batch, local_rows,
                                          wrap_ddp)
from bndm_tpu_torch.train.losses import antithetic_timesteps, bndm_loss, iadb_loss, remap_batch
from bndm_tpu_torch.utils.image import superres_condition
from bndm_tpu_torch.utils.timing import span

# optax.adamw's default; torch.optim.AdamW's own default is 1e-2
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the iadb_bn argparse surface."""

    nb_steps: int = 1000
    noise_type: str = "gaussianBN"
    scheduler_alpha: str = "linear"
    alpha_param: float = 0.02
    scheduler_gamma: str = "sigmoid"
    gamma_defaults: Tuple[float, float, float] = (0.02, 0.0, 3.0)
    optimize_scheduler_param: bool = False
    out_channel: int = 6
    data_channels: int = 3
    lr: float = 1e-4
    sched_lr: float = 1e-3
    optimizer_type: str = "adamw"
    grad_clip: Optional[float] = None
    remap: bool = False
    conditional: bool = False  # superres: concat conditioning (in_channels 6)
    # "auto": the fused kernel K2 where eligible (a fresh res-64 draw on
    # CUDA; ops/noise.py::takes_fused), the unfused path elsewhere. "xla"
    # keeps the torch.randn stream everywhere.
    noise_engine: str = "auto"
    remat: bool = False  # recompute the UNet's activations in the backward

    @property
    def two_head(self):
        return (
            self.noise_type in ("gaussianBN", "gaussianRN")
            and self.out_channel == 2 * self.data_channels
        )


@dataclasses.dataclass
class TrainState:
    """The whole train state; the step updates it in place. ``forward`` is
    the module the step calls: the model itself, or its
    ``DistributedDataParallel`` wrapper (not part of the state_dict)."""

    model: torch.nn.Module
    opt: torch.optim.Optimizer
    sched_params: torch.Tensor  # (3,) = (tau, s, e), fp32, a leaf with grad
    sched_opt: torch.optim.Optimizer
    step: int = 0
    forward: Optional[torch.nn.Module] = None

    def state_dict(self):
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict(),
                "sched_params": self.sched_params.detach().cpu(),
                "sched_opt": self.sched_opt.state_dict(), "step": int(self.step)}

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        with torch.no_grad():
            self.sched_params.copy_(sd["sched_params"])
        self.sched_opt.load_state_dict(sd["sched_opt"])
        self.step = int(sd["step"])


def _make_optimizer(cfg: TrainConfig, params):
    """optax.adam / optax.adamw(lr) (the gradient clip, if any, is applied by
    the step before this optimizer steps)."""
    if cfg.optimizer_type == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)
    if cfg.optimizer_type == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, eps=1e-8, weight_decay=WEIGHT_DECAY)
    raise KeyError(cfg.optimizer_type)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm):
    """optax.clip_by_global_norm in place: the grads are left as they are
    when their global norm is below ``max_norm``, else scaled by
    ``max_norm / norm`` (torch's clip_grad_norm_ divides by norm + 1e-6
    instead). The decision stays on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def init_sched_params(generator, cfg: TrainConfig, device=None):
    """Uniform init inside the per-schedule ranges (the defaults exactly when
    they are not optimized)."""
    ranges = gamma_param_ranges(cfg.scheduler_gamma, cfg.optimize_scheduler_param,
                                cfg.gamma_defaults)
    lo = torch.tensor([r[0] for r in ranges], dtype=torch.float32)
    hi = torch.tensor([r[1] for r in ranges], dtype=torch.float32)
    u = torch.rand(3, generator=generator)
    return (lo + (hi - lo) * u).to(device)


def global_like(x, count):
    """A view of ``x``'s shape with ``count`` times its rows (no memory of
    its own): what the noise engine draws for the global batch reads only
    its shape, device and dtype. ``x`` itself for one rank."""
    if count == 1:
        return x
    return x[:1].expand(x.shape[0] * count, *x.shape[1:])


def draw_noise(x, key, noise_type, engine):
    """A train step's fresh noise draw for data ``x``, from ``key``: K2's
    two host-int seeds (a tuple) where :func:`takes_fused` says the fused
    path runs, else the white noise of :func:`fresh_shape` on x's device
    (uniform for ``uniform``). ``get_noise`` takes either as ``seeds=`` or
    ``white=``. A data-parallel step passes the global batch's shape
    (:func:`global_like`)."""
    if takes_fused(x, noise_type, False, engine):
        return draw_seeds(make_generator("cpu", *key, 1))
    shape = fresh_shape(x.shape, noise_type)
    gen = make_generator(x.device, *key, 2)
    if noise_type == "uniform":
        return torch.rand(shape, generator=gen, device=x.device)
    return torch.randn(shape, generator=gen, device=x.device)


def graphs_unet(device, mesh, remat, training):
    """Whether the train step replays the UNet as captured CUDA graphs: its
    parameters on ``device`` of type CUDA, one process (no ``mesh``: DDP's
    hooks run between the backward's kernels), no ``remat`` (the backward
    recomputes the forward) and the model in ``training`` mode."""
    return torch.device(device).type == "cuda" and mesh is None and not remat and training


class _Call(torch.nn.Module):
    """``model(inp, alpha)`` as a module of its own: ``make_graphed_callables``
    replaces the forward of the module it is given, and the model's own
    forward stays as it is."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, inp, alpha):
        return self.model(inp, alpha)


class UNetGraphs:
    """``model(inp, alpha)`` and its backward as a pair of captured CUDA
    graphs (``torch.cuda.make_graphed_callables``), replayed at every call:
    a pair for each signature of the inputs (shape, dtype, requires_grad,
    and whether grad mode is on), captured at its first call after the
    warm-up that capture needs. The backward returns the input's gradient
    too, where ``inp`` requires it.

    The graphs read the parameters' storage: a change of it (a load that
    assigns, a cast or a move) drops them. The parameters' ``.grad`` are the
    backward graph's own buffers until the next replay, so the step sets
    them to None before each forward (``zero_grad``), as the train step
    does. ``captures`` counts the pairs captured, ``replays`` the calls."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs = {}
        self._storage = None

    def __call__(self, model, inp, alpha):
        storage = (model, tuple(p.data_ptr() for p in model.parameters()))
        if storage != self._storage:
            self._graphs.clear()
            self._storage = storage
        key = (torch.is_grad_enabled(),) + tuple(
            (tuple(x.shape), x.dtype, x.requires_grad) for x in (inp, alpha))
        graphed = self._graphs.get(key)
        if graphed is None:
            sample = tuple(x.detach().clone().requires_grad_(x.requires_grad)
                           for x in (inp, alpha))
            graphed = self._graphs[key] = torch.cuda.make_graphed_callables(_Call(model),
                                                                            sample)
            self.captures += 1
        self.replays += 1
        return graphed(inp, alpha)


def make_train_step(cfg: TrainConfig, L, mesh=None):
    """Build the train step: ``train_step(state, batch01, key) -> metrics``.

    ``batch01``: images in [0, 1] on the model's device (the loader's
    output; with a ``mesh``, this rank's block of the global batch);
    ``x1 = batch01*2 - 1`` happens here. ``key`` is a tuple of ints (e.g.
    (seed, step)) from which the step draws t and its noise for the global
    batch on the host: K2's two seeds where the fused path runs, else white
    noise on the device. The step updates ``state`` in place; ``metrics``
    are device tensors (the global loss), read by the caller when it wants
    them. Returns ``(train_step, init_state)``.
    """
    ranges = gamma_param_ranges(cfg.scheduler_gamma, cfg.optimize_scheduler_param,
                                cfg.gamma_defaults)
    clamp_lo = torch.tensor([r[0] for r in ranges], dtype=torch.float32, device=L.device)
    clamp_hi = torch.tensor([r[1] for r in ranges], dtype=torch.float32, device=L.device)
    correlated = cfg.noise_type in ("gaussianBN", "gaussianRN", "GBN")

    count = data_shard(mesh)[1]
    unet_graph = UNetGraphs()

    def loss_fn(model, sched_params, x1, t, noise):
        """This rank's share of the step's loss: the sum over its rows
        ``x1`` of the global batch. ``t`` (B,) and ``noise`` are the global
        batch's draw: K2's two host-int seeds (a tuple) or the white noise
        the unfused path would draw (a tensor of ``fresh_shape``)."""
        alpha_all = alpha_schedule(t, cfg.nb_steps, cfg.scheduler_alpha, cfg.alpha_param)
        gamma_all = gamma_schedule(t, cfg.nb_steps, cfg.scheduler_gamma, sched_params)
        draw = {"seeds": noise} if isinstance(noise, tuple) else {"white": noise}
        with span("train.noise"):
            r_all = get_noise(global_like(x1, count), L, gamma_all, noise_type=cfg.noise_type,
                              train=True, inplace=False, engine=cfg.noise_engine, **draw)
        r = type(r_all)(*local_rows(mesh, *r_all))
        alpha, gamma, t = local_rows(mesh, alpha_all, gamma_all, t)
        x0 = r.noise
        if cfg.remap:  # the batch-OT pairing spans the global batch
            x1_all = gather_batch(mesh, x1)
            x1_paired = local_rows(mesh, x1_all[remap_batch(r_all.noise, x1_all)])[0]
        else:
            x1_paired = x1
        a = alpha.reshape(-1, 1, 1, 1)
        x_alpha = a * x0 + (1.0 - a) * x1_paired  # x1 = data, x0 = noise
        inp = x_alpha
        if cfg.conditional:
            inp = torch.cat([x_alpha, superres_condition(x1_paired)], dim=1)
        if graphs_unet(next(model.parameters()).device, mesh, cfg.remat, model.training):
            with span("train.unet_graph"):
                d = unet_graph(model, inp, alpha)
        elif cfg.remat:
            d = checkpoint(model, inp, alpha, use_reentrant=False)
        else:
            d = model(inp, alpha)
        alpha_prev = alpha_schedule(t - 1.0, cfg.nb_steps, cfg.scheduler_alpha, cfg.alpha_param)
        gamma_prev = gamma_schedule(t - 1.0, cfg.nb_steps, cfg.scheduler_gamma, sched_params)
        if correlated and cfg.noise_type != "GBN":
            return bndm_loss(d, x1_paired, x0, r.noise_bn, r.noise_wn,
                             alpha, alpha_prev, gamma, gamma_prev, cfg.two_head)
        return iadb_loss(d, x1_paired, x0)

    def compute_grads(state: TrainState, x1, t, noise):
        """Backpropagate this rank's share of the loss into ``.grad`` (DDP
        sums the model's gradient over the ranks), then sum the schedule's
        gradient and the loss over the ranks. Returns the global loss."""
        with span("train.zero_grad"):
            state.opt.zero_grad(set_to_none=True)
            state.sched_opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = loss_fn(state.forward or state.model, state.sched_params, x1, t, noise)
        with span("train.backward"):
            loss.backward()
        loss = loss.detach()
        if mesh is not None:
            if state.sched_params.grad is None:  # a schedule without (tau, s, e)
                state.sched_params.grad = torch.zeros_like(state.sched_params)
            all_reduce_sum_(mesh, [state.sched_params.grad, loss])
        return loss

    def draw(x1, key):
        """t (B,) and the noise draw for the global batch of which ``x1``
        holds this rank's rows, from ``key``."""
        with span("train.draw"):
            like = global_like(x1, count)
            t = antithetic_timesteps(make_generator("cpu", *key), like.shape[0], cfg.nb_steps)
            return t.to(L.device, torch.float32), draw_noise(like, key, cfg.noise_type,
                                                             cfg.noise_engine)

    def train_step(state: TrainState, batch01, key):
        with span("train.step"):
            x1 = batch01.to(L.device, torch.float32) * 2.0 - 1.0
            t, noise = draw(x1, key)
            loss = compute_grads(state, x1, t, noise)
            apply_gradients(state)
            sp = state.sched_params.detach().clone()
        return {"loss": loss, "sched_tau": sp[0], "sched_s": sp[1], "sched_e": sp[2]}

    def apply_gradients(state: TrainState):
        """Both optimizers on the gradients in ``.grad`` (summed over the
        ranks already): the clip (model only), the model's step, the
        schedule's step, then the clamp."""
        with span("train.optimizer"):
            if cfg.grad_clip is not None:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                clip_by_global_norm_(grads, cfg.grad_clip)
            state.opt.step()
            if state.sched_params.grad is None:  # a schedule without (tau, s, e)
                state.sched_params.grad = torch.zeros_like(state.sched_params)
            state.sched_opt.step()
            with torch.no_grad():
                state.sched_params.copy_(torch.clamp(state.sched_params, clamp_lo, clamp_hi))
        state.step += 1

    def init_state(model, generator):
        sched_params = init_sched_params(generator, cfg, L.device).requires_grad_()
        return TrainState(
            model=model,
            opt=_make_optimizer(cfg, model.parameters()),
            sched_params=sched_params,
            sched_opt=torch.optim.AdamW([sched_params], lr=cfg.sched_lr, eps=1e-8,
                                        weight_decay=WEIGHT_DECAY),
            forward=wrap_ddp(model, mesh),
        )

    # exposed for tests (parity of the loss, its gradients and the update)
    train_step.loss_fn = loss_fn
    train_step.draw = draw
    train_step.compute_grads = compute_grads
    train_step.apply_gradients = apply_gradients
    train_step.unet_graph = unet_graph  # its .captures and .replays
    return train_step, init_state


class PixelTrainer:
    """Convenience wrapper: model + config + L-matrix -> stateful trainer.
    The model's parameters are trained as they are (fp32); ``L`` moves to
    the model's device. With a ``mesh``, the trainer steps on this rank's
    rows of each global batch."""

    def __init__(self, model, cfg: TrainConfig, L, seed=0, mesh=None):
        self.model = model
        self.cfg = cfg
        device = next(model.parameters()).device
        self.L = torch.as_tensor(L, dtype=torch.float32).to(device).contiguous()
        self.train_step, init_state = make_train_step(cfg, self.L, mesh)
        self.state = init_state(model, make_generator("cpu", seed))

    def step(self, batch01, key):
        return self.train_step(self.state, batch01, key)
