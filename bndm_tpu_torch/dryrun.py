"""The multi-rank dry run, and the rank workers of the data-parallel checks.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: JAX runs one
process over an n-device mesh; here :func:`dryrun_multichip` starts n
processes (one rank each, joined over ``tcp://127.0.0.1``) and runs one step
of each of the seven legs at tiny shapes:

  1. the data-parallel train step (gaussianBN, the two-head UNet, both
     optimizers), after which every rank must hold the same weights;
  2. the same step on the 2-D (replica, data) hybrid mesh;
  3. microbatched sampling, each rank its block of the batch;
  4. cached (feature-reuse) sampling, likewise;
  5. conditional (super-res) training, then cached conditional sampling;
  6. a latent train step, then the microbatched VAE decode;
  7. the DDIM step with the EMA and gradient accumulation over 2 calls.

On the CPU the ranks join over gloo; on CUDA over NCCL for one rank and gloo
for more (NCCL refuses two ranks on one card, and ranks share the card
where there are fewer cards than ranks).

``python -m bndm_tpu_torch.dryrun`` is the rank worker (:func:`run_ranks`
starts it): ``--job legs`` the seven legs, ``--job grads`` one data-parallel
step's summed gradients on the inputs of an ``.npz``, written by rank 0.
"""

from __future__ import annotations

import argparse
import functools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"), attention_head_dim=4,
            norm_num_groups=4)


def free_port():
    """A TCP port free on localhost (for the ranks' rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, job_args, *, device, backend, timeout=120):
    """Run ``python -m bndm_tpu_torch.dryrun`` as ranks 0..n-1 of one job,
    each bounded by ``timeout`` seconds (every rank is killed when one
    fails or runs out of time). Returns each rank's output; raises with
    them on a failure. Each rank computes on one CPU thread."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH"))
                                          if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bndm_tpu_torch.dryrun", "--rank", str(r), "--world", str(n),
         "--port", str(port), "--device", device, "--backend", backend, *job_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=os.getcwd())
        for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = [None] * n
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            if outs[r] is None:
                outs[r] = p.communicate()[0]
    codes = [p.returncode for p in procs]
    if any(codes):
        report = "\n".join(f"--- rank {r} (exit {c}) ---\n{o}"
                           for r, (c, o) in enumerate(zip(codes, outs)))
        raise RuntimeError(f"{n} ranks of {job_args[:2]} failed (a timeout of {timeout}s "
                           f"kills them all):\n{report}")
    return outs


def default_backend(device, n):
    """gloo on the CPU and for several ranks on CUDA, NCCL for one."""
    return "nccl" if torch.device(device).type == "cuda" and n == 1 else "gloo"


def dryrun_multichip(n_devices: int, device="cuda", timeout=120):
    """Start ``n_devices`` ranks and run the seven legs (see the module
    doc) at tiny shapes; returns rank 0's output. ``device``: CUDA unless
    the caller asks for the CPU (raises when CUDA is missing)."""
    from bndm_tpu_torch.cli.common import resolve_device

    device = str(resolve_device(device))
    outs = run_ranks(n_devices, ["--job", "legs"], device=device,
                     backend=default_backend(device, n_devices), timeout=timeout)
    print(outs[0], end="", flush=True)
    return outs[0]


def _tril_L(n=4096, seed=7):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n)).astype(np.float32) * 0.01)
    np.fill_diagonal(L, 1.0)
    return L


def _unet(device, seed, in_channels=3, out_channels=6):
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig

    torch.manual_seed(seed)
    return UNet2D(UNet2DConfig(in_channels=in_channels, out_channels=out_channels, **TINY),
                  device=device)


def _same_on_every_rank(model):
    """Raise unless every rank holds the same weights (their float64 sum
    and the sum of their squares, gathered)."""
    import torch.distributed as dist

    w = torch.cat([p.detach().double().flatten() for p in model.parameters()])
    mine = torch.stack([w.sum(), (w * w).sum()]).cpu()
    sums = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather_object(sums, mine)
    if any(not torch.equal(s, sums[0]) for s in sums):
        raise AssertionError(f"the ranks' weights differ after the step: {sums}")


def _finite(x, what):
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: non-finite values")


def _legs(device, log):
    import torch.distributed as dist

    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig, make_decoder
    from bndm_tpu_torch.parallel import (gather_batch, global_mesh, hybrid_mesh, replicate,
                                         shard_batch)
    from bndm_tpu_torch.samplers.iadb import sample_iadb_cached, sample_iadb_microbatched
    from bndm_tpu_torch.serving import cached_forwards
    from bndm_tpu_torch.train.ddim import DDIMTrainConfig, make_ddim_train_step
    from bndm_tpu_torch.train.latent import LatentTrainConfig, make_latent_train_step
    from bndm_tpu_torch.train.pixel import PixelTrainer, TrainConfig
    from bndm_tpu_torch.train.schedules_lr import HFAdamW

    n = dist.get_world_size()
    mesh = global_mesh()
    L = torch.from_numpy(_tril_L()).to(device)
    cfg = TrainConfig(nb_steps=100, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                      gamma_defaults=(0.2, 0.0, 3.0), optimize_scheduler_param=True,
                      out_channel=6, grad_clip=1.0)

    def rows(seed, shape):  # every rank draws the global batch, keeps its block
        g = torch.Generator().manual_seed(seed)
        return shard_batch(mesh, torch.randn(shape, generator=g)).to(device)

    # the trains at 64^2 on CUDA, where the fresh draw takes the fused
    # kernel K2; at 32^2 on the CPU, which spends most of a 64^2 step in the
    # tiny UNet's attention
    train_res = 64 if torch.device(device).type == "cuda" else 32

    def batch(c=3, res=train_res, value=0.5):
        return shard_batch(mesh, torch.full((2 * n, c, res, res), value)).to(device)

    # 1. the data-parallel train step
    trainer = PixelTrainer(_unet(device, 0), cfg, L, mesh=mesh)
    replicate(mesh, trainer.state)
    loss = trainer.step(batch(), (1,))["loss"]
    _finite(loss, "DP train step")
    _same_on_every_rank(trainer.model)
    log(f"dryrun_multichip({n}): one DP train step OK, loss={float(loss):.3f}, "
        "the same weights on every rank")

    # 2. the same step on the hybrid (replica, data) mesh
    slices = 2 if n % 2 == 0 else 1
    hmesh = hybrid_mesh(num_slices=slices)
    htrainer = PixelTrainer(_unet(device, 0), cfg, L, mesh=hmesh)
    replicate(hmesh, htrainer.state)
    loss2 = htrainer.step(batch(), (1,))["loss"]
    _finite(loss2, "hybrid step")
    _same_on_every_rank(htrainer.model)
    log(f"dryrun_multichip({n}): hybrid {slices}x{n // slices} (replica, data) step OK, "
        f"loss={float(loss2):.3f}")

    # 3. microbatched sampling: each rank its block, two microbatches of 2
    model = trainer.model.eval()
    x0 = rows(3, (4 * n, 3, 32, 32))
    out = gather_batch(mesh, sample_iadb_microbatched(model, x0, microbatch=2, nb_steps=8,
                                                      two_head=True))
    _finite(out, "microbatched sampling")
    log(f"dryrun_multichip({n}): microbatched sampling OK, out shape {tuple(out.shape)}")

    # 4. cached (feature-reuse) sampling
    outc = gather_batch(mesh, sample_iadb_cached(*cached_forwards(model),
                                                 rows(4, (2 * n, 3, 32, 32)), nb_steps=8,
                                                 cache_interval=3, two_head=True))
    _finite(outc, "cached sampling")
    log(f"dryrun_multichip({n}): cached (feature-reuse) sampling OK, "
        f"out shape {tuple(outc.shape)}")

    # 5. conditional training, then cached conditional sampling
    import dataclasses

    ctr = PixelTrainer(_unet(device, 2, in_channels=6), dataclasses.replace(cfg, conditional=True),
                       L, mesh=mesh)
    replicate(mesh, ctr.state)
    _finite(ctr.step(batch(), (3,))["loss"], "conditional train step")
    outs = gather_batch(mesh, sample_iadb_cached(
        *cached_forwards(ctr.model.eval()), rows(6, (2 * n, 3, 32, 32)), nb_steps=6,
        cache_interval=3, two_head=True, x_c=rows(5, (2 * n, 3, 32, 32))))
    _finite(outs, "conditional cached sampling")
    log(f"dryrun_multichip({n}): conditional (x_c) train + cached sampling OK, "
        f"out shape {tuple(outs.shape)}")

    # 6. a latent train step, then the microbatched VAE decode
    lstep, linit = make_latent_train_step(
        LatentTrainConfig(noise_type="gaussianBN", out_channels=8), L,
        functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4), mesh)
    lstate = replicate(mesh, linit(_unet(device, 4, in_channels=4, out_channels=8).train()))
    _finite(lstep(lstate, batch(c=4, value=0.1), (5,))["loss"], "latent train step")
    torch.manual_seed(6)
    vae = AutoencoderKL(VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                                  norm_num_groups=4), device=device).eval()
    img = gather_batch(mesh, make_decoder(vae, microbatch=1)(rows(7, (2 * n, 4, 8, 8))))
    _finite(img, "VAE decode")
    log(f"dryrun_multichip({n}): latent train step + microbatched VAE decode OK, decoded "
        f"{tuple(img.shape)}")

    # 7. the DDIM step with the EMA and accumulation over 2 calls
    dstep, dinit = make_ddim_train_step(
        DDIMTrainConfig(use_ema=True),
        functools.partial(HFAdamW, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                          schedule=lambda step: 1e-4, accum=2), mesh)
    dstate = replicate(mesh, dinit(_unet(device, 8, out_channels=3).train()))
    for i in range(2):  # two micro-batches: one update
        dloss = dstep(dstate, batch(res=16), (9 + i,))["loss"]
    _finite(dloss, "DDIM step")
    if dstate.ema.step != 2 or dstate.opt.count != 1:
        raise AssertionError(f"EMA steps {dstate.ema.step}, updates {dstate.opt.count}")
    _same_on_every_rank(dstate.model)
    log(f"dryrun_multichip({n}): EMA + grad-accum (k=2) DDIM train OK, "
        f"loss={float(dloss):.3f}")


class RankView:
    """Rank ``pos`` of a 1-D mesh of ``count`` ranks as a train step sees
    it (its position and the count), in one process with no process group:
    :func:`split_grads` steps each rank's rows in turn. No collective runs
    through it."""

    ndim = 1

    def __init__(self, pos, count):
        self.pos, self.count = pos, count

    def get_coordinate(self):
        return [self.pos]

    def size(self, axis=None):
        return self.count


def split_grads(cfg, L, model, sched_params, x1, t, noise, count):
    """The gradients that ``count`` ranks sum, computed in this process:
    each rank's share of the pixel step's loss over its block of ``x1``
    (``t`` and ``noise`` are the global batch's draw), backpropagated in
    turn, so that ``.grad`` holds their sum as the all-reduce adds them.
    The model's and ``sched_params``' gradients must be None or zero on
    entry. Returns the summed loss."""
    from bndm_tpu_torch.parallel.mesh import block_rows
    from bndm_tpu_torch.train.pixel import make_train_step

    total = 0.0
    for pos in range(count):
        view = RankView(pos, count)
        step, _ = make_train_step(cfg, L, view)
        loss = step.loss_fn(model, sched_params, x1[block_rows(view, x1.shape[0])], t, noise)
        loss.backward()
        total = total + loss.detach()
    return total


def _grads(device, inputs, out, full_width):
    """One data-parallel step's gradients on the ``inputs`` (an ``.npz``:
    the covariance factor ``L``, the init ``seed``, the global batch
    ``x1``, and ``t`` with the white noise ``white``, or a ``key`` to draw
    them from as the train step does), this rank taking its rows; rank 0
    writes the global loss, the schedule's and the model's summed gradients,
    K2's and K3's launches in the step (counted on CUDA) and the median time
    of an all-reduce of the gradient's values to ``out``. Full width is the
    two-head res-64 UNet in fp32: its summed gradient is held to the
    one-rank step's within fp32 rounding."""
    import torch.distributed as dist

    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.ops.cuda_bluenoise import FusedBlueNoise, fused_bluenoise_flat
    from bndm_tpu_torch.parallel import global_mesh, replicate, shard_batch
    from bndm_tpu_torch.train.pixel import make_train_step

    torch.backends.cudnn.deterministic = True  # the algorithms split_grads runs
    mesh = global_mesh()
    data = np.load(inputs)
    cfg = grads_config(full_width)
    L = torch.from_numpy(data["L"]).to(device)
    torch.manual_seed(int(data["seed"]))
    model = UNet2D(unet_config_for_res(64, 3, 6) if full_width else _tiny_config(),
                   device=device).train()
    step, init = make_train_step(cfg, L, mesh)
    state = replicate(mesh, init(model, torch.Generator().manual_seed(0)))
    x1 = shard_batch(mesh, torch.from_numpy(data["x1"])).to(device)
    if "white" in data:
        t = torch.from_numpy(data["t"]).to(device)
        noise = torch.from_numpy(data["white"]).to(device)
    else:
        t, noise = step.draw(x1, tuple(int(k) for k in data["key"]))
    reset = [fused_bluenoise_flat, FusedBlueNoise]
    for fn in reset:
        fn.launches = 0
    loss = step.compute_grads(state, x1, t, noise)
    launches = [fn.launches for fn in reset]
    # the all-reduce of a step: the gradient's values summed over the ranks
    flat = torch.cat([p.grad.detach().flatten() for p in model.parameters()])
    times = []
    for _ in range(3):
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        _sync(device)
        times.append(time.perf_counter() - t0)
    if dist.get_rank() == 0:
        grads = {k: p.grad.detach().float().cpu().numpy() for k, p in model.named_parameters()}
        np.savez(out, loss=loss.cpu().numpy(), sched=state.sched_params.grad.cpu().numpy(),
                 allreduce_ms=1e3 * sorted(times)[1], launches=np.array(launches),
                 **{f"g/{k}": v for k, v in grads.items()})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tiny_config():
    from bndm_tpu_torch.models.unet2d import UNet2DConfig

    return UNet2DConfig(in_channels=3, out_channels=6, **TINY)


def grads_config(full_width):
    """The train config of ``--job grads``: gaussianBN, two heads, the
    sigmoid schedule at (0.2, 0, 3) (the JAX gradient-parity worker's,
    whose (tau, s, e) get a gradient though they are not optimized); at
    full width T = 1000 and the clip of scripts/training/iadb_bn_cat_res64.sh.
    That script's tau = 1000 makes the normalized sigmoid linear in t, so
    its gradient to (tau, s, e) is zero but for fp32 cancellation: nothing
    to hold two runs to."""
    from bndm_tpu_torch.train.pixel import TrainConfig

    if full_width:
        return TrainConfig(nb_steps=1000, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                           gamma_defaults=(0.2, 0.0, 3.0), out_channel=6, grad_clip=1.0)
    return TrainConfig(nb_steps=100, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                       gamma_defaults=(0.2, 0.0, 3.0), out_channel=6)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", type=str, required=True)
    p.add_argument("--backend", type=str, required=True)
    p.add_argument("--job", choices=("legs", "grads"), required=True)
    p.add_argument("--inputs", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--full_width", action="store_true")
    args = p.parse_args(argv)

    from bndm_tpu_torch.cli.common import disable_tf32
    from bndm_tpu_torch.parallel import init_distributed, shutdown

    torch.set_num_threads(1)
    disable_tf32()
    device = init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                              device=args.device, backend=args.backend)
    try:
        if args.job == "legs":
            _legs(device, (lambda msg: print(msg, flush=True)) if args.rank == 0
                  else (lambda msg: None))
        else:
            _grads(device, args.inputs, args.out, args.full_width)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
