"""Pixel-space IADB/BNDM CLI in PyTorch, flag-compatible with the reference.

Counterpart of ``bndm_tpu/cli/iadb_bn.py``: the same argparse surface plus
``--device``, the same run-folder and file names, the train mode and the two
test modes (unconditional sampling and conditional super-res). It runs on
CUDA unless ``--device=cpu`` is given, and raises when CUDA is missing.

Usage (the reference's scripts, with this module):
  train: --dataset=cat_res64 --res=64 --batch_size=64 --epochs=1000 \
         --train_or_test=train --lr=0.0001 --grad_clip=1.0 \
         --noise_type=gaussianBN --scheduler_gamma=sigmoid \
         --scheduler_param=1000 --out_channel=6
  test:  --dataset=cat_res64 --res=64 --batch_size=500 --train_or_test=test \
         --nb_steps=250 --test_samples=30000 --noise_type=gaussianBN \
         --scheduler_gamma=sigmoid --scheduler_param=1000 --out_channel=6

The test modes serve through the tiers of ``bndm_tpu_torch/serving.py``
as the JAX CLI does: ``--conv_int8`` (``--int8_mode``), ``--static_gn``,
``--gn_carry``, ``--cache_interval``/``--cache_depth``,
``--attn_softmax_dtype`` (the serving model only) and ``--microbatch``,
with the JAX CLI's checks of their combinations; as there, super-res
leaves ``--gn_carry`` out and checks only ``--static_gn``. The sampling
flags have no effect in train mode, where ``--conv_int8`` trains through
the straight-through int8 convs and ``--attn_softmax_dtype`` is honored.

Data parallelism: ``--coordinator_address host:port --num_processes N
--process_id i`` (the JAX CLI's flags) start one process per rank; each
loads ``batch_size // N`` rows of every global batch and trains through
``DistributedDataParallel`` (NCCL on CUDA, gloo on the CPU), and in the
test modes each denoises its block of every batch. Rank 0 writes every
file.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from bndm_tpu_torch.cli.hf_args import cache_interval_type


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # the reference's flags, every one kept
    p.add_argument("--dataset", type=str, default="celeba_small")
    p.add_argument("--noise_type", type=str, default="gaussian")
    p.add_argument("--optimizer_type", type=str, default="adamw")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--train_or_test", type=str, default="train")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nb_steps", type=int, default=1000)
    p.add_argument("--scheduler_alpha", type=str, default="linear")
    p.add_argument("--scheduler_gamma", type=str, default="linear")
    p.add_argument("--scheduler_param", type=float, default=0.02)
    p.add_argument("--scheduler_param_s", type=float, default=0)
    p.add_argument("--scheduler_param_e", type=float, default=3)
    p.add_argument("--blue_noise_blur", type=float, default=None)
    p.add_argument("--activation", type=str, default="silu")
    p.add_argument("--early_stopping_step", type=int, default=50)
    p.add_argument("--split_step", type=int, default=900)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--mode_index", type=int, default=1)
    p.add_argument("--reg_weight", type=float, default=1)
    p.add_argument("--alpha_min", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--optimize_scheduler_param", action="store_true")
    p.add_argument("--remap", action="store_true")
    p.add_argument("--is_conditional", action="store_true")
    p.add_argument("--conditional_type", type=str, default="superres")
    p.add_argument("--fine_tune_mode_index", type=int, default=0)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--test_samples", type=int, default=10)
    p.add_argument("--out_channel", type=int, default=6)
    # the JAX package's extensions
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--bluenoise_dir", type=str, default="bluenoise")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--norm_dtype", type=str, default="float32",
                   help="GroupNorm compute dtype; float32 is diffusers parity")
    p.add_argument("--max_steps", type=int, default=None, help="cap train steps (smoke runs)")
    p.add_argument("--tiny_model", action="store_true",
                   help="swap in a tiny UNet (CI / smoke tests only)")
    p.add_argument("--save_all_samples", action="store_true",
                   help="save every sample of every batch (the reference's "
                        "replicability mode saves only sample 0 of selected batches)")
    p.add_argument("--save_noise", action="store_true",
                   help="save each batch's initial noise as noise_batch{B}_idx{i}.npz "
                        "so DDIM/BNDM runs can consume identical x0")
    p.add_argument("--export_reference_ckpt", action="store_true")
    p.add_argument("--noise_engine", type=str, default="auto",
                   choices=["auto", "xla", "fused"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--conv_int8", action="store_true")
    p.add_argument("--int8_mode", type=str, default="static", choices=["dynamic", "static"])
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the first sampled batch "
                        "(test mode, unconditional branch) into this folder")
    p.add_argument("--static_gn", action="store_true")
    p.add_argument("--attn_softmax_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--microbatch", type=int, default=None)
    p.add_argument("--cache_interval", type=cache_interval_type, default=None)
    p.add_argument("--cache_depth", type=int, default=1)
    p.add_argument("--gn_carry", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p.parse_args(argv)


def _check_serving_flags(opt):
    """The JAX CLI's checks of the serving flags' combinations."""
    if opt.static_gn and opt.scheduler_alpha != "linear":
        raise SystemExit("--static_gn requires the linear alpha schedule "
                         "(the per-step GN tables are indexed by "
                         "round(alpha*T) — ops/static_norm.py)")
    if opt.gn_carry and opt.static_gn:
        raise SystemExit("--gn_carry and --static_gn both replace GroupNorm "
                         "— pick one")
    if opt.gn_carry and not (opt.cache_interval and opt.cache_interval > 1):
        raise SystemExit("--gn_carry reuses stats across a cached group — "
                         "it requires --cache_interval > 1")


def build(opt, device):
    from bndm_tpu_torch.cli.common import load_L_for, output_folder_name
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, unet_config_for_res
    from bndm_tpu_torch.train.pixel import TrainConfig

    if opt.noise_type not in ("gaussianBN", "gaussianRN"):
        opt.out_channel = 3  # reference iadb_bn.py:476-479

    in_ch = 6 if opt.is_conditional else 3  # superres concat
    if opt.tiny_model:
        mcfg = UNet2DConfig(
            in_channels=in_ch, out_channels=opt.out_channel,
            block_out_channels=(8, 16),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
            attention_head_dim=4, norm_num_groups=4,
            act_fn=opt.activation, dtype=opt.compute_dtype, conv_int8=opt.conv_int8,
        )
    else:
        mcfg = unet_config_for_res(opt.res, in_channels=in_ch, out_channels=opt.out_channel,
                                   act_fn=opt.activation, dtype=opt.compute_dtype,
                                   conv_int8=opt.conv_int8)
    kw = {}
    if opt.cache_depth != 1:
        kw["cache_depth"] = opt.cache_depth
    if opt.norm_dtype != "float32":
        kw["norm_dtype"] = opt.norm_dtype
    if opt.attn_softmax_dtype != "float32" and opt.train_or_test == "train":
        # test mode relaxes the serving model only (serving_relax_kw)
        print(f"NOTE: training with attention softmax in {opt.attn_softmax_dtype}")
        kw["attn_softmax_dtype"] = opt.attn_softmax_dtype
    if kw:
        import dataclasses

        mcfg = dataclasses.replace(mcfg, **kw)
    model = UNet2D(mcfg, device=device)
    tcfg = TrainConfig(
        nb_steps=opt.nb_steps,
        noise_type=opt.noise_type,
        scheduler_alpha=opt.scheduler_alpha,
        alpha_param=opt.scheduler_param,
        scheduler_gamma=opt.scheduler_gamma,
        gamma_defaults=(opt.scheduler_param, opt.scheduler_param_s, opt.scheduler_param_e),
        optimize_scheduler_param=opt.optimize_scheduler_param,
        out_channel=opt.out_channel,
        lr=opt.lr,
        optimizer_type=opt.optimizer_type,
        grad_clip=opt.grad_clip,
        remap=opt.remap,
        conditional=opt.is_conditional,
        noise_engine=opt.noise_engine,
        remat=opt.remat,
    )
    L = load_L_for(opt.noise_type, opt.bluenoise_dir)
    out_dir = output_folder_name(opt)
    return model, tcfg, L, out_dir


def run_train(opt, device):
    from bndm_tpu_torch.ckpt.manager import CheckpointManager
    from bndm_tpu_torch.cli.common import is_main_process, load_pixel_unet_params, save_params
    from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset
    from bndm_tpu_torch.models.convert import export_torch_ckpt, flax_from_state_dict
    from bndm_tpu_torch.parallel.distributed import barrier
    from bndm_tpu_torch.parallel.mesh import data_shard, replicate, run_mesh
    from bndm_tpu_torch.train.pixel import PixelTrainer
    from bndm_tpu_torch.utils.logging import (MetricLogger, save_loss_curve,
                                              save_sched_param_curves)

    torch.manual_seed(opt.seed)  # the model's random init
    model, tcfg, L, out_dir = build(opt, device)
    main = is_main_process()
    os.makedirs(out_dir, exist_ok=True)
    if main:
        print("output_folder:", out_dir)

    suffix = "_train" if opt.is_conditional else ""
    ds = ImageFolderDataset(os.path.join(opt.data_root, opt.dataset + suffix), opt.res,
                            random_flip=True, seed=opt.seed)
    # each rank loads its block of the global batch (the whole of it alone)
    mesh = run_mesh(opt.batch_size)
    shard_index, shard_count = data_shard(mesh)
    loader = BatchLoader(ds, opt.batch_size // shard_count, seed=opt.seed,
                         shard_index=shard_index, shard_count=shard_count)
    trainer = PixelTrainer(model.train(), tcfg, L, seed=opt.seed, mesh=mesh)

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    start_step = 0
    if opt.resume_training:
        # full-state resume (weights + both optimizers + sched params +
        # step); falls back to the reference's weights-only model file
        if mgr.restore(trainer.state) is not None:
            start_step = trainer.state.step
            print(f"resumed full state at step {start_step}")
        else:
            try:
                model.load_state_dict(load_pixel_unet_params(out_dir), strict=True)
                print("resumed weights only (reference-style, model.npz or torch model.ckpt)")
            except FileNotFoundError:
                pass
    replicate(mesh, trainer.state)  # every rank starts from rank 0's state
    logger = MetricLogger(os.path.join(out_dir, "logs")) if main else None

    losses = []
    sp_hist = [[], [], []]
    step = start_step
    t0 = time.time()
    for epoch in range(opt.epochs):
        # device tensors, read once per epoch: no host sync per step
        epoch_metrics = []
        for batch in loader.epoch(epoch):
            batch = torch.from_numpy(batch).to(device, non_blocking=True)
            epoch_metrics.append(trainer.step(batch, (opt.seed, step)))
            step += 1
            if opt.max_steps and step >= opt.max_steps:
                break
        if not epoch_metrics:
            raise ValueError(f"an epoch of {len(ds)} images has no batch of {opt.batch_size}")
        keys = ("loss", "sched_tau", "sched_s", "sched_e")
        fetched = torch.stack([torch.stack([m[k] for k in keys])
                               for m in epoch_metrics]).cpu().numpy()
        losses.extend(float(v) for v in fetched[:, 0])
        for j in range(3):
            sp_hist[j].extend(float(v) for v in fetched[:, 1 + j])
        if main:  # rank 0 writes; every rank waits for it below
            for off, row in enumerate(fetched):
                logger.log({"loss": row[0]}, step - len(fetched) + off)
            tau, s, e = fetched[-1, 1:]
            print(f"epoch {epoch}: mean loss {np.mean(losses[-max(len(loader), 1):]):.2f} "
                  f"sched_params tau={tau:.4f} s={s:.4f} e={e:.4f} "
                  f"({step} steps, {time.time() - t0:.0f}s)")
            np.savetxt(os.path.join(out_dir, "losses.txt"), np.asarray(losses))
            np.savetxt(os.path.join(out_dir, "scheduler_params.txt"),
                       trainer.state.sched_params.detach().cpu().numpy())
            save_loss_curve(losses, os.path.join(out_dir, "losses.png"))
            save_sched_param_curves(*sp_hist, os.path.join(out_dir, "scheduler_params.png"))
            save_params(os.path.join(out_dir, "model.npz"),
                        flax_from_state_dict(model.state_dict()))
            mgr.save(step, trainer.state)
            if opt.export_reference_ckpt:
                # the reference's torch state_dict at its path and format
                export_torch_ckpt(model, os.path.join(out_dir, "model.ckpt"))
        barrier()
        if opt.max_steps and step >= opt.max_steps:
            break
    mgr.wait()
    mgr.close()
    if main:
        logger.close()
    return out_dir


def _schedule_params(opt, out_dir):
    if opt.optimize_scheduler_param:
        return np.loadtxt(os.path.join(out_dir, "scheduler_params.txt")).astype(np.float32)
    return np.array([opt.scheduler_param, opt.scheduler_param_s, opt.scheduler_param_e],
                    np.float32)


def _serving(opt, device, cfg, out_dir, sched, calib_inputs, gn_carry):
    """The served models of the test modes: the run folder's weights loaded
    strictly into the serving model (the tiers the flags ask for); with a
    calibrated tier, its constants recorded first on one exact trajectory
    from ``calib_inputs() -> (x_cal, x_c_cal or None)``. Returns ``(model,
    cached)``: the serving model and, with ``--cache_interval``, the
    cached chain's ``(apply_full, apply_shallow)`` (the GN-stats carry's
    when ``gn_carry``), else None."""
    from bndm_tpu_torch.cli.common import load_pixel_unet_params, serving_relax_kw
    from bndm_tpu_torch.ops.int8 import calibrate_sampling
    from bndm_tpu_torch.serving import cached_forwards, carry_models, serving_model_pair

    sd = load_pixel_unet_params(out_dir)
    m_cal, model = serving_model_pair(
        cfg, sd, device=device, int8_static=opt.conv_int8 and opt.int8_mode == "static",
        static_gn=opt.static_gn, gn_steps=opt.nb_steps, relax_kw=serving_relax_kw(opt))
    pair = carry_models(model, sd) if gn_carry else ()
    if m_cal is not None:
        t0 = time.time()
        x_cal, x_c_cal = calib_inputs()
        quant = calibrate_sampling(m_cal, x_cal, x_c=x_c_cal, **sched)
        del m_cal
        for m in (model,) + pair:
            m.load_quant(quant)
        print(f"serving calibration: {time.time() - t0:.1f}s ({len(quant)} calibrated sites)")
    if not (opt.cache_interval and opt.cache_interval > 1):
        return model, None
    if gn_carry:
        return model, cached_forwards(pair, carry="carry")
    return model, cached_forwards(model)


def run_test(opt, device):
    from bndm_tpu_torch.cli.common import (AsyncImageWriter, is_main_process, make_generator,
                                           noise_folder_name, rows_of, save_image_grid,
                                           synchronize)
    from bndm_tpu_torch.parallel.mesh import run_mesh
    from bndm_tpu_torch.samplers.iadb import (sample_iadb, sample_iadb_cached,
                                              sample_iadb_microbatched)

    _check_serving_flags(opt)
    model, tcfg, L, out_dir = build(opt, "meta")
    fname = f"{opt.dataset}_iadb_{noise_folder_name(opt.noise_type)}_steps{opt.nb_steps}"
    for sub in ("images", "seqs", "noise"):
        os.makedirs(os.path.join(out_dir, fname, sub), exist_ok=True)

    sp = _schedule_params(opt, out_dir)
    sched = dict(nb_steps=opt.nb_steps, scheduler_alpha=opt.scheduler_alpha,
                 alpha_param=opt.scheduler_param, scheduler_gamma=opt.scheduler_gamma,
                 gamma_params=tuple(float(v) for v in sp), two_head=tcfg.two_head)
    model, cached = _serving(
        opt, device, model.cfg, out_dir, sched,
        lambda: (torch.randn((min(8, opt.batch_size), 3, opt.res, opt.res),
                             generator=make_generator(device, opt.seed, 777), device=device),
                 None), opt.gn_carry)

    total = opt.test_samples
    nb_batches = -(-total // opt.batch_size)
    times = []
    cnt = 0
    # paper-replicability batch filter: for the published datasets only
    # specific batch indices are sampled
    replicability_batches = {
        "cat_res64": [4], "cat_res128": [52], "celeba_res64": [37],
        "celeba_res128": [10], "church_res64": [4, 23, 32, 36],
    }.get(opt.dataset)

    # each rank denoises its block of every batch that divides across the
    # ranks; rank 0 gathers the blocks and writes
    mesh = run_mesh()
    main = is_main_process()
    # gallery mode writes every sample: encode PNGs on a background thread
    writer = AsyncImageWriter() if opt.save_all_samples and main else None
    wall_t0 = time.time()

    for i in range(nb_batches):
        if replicability_batches is not None and not opt.save_all_samples \
                and i not in replicability_batches:
            continue
        bs = min(opt.batch_size, total - i * opt.batch_size)
        # saved-noise replicability: reuse reference .npz when present
        noise_path = os.path.join(
            "results_gaussianBN",
            f"{opt.dataset}_gaussian_linear_outc3_seed0",
            f"{opt.dataset}_iadb_gwn_steps250", "noise",
            f"noise_batch{opt.batch_size}_idx{i:05d}.npz",
        )
        if os.path.exists(noise_path):
            x0 = torch.from_numpy(np.load(noise_path)["noise"][:bs].astype(np.float32)).to(device)
        else:
            x0 = torch.randn((bs, 3, opt.res, opt.res), generator=make_generator(device, opt.seed, i),
                             device=device, dtype=torch.float32)

        if opt.save_noise and main:
            np.savez_compressed(
                os.path.join(out_dir, fname, "noise", f"noise_batch{bs}_idx{i:05d}.npz"),
                noise=x0.cpu().numpy())

        if replicability_batches is not None and not opt.save_all_samples:
            # the reference slices to ONE sample in replicability mode
            x0 = x0[0:1]
            bs = 1

        x0, gather = rows_of(mesh, x0)
        # a batch above the microbatch runs microbatch by microbatch, never
        # as one batch; a ragged last batch is padded with zero rows (samples
        # are independent) and cut back
        use_mb = opt.microbatch and x0.shape[0] > opt.microbatch
        mb_pad = (-x0.shape[0]) % opt.microbatch if use_mb else 0

        def _run():
            if use_mb:
                xin = torch.cat([x0, x0.new_zeros((mb_pad,) + x0.shape[1:])]) if mb_pad else x0
                s = sample_iadb_microbatched(
                    cached[0] if cached else model, xin, microbatch=opt.microbatch,
                    apply_shallow=cached[1] if cached else None,
                    cache_interval=opt.cache_interval if cached else None, **sched)
                s, f = s[:x0.shape[0]], None
            elif cached:
                s, f = sample_iadb_cached(*cached, x0, cache_interval=opt.cache_interval,
                                          **sched), None
            else:
                s, f = sample_iadb(model, x0, collect_frames=True, **sched)
            synchronize(device)
            return s, f

        t0 = time.time()
        if opt.profile_dir and not times:  # trace the first executed batch
            from bndm_tpu_torch.utils.timing import profile_trace

            with profile_trace(opt.profile_dir):
                sample, frames = _run()
        else:
            sample, frames = _run()
        times.append(time.time() - t0)
        # rank 0's block starts at the batch's row 0: its frames are the batch's
        sample = gather(sample)
        cnt += bs
        if not main:
            continue
        to_save = sample if opt.save_all_samples else sample[:1]
        img_path = os.path.join(out_dir, fname, "images", f"{i:05d}_{{0}}.png")
        if writer is not None:
            writer.submit(to_save, img_path)
        else:
            save_image_grid(to_save, img_path)
        for j, fr in enumerate(frames if frames is not None else ()):
            save_image_grid(fr, os.path.join(
                out_dir, fname, "seqs",
                f"{noise_folder_name(opt.noise_type)}_img{cnt - bs:05d}_step{j}_{{0}}.png"))
        print(f"batch {i}: {bs} samples in {times[-1]:.2f}s "
              f"({bs/times[-1]:.1f} samples/s)")
    if writer is not None:
        t_drain = time.time()
        written = writer.close()
        wall = time.time() - wall_t0
        print(f"gallery: {written} images written "
              f"(final encode drain {time.time() - t_drain:.1f}s)")
        if written:
            print(f"end-to-end gallery throughput incl. I/O: "
                  f"{written / wall:.2f} samples/s over {wall:.1f}s wall")
    if times and main:
        print("mean batch sampling time (excl. first):",
              np.mean(times[1:]) if len(times) > 1 else times[0])
    return out_dir


def run_superres_test(opt, device):
    """Conditional super-res eval: for each test image, condition on the
    bilinear down-x4-up image, initialize x0 with the blue-noise mix (unlike
    the unconditional path, the conditional one DOES blue-initialize), sample,
    report SSIM/PSNR/L2/L1. The serving tiers apply as in :func:`run_test`
    but for ``--gn_carry``, which this mode leaves out as the JAX CLI does
    (with only that CLI's check of ``--static_gn`` here); each request is
    one image, so --microbatch never splits one."""
    from bndm_tpu_torch.cli.common import (is_main_process, make_generator, noise_folder_name,
                                           save_image_grid, synchronize)
    from bndm_tpu_torch.data.imagefolder import ImageFolderDataset
    from bndm_tpu_torch.ops.noise import get_noise
    from bndm_tpu_torch.ops.schedules import gamma_schedule
    from bndm_tpu_torch.samplers.iadb import sample_iadb, sample_iadb_cached
    from bndm_tpu_torch.utils.image import superres_condition
    from bndm_tpu_torch.utils.metrics import psnr, ssim

    if opt.static_gn and opt.scheduler_alpha != "linear":
        raise SystemExit("--static_gn requires the linear alpha schedule")
    if opt.gn_carry:
        print("--gn_carry: not applied in super-res (the unconditional mode carries the "
              "GroupNorm statistics)")
    model, tcfg, L, out_dir = build(opt, "meta")
    L = torch.from_numpy(L).to(device)
    fname = f"{opt.dataset}_iadb_{noise_folder_name(opt.noise_type)}_{opt.conditional_type}_steps{opt.nb_steps}"
    for sub in ("images", "seqs", "lowres", "highres"):
        os.makedirs(os.path.join(out_dir, fname, sub), exist_ok=True)

    sp = _schedule_params(opt, out_dir)
    sched = dict(nb_steps=opt.nb_steps, scheduler_alpha=opt.scheduler_alpha,
                 alpha_param=opt.scheduler_param, scheduler_gamma=opt.scheduler_gamma,
                 gamma_params=tuple(float(v) for v in sp), two_head=tcfg.two_head)

    ds = ImageFolderDataset(os.path.join(opt.data_root, opt.dataset + "_test"), opt.res,
                            random_flip=False)
    # paper indices; fall back to the first ones for small sets
    wanted = [73, 103, 277, 388]
    indices = [i for i in wanted if i < len(ds)] or list(range(min(len(ds), 4)))

    def calib_inputs():
        """White x0 and the conditioning of the first (up to 8) test images."""
        x1 = torch.stack([torch.from_numpy(ds.get(i)) for i in indices[:8]]).to(device) * 2.0 - 1.0
        return (torch.randn(x1.shape, generator=make_generator(device, opt.seed, 777),
                            device=device), superres_condition(x1, downscale=4))

    model, cached = _serving(opt, device, model.cfg, out_dir, sched, calib_inputs, False)

    agg = {"ssim": 0.0, "psnr": 0.0, "l2": 0.0, "l1": 0.0}
    for i in indices:
        x1 = torch.from_numpy(ds.get(i))[None].to(device) * 2.0 - 1.0
        x_c = superres_condition(x1, downscale=4)
        t0 = time.time()
        x0 = torch.randn(x1.shape, generator=make_generator(device, opt.seed, i),
                         device=device, dtype=torch.float32)
        t = torch.full((1,), float(opt.nb_steps))
        g = gamma_schedule(t, opt.nb_steps, opt.scheduler_gamma, sp).to(device)
        # inplace consumes x0 as the white-noise source; 'uniform' always
        # draws fresh and needs its own stream
        x0 = get_noise(x0, L, g, noise_type=opt.noise_type, train=False, inplace=True,
                       generator=make_generator(device, opt.seed, 10_000 + i)).noise
        if cached:
            sample = sample_iadb_cached(*cached, x0, cache_interval=opt.cache_interval,
                                        x_c=x_c, **sched)
        else:
            sample, _ = sample_iadb(model, x0, x_c=x_c, **sched)
        synchronize(device)
        dt = time.time() - t0
        print(f"image {i}: 1 sample in {dt:.2f}s ({1 / dt:.2f} samples/s)")
        s01 = torch.clamp((sample + 1) / 2, 0, 1)
        x01 = (x1 + 1) / 2
        agg["ssim"] += float(ssim(s01, x01)[0])
        agg["psnr"] += float(psnr(s01, x01)[0])
        agg["l2"] += float(torch.sum((sample - x1) ** 2))
        agg["l1"] += float(torch.sum(torch.abs(sample - x1)))
        if not is_main_process():  # one image a request: every rank runs it, rank 0 writes
            continue
        save_image_grid(sample, os.path.join(
            out_dir, fname, "images", f"image_{noise_folder_name(opt.noise_type)}_{i:05d}_{{0}}.png"))
        save_image_grid(x_c, os.path.join(out_dir, fname, "lowres", f"lowres_{i:05d}_{{0}}.png"))
        save_image_grid(x1, os.path.join(out_dir, fname, "highres", f"highres_{i:05d}_{{0}}.png"))
    n = max(len(indices), 1)
    print("conditional metrics: ssim: {:.4f}, psnr: {:.4f}, l2: {:.4f}, l1: {:.4f}".format(
        agg["ssim"] / n, agg["psnr"] / n, agg["l2"] / n, agg["l1"] / n))
    return out_dir


def main(argv=None):
    from bndm_tpu_torch.cli.common import disable_tf32, resolve_device, start_distributed

    opt = parse_args(argv)
    device = start_distributed(opt, resolve_device(opt.device))
    disable_tf32()
    np.random.seed(opt.seed)
    if opt.train_or_test == "train":
        return run_train(opt, device)
    if opt.is_conditional:
        return run_superres_test(opt, device)
    return run_test(opt, device)


if __name__ == "__main__":
    main()
