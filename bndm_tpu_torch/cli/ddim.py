"""DDIM baseline pipeline CLI in PyTorch, flag-compatible with the reference.

Counterpart of ``bndm_tpu/cli/ddim.py``. Train: the DDPM objective
(epsilon/sample prediction) on ImageFolder data with EMA and HF LR
schedules, full-state checkpoints and ``--resume_from_checkpoint``; the
saved weights go to ``unet/model.npz`` (the JAX package's layout) and the
diffusers ``save_pretrained`` tree. Test: 250-step DDIM sampling, with the
reference's saved-noise replicability hook and seqs/images naming, and the
serving tiers (``--conv_int8``/``--int8_mode``, ``--static_gn`` keyed on the
scan position, ``--attn_softmax_dtype``, ``--cache_interval``). It runs on
CUDA unless ``--device=cpu`` is given, and raises when CUDA is missing. The
multi-host flags (``--coordinator_address``, ``--num_processes``,
``--process_id``) run it data parallel, as the pixel CLI does: each rank
trains on its rows of the global batch, or samples its block of each batch,
and rank 0 writes.

Usage mirrors the reference scripts, e.g.:
  python -m bndm_tpu_torch.cli.ddim --dataset_name=cat_res64 --resolution=64 \
      --train_or_test=test --eval_batch_size=500 --test_samples=30000 \
      --output_dir=ddim_cat_res64 ...
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch


def model_config(args):
    from bndm_tpu_torch.models.unet2d import UNet2DConfig, unet_config_for_res

    if args.tiny_model:
        return UNet2DConfig(
            in_channels=3, out_channels=3, block_out_channels=(8, 16),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
            attention_head_dim=4, norm_num_groups=4, dtype=args.compute_dtype,
            conv_int8=args.conv_int8,
        )
    if args.resolution in (64, 128):
        return unet_config_for_res(args.resolution, 3, 3, dtype=args.compute_dtype,
                                   conv_int8=args.conv_int8)
    if args.resolution == 256:
        # the reference's res-256 DDIM config is the 7-block layout
        return unet_config_for_res(128, 3, 3, dtype=args.compute_dtype,
                                   conv_int8=args.conv_int8)
    raise NotImplementedError(f"resolution {args.resolution}")


def out_dir_for(args):
    name = args.output_dir + ("_ema" if args.use_ema else "")
    return os.path.join("results_gaussianBN", name)


def run_train(args, device):
    from bndm_tpu_torch.cli.common import hf_train_loop, save_params
    from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset
    from bndm_tpu_torch.models.convert import (ddim_scheduler_config, export_pipeline_tree,
                                               flax_from_state_dict)
    from bndm_tpu_torch.models.unet2d import UNet2D
    from bndm_tpu_torch.parallel.mesh import data_shard, run_mesh
    from bndm_tpu_torch.train.ddim import DDIMTrainConfig, make_ddim_train_step
    from bndm_tpu_torch.train.schedules_lr import hf_adamw

    out_dir = out_dir_for(args)
    os.makedirs(out_dir, exist_ok=True)
    torch.manual_seed(args.seed)  # the model's random init
    model = UNet2D(model_config(args), device=device)
    # HF train_unconditional crop semantics: CenterCrop only with
    # --center_crop, RandomCrop otherwise
    ds = ImageFolderDataset(os.path.join(args.data_root, args.dataset_name), args.resolution,
                            random_flip=args.random_flip, seed=args.seed,
                            random_crop=not args.center_crop)
    # each rank loads its block of the global batch
    mesh = run_mesh(args.train_batch_size)
    shard_index, shard_count = data_shard(mesh)
    loader = BatchLoader(ds, args.train_batch_size // shard_count, seed=args.seed,
                         num_threads=args.dataloader_num_workers or 8,
                         shard_index=shard_index, shard_count=shard_count)
    steps_total = max(len(loader), 1) * args.num_epochs
    cfg = DDIMTrainConfig(
        ddpm_num_steps=args.ddpm_num_steps, ddpm_beta_schedule=args.ddpm_beta_schedule,
        prediction_type=args.prediction_type, use_ema=args.use_ema,
        ema_inv_gamma=args.ema_inv_gamma, ema_power=args.ema_power,
        ema_max_decay=args.ema_max_decay)
    train_step, init_state = make_ddim_train_step(cfg, hf_adamw(args, steps_total), mesh)
    state = init_state(model.train())

    def save_eval(state):
        # with --use_ema the reference copies the EMA weights into the saved
        # unet/ before save_pretrained, so eval sees them; the raw weights
        # stay in the checkpoints
        sd = state.eval_state_dict()
        save_params(os.path.join(out_dir, "unet", "model.npz"), flax_from_state_dict(sd))
        if state.ema is not None:
            save_params(os.path.join(out_dir, "unet_ema", "model.npz"),
                        flax_from_state_dict(state.ema.params))
        export_pipeline_tree(out_dir, sd, model.cfg, args.resolution,
                             ddim_scheduler_config(args.ddpm_num_steps, args.ddpm_beta_schedule,
                                                   args.prediction_type),
                             pipeline_class="DDIMPipeline")

    hf_train_loop(args, state, train_step, loader.epoch, out_dir, save_eval, device=device,
                  steps_per_epoch=max(len(loader), 1), loss_fmt=".5f", mesh=mesh)
    return out_dir


def load_scheduler(args, out_dir):
    """The run's DDIMScheduler: the tree's scheduler_config.json when
    present (from_pretrained semantics: it wins over the flags)."""
    from bndm_tpu_torch.samplers.ddim import DDIMScheduler

    path = os.path.join(out_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return DDIMScheduler.from_config(json.load(f))
    return DDIMScheduler(num_train_timesteps=args.ddpm_num_steps,
                         beta_schedule=args.ddpm_beta_schedule,
                         prediction_type=args.prediction_type)


def run_test(args, device):
    from bndm_tpu_torch.cli.common import (is_main_process, load_tree_unet_params,
                                           make_generator, rows_of, save_image_grid,
                                           serving_relax_kw, synchronize)
    from bndm_tpu_torch.parallel.mesh import run_mesh
    from bndm_tpu_torch.serving import make_serving_sampler_ddim

    out_dir = out_dir_for(args)
    for sub in ("images", "seqs"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    # from_pretrained semantics: the tree's config.json wins over the flags
    sd, tree_cfg = load_tree_unet_params(out_dir)
    if tree_cfg is not None and not args.tiny_model:
        cfg = dataclasses.replace(tree_cfg, dtype=args.compute_dtype, conv_int8=args.conv_int8)
    else:
        cfg = model_config(args)
    if args.cache_interval and args.cache_depth != 1:
        cfg = dataclasses.replace(cfg, cache_depth=args.cache_depth)
    scheduler = load_scheduler(args, out_dir)

    # the serving tiers: a calibrated tier first runs one exact small-batch
    # DDIM trajectory (int8 activation scales and/or per-(site, step)
    # GroupNorm statistics, keyed on the scan position); --cache_interval
    # serves the feature-reuse chain, which keeps no seqs/ frames
    sample = make_serving_sampler_ddim(
        cfg, sd, scheduler, args.ddpm_num_inference_steps, device=device,
        conv_int8=args.conv_int8, int8_mode=args.int8_mode, static_gn=args.static_gn,
        calib_batch=8, generator=make_generator(device, args.seed, 777),
        relax_kw=serving_relax_kw(args), cache_interval=args.cache_interval, verbose=True)
    sample.calibrate((args.eval_batch_size, 3, args.resolution, args.resolution))

    num_batch = max(args.test_samples // args.eval_batch_size, 1)
    cnt = 0
    times = []
    # each rank samples its block of every batch that divides; rank 0 writes
    mesh = run_mesh()
    main = is_main_process()
    # paper-replicability batch filter
    replicability_batches = {
        "cat_res64": [4], "cat_res128": [0, 52], "celeba_res64": [37],
        "celeba_res128": [10, 26], "church_res64": [4, 23, 32, 36],
    }.get(args.dataset_name)
    for i in range(num_batch):
        if replicability_batches is not None and i not in replicability_batches:
            continue
        # saved-noise replicability hook
        noise_path = os.path.join(
            "results_gaussianBN", f"{args.dataset_name}_gaussian_linear_outc3_seed0",
            f"{args.dataset_name}_iadb_gwn_steps250", "noise",
            f"noise_batch{args.eval_batch_size}_idx{i:05d}.npz")
        if os.path.exists(noise_path):
            # "replicability, only one sample"
            x0 = torch.from_numpy(np.load(noise_path)["noise"][0:1].astype(np.float32)).to(device)
        else:
            x0 = torch.randn((args.eval_batch_size, 3, args.resolution, args.resolution),
                             generator=make_generator(device, args.seed, i), device=device)
        bs = x0.shape[0]
        x0, gather = rows_of(mesh, x0)

        def _run():
            if args.cache_interval:
                out, frames = sample(x0), None
            else:
                out, frames = sample(x0, collect_frames=True)
            synchronize(device)
            return out, frames

        t0 = time.time()
        if args.profile_dir and not times:  # trace the first executed batch
            from bndm_tpu_torch.utils.timing import profile_trace

            with profile_trace(args.profile_dir):
                out, frames = _run()
        else:
            out, frames = _run()
        times.append(time.time() - t0)
        out = gather(out)  # rank 0's frames are the batch's: its block starts at row 0
        cnt += bs
        if not main:
            continue
        save_image_grid(out, os.path.join(out_dir, "images", f"ddim_img{cnt - bs:05d}_{{0}}.png"))
        for j, fr in enumerate(frames if frames is not None else ()):
            save_image_grid(fr, os.path.join(out_dir, "seqs",
                                             f"ddim_img{cnt - bs:05d}_step{j * 25}_{{0}}.png"))
        print(f"batch {i}: {bs} samples in {times[-1]:.2f}s "
              f"({bs / times[-1]:.2f} samples/s)")
    return out_dir


def main(argv=None):
    from bndm_tpu_torch.cli.common import disable_tf32, resolve_device, start_distributed
    from bndm_tpu_torch.cli.hf_args import parse_args

    args = parse_args(argv)
    device = start_distributed(args, resolve_device(args.device))
    disable_tf32()
    np.random.seed(args.seed)
    if args.train_or_test == "train":
        return run_train(args, device)
    return run_test(args, device)


if __name__ == "__main__":
    main()
