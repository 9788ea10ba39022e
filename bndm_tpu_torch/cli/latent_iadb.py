"""Latent IADB/BNDM pipeline CLI in PyTorch, flag-compatible with the
reference.

Counterpart of ``bndm_tpu/cli/latent_iadb.py``: VAE-encode the 512^2/256^2
images once into the latent cache (x2 through hflip), train the latent UNet
with the linear alpha = gamma IADB objective (on CUDA the noise draw
launches K1 at 256^2 pixels and K2 at 512^2), sample with the IADB chain
(plain, or the serving tiers: ``--conv_int8``/``--int8_mode``,
``--static_gn``, ``--attn_softmax_dtype``, ``--cache_interval``) and
VAE-decode in chunks of ``--decode_microbatch``. ``--backbone DiT-XL/2``
trains and samples a DiT (``models/dit.py``) in the UNet's place, through
the same train step, loop, checkpoints and plain chain; the UNet's serving
tiers refuse to run with it. It runs on CUDA unless
``--device=cpu`` is given, and raises when CUDA is missing. The multi-host
flags run it data parallel (each rank trains on its rows of the global
batch, or samples and decodes its block of each batch; rank 0 writes and
builds the latent cache). The VAE is random-init unless
``--vae_params`` names converted weights (the published ``sd-vae-ft-mse``
weights are a download, not in the repository).

Usage mirrors the reference scripts, e.g.:
  python -m bndm_tpu_torch.cli.latent_iadb --dataset_name=cat_res512 \
      --resolution=512 --random_flip --output_dir=latent_iadb_cat_res512 \
      --train_batch_size=256 --learning_rate=1e-4 --out_channels=4 \
      --num_epochs=1000 --noise_type=gaussianBN
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch


def latent_unet_config(args, out_channels):
    from bndm_tpu_torch.models.unet2d import UNet2DConfig, unet_config_for_res

    if args.tiny_model:
        return UNet2DConfig(
            in_channels=4, out_channels=out_channels, block_out_channels=(8, 16),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
            attention_head_dim=4, norm_num_groups=4, dtype=args.compute_dtype,
            conv_int8=args.conv_int8,
        )
    # the reference keys the config on the PIXEL resolution
    layout = {64: 64, 512: 64, 128: 128, 256: "latent32"}.get(args.resolution)
    if layout is None:
        raise NotImplementedError(f"resolution {args.resolution}")
    return unet_config_for_res(layout, 4, out_channels, dtype=args.compute_dtype,
                               conv_int8=args.conv_int8)


BACKBONES = ("unet", "DiT-XL/2")
# the UNet's serving tiers, by flag: (argument, its value when off)
UNET_ONLY = {"--cache_interval": ("cache_interval", None), "--cache_depth": ("cache_depth", 1),
             "--conv_int8": ("conv_int8", False), "--static_gn": ("static_gn", False),
             "--attn_softmax_dtype": ("attn_softmax_dtype", "float32")}


def latent_dit_config(args, out_channels):
    """The DiT of ``--backbone`` (the tiny one under ``--tiny_model``) on the
    latents of ``--resolution``; ``out_channels`` twice the latent's gives
    DiT's ``learn_sigma`` outputs, BNDM's two heads."""
    from bndm_tpu_torch.models.dit import dit_config

    if out_channels not in (4, 8):
        raise ValueError(f"the DiT predicts 4 or 8 channels, not {out_channels}")
    return dit_config("tiny" if args.tiny_model else args.backbone,
                      input_size=args.resolution // 8, learn_sigma=out_channels == 8,
                      dtype=args.compute_dtype)


def refuse_unet_flags(args):
    """Exit naming the first UNet-only serving flag set with a DiT
    backbone."""
    if args.backbone == "unet":
        return
    for flag, (name, off) in UNET_ONLY.items():
        if getattr(args, name) != off:
            raise SystemExit(f"{flag} is a serving tier of the UNet; the {args.backbone} "
                             "backbone samples with the plain chain only")


def out_dir_for(args):
    name = args.output_dir + f"_{args.noise_type}" + ("_ema" if args.use_ema else "")
    return os.path.join("results_gaussianBN", name)


def head_channels(args):
    """The UNet's output channels: doubled for the two-head BN/RN models."""
    if args.noise_type in ("gaussianBN", "gaussianRN"):
        return 2 * args.out_channels
    return args.out_channels


def get_vae(args, device):
    """The AutoencoderKL on ``device``, in eval mode: ``--vae_params``
    loaded strictly when given, else random-init from seed 0 (on the CPU,
    so that every device gets the same weights)."""
    from bndm_tpu_torch.cli.common import load_params
    from bndm_tpu_torch.models.convert import load_state_dict_file, state_dict_from_flax
    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    if args.tiny_model:
        # still /8 like the SD VAE (4 blocks, 3 downsamples), but tiny
        vcfg = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                         norm_num_groups=4, dtype=args.compute_dtype)
    else:
        vcfg = VAEConfig(dtype=args.compute_dtype)
    torch.manual_seed(0)
    vae = AutoencoderKL(vcfg, device="cpu")
    if args.vae_params and os.path.exists(args.vae_params):
        if args.vae_params.endswith((".safetensors", ".ckpt", ".pt", ".bin")):
            sd = load_state_dict_file(args.vae_params)
        else:
            sd = state_dict_from_flax(load_params(args.vae_params))
        vae.load_state_dict(sd, strict=True)
    else:
        print("WARNING: no --vae_params given; using random-init VAE "
              "(fine for smoke tests, not for real latents)")
    return vae.to(device).eval()


@torch.no_grad()
def build_latent_cache(args, vae, device):
    """VAE-encode the ImageFolder once (x2 hflip) into the latent cache: one
    encode per image and flip, a posterior sample from a generator of
    (seed, 2 * i + f)."""
    from bndm_tpu_torch.cli.common import make_generator
    from bndm_tpu_torch.data.imagefolder import ImageFolderDataset
    from bndm_tpu_torch.data.latent_cache import LatentCacheWriter

    cache_path = os.path.join(args.data_root, f"{args.dataset_name}_latent_cache")
    if os.path.exists(os.path.join(cache_path, "meta.json")):
        return cache_path
    ds = ImageFolderDataset(os.path.join(args.data_root, args.dataset_name), args.resolution,
                            random_flip=False)
    lat_res = args.resolution // 8
    writer = LatentCacheWriter(cache_path, (4, lat_res, lat_res))
    for i in range(len(ds)):
        img = torch.from_numpy(ds.get(i))[None].to(device) * 2.0 - 1.0
        for f in range(2):  # original + hflip
            x = img if f == 0 else torch.flip(img, dims=(-1,))
            z = vae.encode(x, generator=make_generator(device, args.seed, i * 2 + f))
            writer.add(z[0].cpu().numpy().astype(np.float16))
    n = writer.finalize()
    print(f"latent cache built: {n} latents at {cache_path}")
    return cache_path


def run_train(args, device):
    from bndm_tpu_torch.cli.common import hf_train_loop, load_L_for, save_params
    from bndm_tpu_torch.data.latent_cache import LatentCacheDataset
    from bndm_tpu_torch.models.convert import (export_pipeline_tree, flax_from_state_dict,
                                               iadb_scheduler_config)
    from bndm_tpu_torch.cli.common import is_main_process
    from bndm_tpu_torch.models import dit
    from bndm_tpu_torch.models.unet2d import UNet2D
    from bndm_tpu_torch.parallel.distributed import barrier
    from bndm_tpu_torch.parallel.mesh import data_shard, run_mesh
    from bndm_tpu_torch.train.latent import LatentTrainConfig, make_latent_train_step
    from bndm_tpu_torch.train.schedules_lr import hf_adamw

    out_dir = out_dir_for(args)
    os.makedirs(out_dir, exist_ok=True)
    out_channels = head_channels(args)
    vae = get_vae(args, device)
    if is_main_process():  # rank 0 builds the cache; the others find it built
        build_latent_cache(args, vae, device)
    barrier()
    ds = LatentCacheDataset(build_latent_cache(args, vae, device))
    del vae  # training reads the cache only
    mesh = run_mesh(args.train_batch_size)
    shard_index, shard_count = data_shard(mesh)
    torch.manual_seed(args.seed)  # the model's random init
    if args.backbone == "unet":
        model = UNet2D(latent_unet_config(args, out_channels), device=device)
    else:
        model = dit.DiT(latent_dit_config(args, out_channels), device=device)
    L = torch.from_numpy(load_L_for(args.noise_type, args.bluenoise_dir)).to(device)
    nb = max(len(ds) // args.train_batch_size, 1)
    cfg = LatentTrainConfig(
        ddpm_num_steps=args.ddpm_num_steps, noise_type=args.noise_type,
        out_channels=out_channels, use_ema=args.use_ema, ema_inv_gamma=args.ema_inv_gamma,
        ema_power=args.ema_power, ema_max_decay=args.ema_max_decay)
    train_step, init_state = make_latent_train_step(cfg, L, hf_adamw(args, nb * args.num_epochs),
                                                    mesh)
    state = init_state(model.train())
    lat_res = args.resolution // 8

    def save_eval(state):
        # the reference copies the EMA weights into the saved unet/
        sd = state.eval_state_dict()
        if args.backbone != "unet":
            dit.save_tree(out_dir, sd, model.cfg)
            return
        save_params(os.path.join(out_dir, "unet", "model.npz"), flax_from_state_dict(sd))
        if state.ema is not None:
            save_params(os.path.join(out_dir, "unet_ema", "model.npz"),
                        flax_from_state_dict(state.ema.params))
        export_pipeline_tree(out_dir, sd, model.cfg, lat_res,
                             iadb_scheduler_config(args.ddpm_num_steps),
                             pipeline_class="IADBPipeline")

    hf_train_loop(args, state, train_step,
                  lambda epoch: ds.batches(args.train_batch_size // shard_count,
                                           seed=(args.seed, epoch), shard_index=shard_index,
                                           shard_count=shard_count),
                  out_dir, save_eval, device=device, steps_per_epoch=nb, loss_fmt=".2f",
                  mesh=mesh)
    return out_dir


def run_test(args, device):
    from bndm_tpu_torch.cli.common import (is_main_process, load_tree_unet_params, rows_of,
                                           save_image_grid, serving_relax_kw, synchronize)
    from bndm_tpu_torch.models import dit
    from bndm_tpu_torch.models.vae import make_decoder
    from bndm_tpu_torch.parallel.mesh import run_mesh
    from bndm_tpu_torch.ops.int8 import calibrate_sampling
    from bndm_tpu_torch.samplers.iadb import sample_iadb, sample_iadb_cached
    from bndm_tpu_torch.serving import cached_forwards, serving_model_pair

    out_dir = out_dir_for(args)
    for sub in ("images", "seqs"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    if args.backbone == "unet":
        # from_pretrained semantics: a published tree's config wins over the flags
        sd, tree_cfg = load_tree_unet_params(out_dir)
        if tree_cfg is not None and not args.tiny_model:
            cfg = dataclasses.replace(tree_cfg, dtype=args.compute_dtype,
                                      conv_int8=args.conv_int8)
        else:
            cfg = latent_unet_config(args, head_channels(args))
        if args.cache_depth != 1:
            cfg = dataclasses.replace(cfg, cache_depth=args.cache_depth)
    else:  # the run's own tree: its config wins over the flags
        sd, cfg = dit.load_tree(out_dir)
        cfg = dataclasses.replace(cfg, dtype=args.compute_dtype)
    out_channels = cfg.out_channels
    two_head = args.noise_type in ("gaussianBN", "gaussianRN") and out_channels == 8
    decode = make_decoder(get_vae(args, device), args.decode_microbatch)
    lat_res = args.resolution // 8

    # the serving tiers, as in the pixel CLI: calibrated on one exact small
    # trajectory of the linear alpha = gamma sampler
    m_cal, model = serving_model_pair(
        cfg, sd, device=device, int8_static=args.conv_int8 and args.int8_mode == "static",
        static_gn=args.static_gn, gn_steps=args.ddpm_num_inference_steps,
        relax_kw=serving_relax_kw(args))
    if m_cal is not None:
        # a generator of its own: the global numpy stream draws the
        # sampling noise, which must not shift with the tier
        cal_rng = np.random.default_rng(args.seed + 777)
        x_cal = torch.from_numpy(cal_rng.standard_normal(
            (min(4, args.eval_batch_size), 4, lat_res, lat_res)).astype(np.float32)).to(device)
        t0 = time.time()
        quant = calibrate_sampling(m_cal, x_cal, args.ddpm_num_inference_steps,
                                   two_head=two_head)
        del m_cal
        model.load_quant(quant)
        print(f"serving calibration: {time.time() - t0:.1f}s ({len(quant)} calibrated sites)")
    cached = cached_forwards(model) if args.cache_interval else None

    save_name = {"gaussian": "iadb_gwn", "gaussianBN": "iadb_gwn2gbn",
                 "gaussianRN": "iadb_gwn2grn"}[args.noise_type]
    num_batch = max(args.test_samples // args.eval_batch_size, 1)
    cnt = 0
    # each rank samples and decodes its block of every batch that divides;
    # rank 0 writes
    mesh = run_mesh()
    main = is_main_process()
    for i in range(num_batch):
        # the global numpy stream (seeded by main), as the JAX CLI draws it
        noise = np.random.randn(args.eval_batch_size, 4, lat_res, lat_res).astype(np.float32)
        if args.test_samples >= 100:  # the figure-9 noise indices
            if i == 0:
                noise = noise[[2, 7, 31, 48]]
            elif i == 1:
                noise = noise[[6]]
            else:
                continue
        x0 = torch.from_numpy(noise).to(device)
        bs = x0.shape[0]
        x0, gather = rows_of(mesh, x0)

        def _run():
            if cached:
                z = sample_iadb_cached(*cached, x0, nb_steps=args.ddpm_num_inference_steps,
                                       cache_interval=args.cache_interval, two_head=two_head)
            else:
                z, _ = sample_iadb(model, x0, nb_steps=args.ddpm_num_inference_steps,
                                   two_head=two_head)
            imgs = decode(z)
            synchronize(device)
            return imgs

        t0 = time.time()
        if args.profile_dir and cnt == 0:  # trace the first executed batch
            from bndm_tpu_torch.utils.timing import profile_trace

            with profile_trace(args.profile_dir):
                imgs = _run()
        else:
            imgs = _run()
        dt = time.time() - t0
        imgs = gather(imgs)
        cnt += bs
        if not main:
            continue
        print(f"batch {i}: {bs} samples in {dt:.2f}s ({bs / dt:.2f} samples/s)")
        save_image_grid(imgs, os.path.join(out_dir, "images",
                                           f"{save_name}_{cnt - bs:05d}_{{0}}.png"))
    print("Done.")
    return out_dir


def build_parser():
    """The HF flag surface (``cli/hf_args.py``) and ``--backbone``."""
    from bndm_tpu_torch.cli.hf_args import build_parser as hf_parser

    p = hf_parser()
    p.add_argument("--backbone", type=str, default="unet", choices=BACKBONES,
                   help="the denoiser: the latent UNet (default), or DiT-XL/2 (Peebles & "
                        "Xie; --tiny_model gives a 2-block DiT) on the same train step, "
                        "checkpoints and plain IADB chain. The DiT refuses the UNet's "
                        "serving tiers: --cache_interval, --cache_depth, --conv_int8 "
                        "(int8-static with it), --static_gn, --attn_softmax_dtype")
    return p


def main(argv=None):
    from bndm_tpu_torch.cli.common import disable_tf32, resolve_device, start_distributed
    from bndm_tpu_torch.cli.hf_args import resolve_args

    args = resolve_args(build_parser().parse_args(argv))
    refuse_unet_flags(args)
    device = start_distributed(args, resolve_device(args.device))
    disable_tf32()
    np.random.seed(args.seed)
    if args.train_or_test == "train":
        return run_train(args, device)
    return run_test(args, device)


if __name__ == "__main__":
    main()
