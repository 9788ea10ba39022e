"""Checkpoint-parity harness in PyTorch: run converted reference weights end
to end.

Counterpart of ``bndm_tpu/cli/parity_check.py``. Given the reference's
published weights (``results_gaussianBN/<run>/model.ckpt`` or a
``.safetensors`` state dict) and optionally its saved initial noise, it

  1. loads the weights strictly into the port's UNet
     (``models/convert.py::load_reference_unet``);
  2. runs one forward on a fixed linspace probe and prints the same
     statistics line as the JAX harness, to hold the two side by side;
  3. samples from the saved noise (or seeded white noise) and writes the
     image, to compare with the reference's for that noise.

fp32 by default: parity first. It runs on CUDA unless ``--device=cpu``.

  python -m bndm_tpu_torch.cli.parity_check --ckpt results_gaussianBN/<run>/model.ckpt \\
      --res 64 --out_channel 6 --noise_type gaussianBN --scheduler_gamma sigmoid \\
      --scheduler_param 1000
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, required=True,
                   help=".ckpt / .safetensors reference checkpoint")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--out_channel", type=int, default=6)
    p.add_argument("--in_channel", type=int, default=3)
    p.add_argument("--noise_type", type=str, default="gaussianBN")
    p.add_argument("--scheduler_gamma", type=str, default="sigmoid")
    p.add_argument("--scheduler_param", type=float, default=1000.0)
    p.add_argument("--scheduler_param_s", type=float, default=0.0)
    p.add_argument("--scheduler_param_e", type=float, default=3.0)
    p.add_argument("--nb_steps", type=int, default=250)
    p.add_argument("--saved_noise", type=str, default=None,
                   help="reference noise_batch*.npz for bit-identical x0")
    p.add_argument("--output", type=str, default="parity_sample.png")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="fp32 by default: parity first, speed second")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p.parse_args(argv)


def probe_stats(d):
    """The statistics the probe line prints: (mean, std, head-0 mean,
    head-1 mean or nan) of the forward's output, in float64."""
    d = d.detach().double().cpu().numpy()
    head1 = d[:, 3:].mean() if d.shape[1] > 3 else float("nan")
    return float(d.mean()), float(d.std()), float(d[:, :3].mean()), float(head1)


def main(argv=None):
    from bndm_tpu_torch.cli.common import (disable_tf32, make_generator, resolve_device,
                                           save_image_grid, synchronize)
    from bndm_tpu_torch.models import unet2d
    from bndm_tpu_torch.models.convert import load_reference_unet
    from bndm_tpu_torch.samplers.iadb import sample_iadb
    from bndm_tpu_torch.serving import build_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    sd = load_reference_unet(args.ckpt)
    print(f"converted {len(sd)} arrays from {args.ckpt}")

    cfg = unet2d.unet_config_for_res(args.res, args.in_channel, args.out_channel,
                                     dtype=args.compute_dtype)
    model = build_model(cfg, sd, device)

    # 1. the fixed-probe forward: a deterministic input, stats per head
    probe = torch.from_numpy(
        np.linspace(-1, 1, args.in_channel * args.res * args.res, dtype=np.float32)
        .reshape(1, args.in_channel, args.res, args.res)).to(device)
    with torch.no_grad():
        d = model(probe, torch.tensor([0.5], device=device))
    stats = probe_stats(d)
    print("probe forward: shape", tuple(d.shape),
          "mean %.6f std %.6f head0 mean %.6f head1 mean %.6f" % stats)

    # 2. a sample from the reference's saved noise, else seeded white noise
    if args.saved_noise and os.path.exists(args.saved_noise):
        x0 = torch.from_numpy(np.load(args.saved_noise)["noise"][:1].astype(np.float32))
        x0 = x0.to(device)
        print(f"using saved reference noise {args.saved_noise}")
    else:
        x0 = torch.randn((1, args.in_channel, args.res, args.res),
                         generator=make_generator(device, args.seed), device=device)
        print(f"no saved noise given; using white noise of seed {args.seed} "
              "(statistics-level comparison only)")
    sp = (args.scheduler_param, args.scheduler_param_s, args.scheduler_param_e)
    two_head = args.noise_type in ("gaussianBN", "gaussianRN") and args.out_channel == 6
    sample, _ = sample_iadb(model, x0, nb_steps=args.nb_steps,
                            scheduler_gamma=args.scheduler_gamma, gamma_params=sp,
                            two_head=two_head)
    synchronize(device)
    save_image_grid(sample, args.output.replace(".png", "_{0}.png"))
    print("sample written; compare against the reference's image for this noise")
    return {"probe": stats, "sample": sample}


if __name__ == "__main__":
    main()
