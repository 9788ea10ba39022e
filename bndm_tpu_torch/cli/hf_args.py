"""HF-train_unconditional-style argparse surface (shared by the DDIM and
latent CLIs), and the argument types the CLIs share.

Counterpart of ``bndm_tpu/cli/hf_args.py``: the diffusers
train_unconditional superset plus the BNDM flags, every flag of the JAX
parser, plus the port's ``--device`` (default ``cuda``). The hub flags are
accepted for compatibility; the multi-host ones (``--coordinator_address``,
``--num_processes``, ``--process_id``) start a data-parallel run
(``cli/common.py::start_distributed``).
"""

from __future__ import annotations

import argparse


def cache_interval_type(value):
    """argparse type for --cache_interval: caching needs >= 2 (1 is the
    plain sampler, 0/negative are meaningless) — reject instead of silently
    sampling uncached."""
    iv = int(value)
    if iv < 2:
        raise argparse.ArgumentTypeError(
            f"--cache_interval must be >= 2 (got {iv}); omit the flag for "
            "uncached sampling")
    return iv


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--model_config_name_or_path", type=str, default=None)
    p.add_argument("--train_data_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="ddpm-model-64")
    p.add_argument("--overwrite_output_dir", action="store_true")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--center_crop", default=False, action="store_true")
    p.add_argument("--random_flip", default=False, action="store_true")
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--eval_batch_size", type=int, default=2)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--save_images_epochs", type=int, default=1000)
    p.add_argument("--save_model_epochs", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="cosine")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--adam_beta1", type=float, default=0.95)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-6)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_inv_gamma", type=float, default=1.0)
    p.add_argument("--ema_power", type=float, default=0.75)
    p.add_argument("--ema_max_decay", type=float, default=0.9999)
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--hub_private_repo", action="store_true")
    p.add_argument("--logger", type=str, default="tensorboard")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--local_rank", type=int, default=-1)
    # default None = unset; resolve_args maps it onto compute_dtype
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--prediction_type", type=str, default="epsilon",
                   choices=["epsilon", "sample"])
    p.add_argument("--ddpm_num_steps", type=int, default=1000)
    p.add_argument("--ddpm_num_inference_steps", type=int, default=250)
    p.add_argument("--ddpm_beta_schedule", type=str, default="linear")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    # BNDM flags
    p.add_argument("--train_or_test", type=str, default="train")
    p.add_argument("--test_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_type", type=str, default="gaussian")
    p.add_argument("--out_channels", type=int, default=3)
    p.add_argument("--use_vae", action="store_true")
    p.add_argument("--optimize_scheduler_param", action="store_true")
    p.add_argument("--scheduler_gamma", type=str, default="linear")
    p.add_argument("--scheduler_param", type=float, default=0.02)
    p.add_argument("--scheduler_param_s", type=float, default=0)
    p.add_argument("--scheduler_param_e", type=float, default=3)
    # the JAX package's extensions
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--bluenoise_dir", type=str, default="bluenoise")
    # default None = unset; resolve_args picks bfloat16 unless
    # --mixed_precision dictates otherwise
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--tiny_model", action="store_true")
    p.add_argument("--conv_int8", action="store_true",
                   help="W8A8 UNet convs (ops/int8.py)")
    p.add_argument("--int8_mode", type=str, default="static",
                   choices=["dynamic", "static"],
                   help="with --conv_int8 at test time: 'static' (default) "
                        "calibrates constant activation scales first — the "
                        "latent CLI on an IADB trajectory, the DDIM baseline "
                        "on a DDIM trajectory; training uses dynamic (QAT)")
    p.add_argument("--static_gn", action="store_true",
                   help="serving: static-calibrated GroupNorm statistics "
                        "(per-site, per-step; ops/static_norm.py). The "
                        "latent CLI indexes the tables by the linear alpha; "
                        "the DDIM baseline keys them on the sampler's scan "
                        "position")
    p.add_argument("--attn_softmax_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="serving: attention softmax dtype (fp32 = diffusers "
                        "parity)")
    p.add_argument("--cache_interval", type=cache_interval_type, default=None,
                   help="serving (test only): feature-reuse (block-caching) "
                        "tier — every Nth step runs the full UNet, the steps "
                        "between recompute only the outer --cache_depth "
                        "shell around the cached trunk output. Latent IADB "
                        "and DDIM (sample_ddim_cached); DDIM skips seqs/ "
                        "frames in this mode")
    p.add_argument("--cache_depth", type=int, default=1,
                   help="with --cache_interval: outer down/up blocks a "
                        "cached step recomputes")
    p.add_argument("--vae_params", type=str, default=None,
                   help="path to AutoencoderKL weights (.npz in the JAX "
                        "package's layout, or a diffusers .safetensors / "
                        "torch .ckpt/.pt/.bin state_dict); random-init if absent")
    p.add_argument("--decode_microbatch", type=int, default=16,
                   help="VAE-decode the sampled latents in chunks of this "
                        "size: the full-batch 512^2 decode holds (B, 256, "
                        "512, 512) temporaries (models/vae.py::make_decoder). "
                        "Decoding is per sample; 0 = full batch")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the first "
                        "sampled batch into this folder")
    # multi-process launch (data parallelism, cli/common.py::start_distributed)
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (multi-host training)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p


def resolve_args(args):
    """Honor (or loudly reject) reference-compat flags:

    * ``--mixed_precision``: mapped onto ``compute_dtype``: fp16 maps to
      bfloat16 (the JAX package's mapping, kept so that both packages run
      the same arithmetic from the same flags), 'no' means full fp32 like
      the reference default. An explicit ``--compute_dtype`` wins.
    * ``--logger``: tensorboard is native (utils/logging.py); anything else
      gets a visible warning and the tensorboard/JSONL logger.
    """
    if args.compute_dtype is None:
        if args.mixed_precision == "no":
            args.compute_dtype = "float32"
            print("--mixed_precision=no: running full fp32 "
                  "(pass --compute_dtype=bfloat16 for the fast path)")
        elif args.mixed_precision in ("fp16", "bf16"):
            args.compute_dtype = "bfloat16"
            if args.mixed_precision == "fp16":
                print("--mixed_precision=fp16: using bfloat16 (same-exponent "
                      "mixed precision, as the JAX package does)")
        else:
            args.compute_dtype = "bfloat16"
    elif args.mixed_precision is not None:
        print(f"--compute_dtype={args.compute_dtype} overrides "
              f"--mixed_precision={args.mixed_precision}")
    if args.logger not in (None, "tensorboard"):
        print(f"WARNING: --logger={args.logger} is not available in this "
              "environment; logging to tensorboard + JSONL instead")
    return args


def parse_args(argv=None):
    return resolve_args(build_parser().parse_args(argv))

