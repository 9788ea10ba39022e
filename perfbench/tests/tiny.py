"""Tiny stand-ins for the cells' configuration and traffic files, for runs
of the harness on the CPU: the published layouts' block kinds at widths 8
and 16, float32 compute, a few steps, samples and images."""

from __future__ import annotations

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_UNET = {"block_out_channels": [8, 16], "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
             "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "attention_head_dim": 4,
             "norm_num_groups": 4}
TINY_VAE = {"block_out_channels": [8, 8, 16, 16], "layers_per_block": 1, "norm_num_groups": 4}


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def tiny(workload):
    """(config, traffic) of ``workload`` cut to a CPU test's size."""
    bench = _load("BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    conf_file = {c["name"]: c for c in bench["configs"]}[cell["config"]]["file"]
    config = copy.deepcopy(_load(conf_file))
    traffic = _load("perfbench", "traffic", workload + ".json")
    config["unet"].update(TINY_UNET)
    port = config["port"]
    res = port.pop("unet_config_for_res")
    port["unet_config"] = dict(TINY_UNET, in_channels=res["in_channels"],
                               out_channels=res["out_channels"], dtype="float32")
    if "vae" in config:
        config["vae"].update(TINY_VAE)
        port["vae_config"] = dict(TINY_VAE, dtype="float32")
    traffic.update(batch_size=4, checked_steps=3, warmup_steps=1, trace_steps=1)
    if traffic["driver"] == "train_pixel":
        traffic.update(images=16, loader_threads=2)
    if traffic["driver"] == "train_latent":
        traffic.update(latents=16)
    if traffic["driver"] in ("sample_latent", "sample_latent_cached"):
        traffic.update(steps=12, x0_batches=2, checked_steps=3, checked_batches=2,
                       reference_rows=2, decode_microbatch=2, warmup_forwards=1)
        config["unet"]["sample_size"] = 8
    return config, traffic
