"""Argument types shared by the CLIs.

Counterpart of ``bndm_tpu/cli/hf_args.py``; the serving slice needs only
``cache_interval_type`` (the HF-style DDIM flag surface comes with the DDIM
pipeline, ROADMAP.md queue 1 item 10).
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
