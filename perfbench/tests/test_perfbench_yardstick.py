"""The benchmark's fixed arithmetic: FLOP counts from the reference's
modules, the blue-noise kernels' bytes and operations, the roofline, the
union of kernel intervals and its gaps."""

import json
import os

import pytest

from perfbench import flops, yardstick
from perfbench.tests.tiny import ROOT


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_flop_counts_at_batch_one():
    pixel, latent = _config("cat64_bndm"), _config("celeba256_latent")
    assert round(flops.unet_forward(pixel["unet"], 1, 64) / 1e9, 2) == 31.06
    four_out = dict(latent["unet"], out_channels=4)
    assert round(flops.unet_forward(four_out, 1, 32) / 1e9, 2) == 11.53
    assert round(flops.vae_decode(latent["vae"], 1, 32) / 1e9, 2) == 622.19


def test_flop_counts_scale_with_batch():
    latent = _config("celeba256_latent")
    one = flops.unet_forward(latent["unet"], 1, 32)
    assert flops.unet_forward(latent["unet"], 50, 32) == 50 * one


@pytest.mark.parametrize("m", [192, 1024])
def test_kernel_bytes_and_operations(m):
    n = 4096
    tri = n * (n + 1) // 2
    assert yardstick.k1_bytes(n, m) == 4 * (tri + 2 * n * m)
    assert yardstick.k2_bytes(n, m) == 4 * (tri + m + 3 * n * m)
    assert yardstick.tri_product_flops(n, m) == n * (n + 1) * m


def test_kernel_bounds_at_the_cells_shapes():
    # K2 at M = 192 (batch 64 x 3 channels): bound by its 43 MB of bytes
    secs, by = yardstick.kernel_bound_s("k2", 4096, 192)
    assert by == "bytes" and yardstick.k2_bytes(4096, 192) == 43_000_576
    assert abs(secs * 1e3 - 0.012836) < 1e-5
    # K1 at M = 1024 (batch 256 x 4 channels): bound by its operations at TF32
    secs, by = yardstick.kernel_bound_s("k1", 4096, 1024)
    assert by == "operations" and abs(secs * 1e3 - 0.034715) < 1e-5


def test_busy_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert yardstick.busy(iv) == 4.0
    assert yardstick.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert yardstick.gaps(iv, -1.0, 4.0) == [(-1.0, 0.0), (3.0, 4.0)]
    assert yardstick.busy([]) == 0.0
