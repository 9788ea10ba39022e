"""The plain reference against the program's float32 paths on the CPU at a
tiny width: the UNet, the VAE decode, the fused generator's white noise,
the blue-noise factor and the sampler's update. The program is imported
here only to be compared with."""

import math

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import nets, noise, sample
from perfbench.tests.tiny import TINY_UNET, TINY_VAE

torch.set_num_threads(1)


def _unet_cfg(cin, cout):
    return dict(TINY_UNET, in_channels=cin, out_channels=cout, layers_per_block=2,
                norm_eps=1e-5)


@pytest.mark.parametrize("cin,cout,res", [(3, 6, 16), (4, 8, 8)])
def test_unet_matches_the_program(cin, cout, res):
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig

    cfg = _unet_cfg(cin, cout)
    P = weights.make(nets.unet_spec(cfg), 5, "cpu")
    m = UNet2D(UNet2DConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg.items() if k != "norm_eps"}))
    m.load_state_dict(P, strict=True)
    x = torch.randn(2, cin, res, res, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0.3, 0.9])
    with torch.no_grad():
        ref, got = nets.unet(P, cfg, x, t), m(x, t)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_vae_decode_matches_the_program():
    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = dict(TINY_VAE, latent_channels=4, out_channels=3, norm_eps=1e-6)
    vae = AutoencoderKL(VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in TINY_VAE.items()}))
    spec = weights.spec_of(vae)
    dec = nets.vae_decode_spec(cfg)
    assert all(spec[k] == s for k, s in dec.items())
    P = {**weights.make(dec, 3, "cpu"),
         **weights.make({k: s for k, s in spec.items() if k not in dec}, 4, "cpu")}
    vae.load_state_dict(P, strict=True)
    z = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref, got = nets.vae_decode(P, cfg, z), vae.decode(z)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_philox_white_matches_the_program():
    from bndm_tpu_torch.ops.cuda_bluenoise import white_noise_plain

    seeds = (123456789, 2**31 - 2)
    ref = noise.philox_white(64, 12, seeds, "cpu")
    got = white_noise_plain(64, 12, seeds)
    assert float((ref - got).abs().max()) < 1e-5
    assert abs(float(ref.std()) - 1.0) < 0.2


def test_blue_noise_factor_matches_the_program():
    from bndm_tpu_torch.ops.cov import make_cov_L

    ref = noise.make_L(res=8)
    got = torch.from_numpy(make_cov_L(res=8, kind="blue"))
    assert float((ref - got).abs().max()) < 1e-5
    assert torch.equal(ref, torch.tril(ref))


def test_train_noise_matches_the_program_on_the_cpu():
    from bndm_tpu_torch.ops.noise import get_noise
    from bndm_tpu_torch.train.pixel import draw_noise

    L = noise.make_L(res=64)
    key = (2**31 + 7, 3)
    for res in (32, 64):
        x = torch.zeros(2, 4, res, res)
        gamma = torch.tensor([0.25, 0.75])
        white = draw_noise(x, key, "gaussianBN", "auto")
        got = get_noise(x, L, gamma, noise_type="gaussianBN", white=white)
        ref = noise.train_noise(key, x.shape, gamma, L, "cpu")
        for a, b in zip(got, ref):
            assert float((a - b).abs().max()) < 1e-4


def test_antithetic_t_matches_the_program():
    from bndm_tpu_torch.cli.common import make_generator
    from bndm_tpu_torch.train.losses import antithetic_timesteps

    key = (2**31 + 11, 0)
    assert torch.equal(noise.antithetic_t(key, 7, 1000),
                       antithetic_timesteps(make_generator("cpu", *key), 7, 1000))


def test_sampler_update_matches_the_program():
    from bndm_tpu_torch.samplers.iadb import _coefficients, iadb_step

    a, da, dg = sample.coefficients(250)
    pa, pda, pdg = _coefficients(250, "linear", 0.02, "linear", (1.0, 0.0, 3.0))
    assert (a, da, dg) == (pa, pda, pdg)
    x, d = torch.randn(2, 4, 3, 3), torch.randn(2, 8, 3, 3)
    assert torch.equal(sample.update(x, d, da[5], dg[5]),
                       iadb_step(x, d, da[5], 0.0, dg[5], 0.0, two_head=True))


def test_weights_are_seeded_and_spread():
    spec = {"a.weight": (16, 8, 3, 3), "a.bias": (16,), "n.norm1.weight": (8,)}
    w1, w2 = weights.make(spec, 9, "cpu"), weights.make(spec, 9, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in spec)
    assert abs(float(w1["a.weight"].std()) * math.sqrt(3 * 72) - 1.0) < 0.1
    assert abs(float(w1["n.norm1.weight"].mean()) - 1.0) < 0.1
    assert not torch.equal(weights.make(spec, 10, "cpu")["a.weight"], w1["a.weight"])


def test_fp8_control_rounds_coarser_than_bfloat16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = float((nets.fp8(x) - x).norm() / x.norm())
    e16 = float((x.bfloat16().float() - x).norm() / x.norm())
    assert e8 > 8 * e16 and np.isfinite(e8)
