"""The port's latent pipeline against the JAX package, on the CPU.

The upsample against JAX's subpixel conv (alone and as the UNet's
``fast_upsample``), the tiny VAE's encode (the posterior mean, and a sample
on a given eps) and decode on a JAX VAE's weights carried across, the full
SD VAE's parameter tree, the microbatched decoder against the full batch,
the latent cache's files and batch order, and the latent train step's loss
and gradients on injected noise and t. Weights are made with numpy at the flax shapes; JAX
runs at fp32 matmul precision.

Tolerances: 1e-5 for the upsample conv; 5e-4 for model forwards in fp32;
the decoder's chunks and the cache's order exact; losses 1e-5 relative,
gradients 1e-4 of each module's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.data import latent_cache as JC
from bndm_tpu.models import unet2d as J
from bndm_tpu.models import vae as JV
from bndm_tpu.models.convert import convert_flax_params
from bndm_tpu.train import latent as JT
from bndm_tpu_torch.data import latent_cache as TC
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models import vae as PV
from bndm_tpu_torch.models.convert import flax_from_state_dict, state_dict_from_flax
from bndm_tpu_torch.train import latent as TT
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_train import PLAIN, _assert_tree_close
from test_torch_port_unet import TINY, random_flax_params

FWD = dict(rtol=5e-4, atol=5e-4)
# the tiny VAE of the latent CLI's --tiny_model: still /8 like the SD VAE
TINY_VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_subpixel_upconv_matches_jax():
    """The port's upsample (nearest-2x, then the 3x3 conv) against JAX's
    4-phase subpixel form on the same weights (1e-5): the same function."""
    cin = 6
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((3, 3, cin, cin)) / 7).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    x = _x((2, cin, 7, 9), 1)
    with jax.default_matmul_precision("float32"):
        want = J._SubpixelUpConv(cin).apply({"params": {"kernel": kernel, "bias": bias}},
                                            jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    m = P.Upsample2D(cin)
    m.load_state_dict({"conv.weight": torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()),
                       "conv.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, cin, 14, 18)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unet_fast_upsample_matches_jax():
    """``fast_upsample``: the same parameter names as the plain UNet, and
    JAX's forward (5e-4)."""
    jm = J.UNet2D(J.UNet2DConfig(**TINY, fast_upsample=True))
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 16, 16)), jnp.zeros(1),
                                               seed=2))
    tm = P.UNet2D(P.UNet2DConfig(**TINY, fast_upsample=True))
    assert set(tm.state_dict()) == set(P.UNet2D(P.UNet2DConfig(**TINY)).state_dict())
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    x, t = _x((2, 3, 16, 16), 3), np.array([0.3, 0.8], np.float32)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.fixture(scope="module")
def tiny_vae():
    """The tiny JAX VAE with seeded numpy params, and the port's VAE on the
    same weights (through ``state_dict_from_flax``)."""
    jm = JV.AutoencoderKL(JV.VAEConfig(**TINY_VAE))
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 64, 64)), seed=4))
    tm = PV.AutoencoderKL(PV.VAEConfig(**TINY_VAE))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm.eval()


def test_vae_matches_jax(tiny_vae):
    """encode_moments, encode as the posterior mean (key None) and as a
    sample on JAX's eps, and decode: 5e-4."""
    jm, params, tm = tiny_vae
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    z_in = 0.18215 * _x((2, 4, 8, 8), 7)

    @jax.jit
    def jax_side(params, x, z):
        mean, logvar = jm.apply(params, x, method=JV.AutoencoderKL.encode_moments)
        return (mean, logvar, jm.apply(params, x, method=JV.AutoencoderKL.encode),
                jm.apply(params, x, key, method=JV.AutoencoderKL.encode),
                jm.apply(params, z, method=JV.AutoencoderKL.decode))

    with jax.default_matmul_precision("float32"):
        want = [np.asarray(a) for a in jax_side(params, jnp.asarray(x), jnp.asarray(z_in))]
    eps = torch.from_numpy(np.array(jax.random.normal(key, want[0].shape)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = [*tm.encode_moments(xt), tm.encode(xt), tm.encode(xt, eps=eps),
               tm.decode(torch.from_numpy(z_in))]
    assert got[-1].shape == (2, 3, 64, 64) and got[0].shape == (2, 4, 8, 8)
    for name, g, w in zip(("mean", "logvar", "encode", "encode(eps)", "decode"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **FWD, err_msg=name)


def test_sd_vae_parameter_tree_matches_jax():
    """The default (SD) VAE: 83,653,863 parameters, under the names and
    shapes JAX's tree converts to."""
    jm = JV.AutoencoderKL(JV.VAEConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in convert_flax_params(zeros).items()}
    got = {k: tuple(v.shape) for k, v in
           PV.AutoencoderKL(PV.VAEConfig(), device="meta").state_dict().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 83_653_863


def test_make_decoder_microbatched_is_exact(tiny_vae):
    """Chunks of 2 (the last zero-padded), of 5 and of 8 (> batch) decode a
    batch of 5 to the full batch's bits."""
    _, _, tm = tiny_vae
    z = torch.from_numpy(_x((5, 4, 8, 8), 8))
    full = PV.make_decoder(tm)(z)
    for mb in (2, 5, 8):
        out = PV.make_decoder(tm, mb)(z)
        assert out.shape == full.shape and torch.equal(out, full), mb


def test_latent_cache_files_and_order_match_jax(tmp_path):
    """A cache written by either package reads in the other (fp16 on disk),
    and ``batches(seed=(seed, epoch))`` gives JAX's batches exactly, sharded
    or not."""
    lat = np.random.default_rng(9).standard_normal((13, 4, 8, 8)).astype(np.float32)
    for writer, path in ((TC.LatentCacheWriter, tmp_path / "port"),
                         (JC.LatentCacheWriter, tmp_path / "jax")):
        w = writer(str(path), (4, 8, 8))
        for v in lat:
            w.add(v)
        assert w.finalize() == 13
        tds, jds = TC.LatentCacheDataset(str(path)), JC.LatentCacheDataset(str(path))
        assert len(tds) == len(jds) == 13 and tds.meta == jds.meta
        assert tds.latents.dtype == np.float16
        for kw in (dict(seed=(0, 3)), dict(seed=(1, 0), shard_index=1, shard_count=2),
                   dict(seed=(2, 1), drop_last=False)):
            got, want = list(tds.batches(4, **kw)), list(jds.batches(4, **kw))
            assert len(got) == len(want) > 0
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


CASES = {"gaussianBN-two-head": ("gaussianBN", 8), "GBN": ("GBN", 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_latent_train_step_loss_and_grads_match_jax(small_L, case):
    """The latent step on 32x32 latents (the res-32 noise path: tiled to 64,
    correlated, cropped): the loss to 1e-5 relative and every gradient to
    1e-4 of its module's largest, on the same weights, t and white noise
    (JAX's draw from the step's noise key, fed to the port)."""
    noise_type, outc = CASES[case]
    kw = dict(ddpm_num_steps=100, noise_type=noise_type, out_channels=outc)
    jm = J.UNet2D(J.UNet2DConfig(**PLAIN, in_channels=4, out_channels=outc))
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 4, 32, 32)), jnp.zeros(1),
                                               seed=10))
    tm = P.UNet2D(P.UNet2DConfig(**PLAIN, in_channels=4, out_channels=outc))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    clean, t = _x((2, 4, 32, 32), 11), np.array([7.0, 94.0], np.float32)
    key = jax.random.PRNGKey(12)

    def grads(params, clean, t, key, L):  # L an argument: no 64 MB constant to fold
        step, _ = JT.make_latent_train_step(jm.apply, JT.LatentTrainConfig(**kw), L, None)
        return jax.value_and_grad(step.loss_fn)(params, clean, t, key)

    with jax.default_matmul_precision("float32"):
        loss, g = jax.jit(grads)(params, jnp.asarray(clean), jnp.asarray(t), key,
                                 jnp.asarray(small_L))
    white = torch.from_numpy(np.array(jax.random.normal(key, (2, 4, 64, 64), jnp.float32)))
    step, _ = TT.make_latent_train_step(TT.LatentTrainConfig(**kw), torch.from_numpy(small_L),
                                        None)
    got = step.loss_fn(tm, torch.from_numpy(clean), torch.from_numpy(t), white)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    _assert_tree_close(flax_from_state_dict({k: p.grad for k, p in tm.named_parameters()}),
                       jax.device_get(g), 1e-4)
