"""The PyTorch port's ops against the JAX package on the same inputs.

Schedules, the covariance-factor IO, the noise engine with its correlation
matmul (K1's wrapper takes its plain fp32 path on CPU tensors), and the image
utilities. Inputs are made with numpy from a seed and handed to both sides;
JAX runs on the CPU at full fp32 matmul precision.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.ops import cov as jcov
from bndm_tpu.ops import noise as jnoise
from bndm_tpu.ops import schedules as jsched
from bndm_tpu.utils import image as jimage
from bndm_tpu.utils import metrics as jmetrics
from bndm_tpu_torch.ops import cov as tcov
from bndm_tpu_torch.ops import noise as tnoise
from bndm_tpu_torch.ops import schedules as tsched
from bndm_tpu_torch.ops.cuda_bluenoise import apply_L, tri_matmul
from bndm_tpu_torch.utils import image as timage
from bndm_tpu_torch.utils import metrics as tmetrics

T = 250


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------- schedules -----------------------------------

ALPHA_CASES = [("linear", 0.02), ("sigmoid", 0.02), ("sigmoid", -1.5), ("cosine", 1.0)]
GAMMA_CASES = [
    ("linear", (1.0, 0.0, 3.0)),
    ("sigmoid", (0.2, 0.0, 3.0)),     # church super-res
    ("sigmoid", (1000.0, 0.0, 3.0)),  # cat res-64 headline
    ("sigmoid", (0.5, -1.0, 2.0)),
    ("cosine", (1.0, 0.2, 1.0)),
    ("cosine", (0.7, 0.1, 0.9)),
]


@pytest.mark.parametrize("kind,param", ALPHA_CASES)
def test_alpha_schedule_matches_jax(kind, param):
    t = np.arange(T + 1, dtype=np.float32)
    want = np.asarray(jsched.alpha_schedule(jnp.asarray(t), T, kind, param))
    got = _np(tsched.alpha_schedule(torch.from_numpy(t), T, kind, param))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,params", GAMMA_CASES)
def test_gamma_schedule_and_grads_match_jax(kind, params):
    """Values over t in [0, T] within 1e-6, and the gradient of a weighted
    sum with respect to (tau, s, e), t = 0 included (the warp meets its clip
    there), within 1e-5 of the gradient's scale. Why not 1e-6: XLA's fp32
    tanh differs from torch's by up to 2 ulp (torch's is correctly rounded
    almost everywhere), and the derivative 1 - tanh^2 cancels where the
    sigmoid saturates (tau = 0.2 late in the chain), which turns those ulps
    into a few 1e-6 of the gradient."""
    t = np.arange(T + 1, dtype=np.float32)
    w = np.random.default_rng(3).standard_normal(T + 1).astype(np.float32)
    p = np.asarray(params, np.float32)
    want = np.asarray(jsched.gamma_schedule(jnp.asarray(t), T, kind, jnp.asarray(p)))
    tp = torch.tensor(p, requires_grad=True)
    got = tsched.gamma_schedule(torch.from_numpy(t), T, kind, tp)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    if kind == "linear":
        return  # ignores its params
    gj = np.asarray(jax.grad(
        lambda q: jnp.sum(jsched.gamma_schedule(jnp.asarray(t), T, kind, q) * w))(jnp.asarray(p)))
    (got * torch.from_numpy(w)).sum().backward()
    scale = max(1.0, float(np.abs(gj).max()))
    np.testing.assert_allclose(_np(tp.grad), gj, rtol=0, atol=1e-5 * scale)


def test_gamma_param_ranges_match_jax():
    for kind, opt in [("sigmoid", True), ("linear", True), ("sigmoid", False)]:
        assert tsched.gamma_param_ranges(kind, opt) == jsched.gamma_param_ranges(kind, opt)


# --------------------------------- cov ---------------------------------------


@pytest.mark.parametrize("kind", ["blue", "red", "white"])
def test_cov_generation_matches_jax_copy(kind):
    np.testing.assert_array_equal(tcov.radial_spectrum_profile(16, kind),
                                  jcov.radial_spectrum_profile(16, kind))
    if kind != "white":  # make_cov_L takes blue or red
        np.testing.assert_array_equal(tcov.make_cov_L(res=8, kind=kind),
                                      jcov.make_cov_L(res=8, kind=kind))


def test_load_cov_L_search_and_cache(tmp_path):
    """Artifact search order and the generated_* cache, as in the JAX copy."""
    L = np.tril(np.ones((4, 4), np.float32))
    d = tmp_path / "bn"
    d.mkdir()
    np.savez(d / "cov_gaussianBN_L_res64_d3.npz", x=L)
    np.testing.assert_array_equal(tcov.load_cov_L(search_dirs=(str(d),)), L)
    np.testing.assert_array_equal(tcov.load_cov_L(path=str(d / "cov_gaussianBN_L_res64_d3.npz")), L)
    with pytest.raises(FileNotFoundError):
        tcov.load_cov_L(res=4, search_dirs=(str(tmp_path),), generate_if_missing=False)
    got = tcov.load_cov_L(res=4, search_dirs=(), cache_dir=str(tmp_path / "cache"))
    assert os.path.exists(tmp_path / "cache" / "generated_cov_gaussianBN_L_res4_d3.npz")
    np.testing.assert_array_equal(got, jcov.make_cov_L(res=4))
    np.testing.assert_array_equal(
        tcov.load_cov_L(res=4, search_dirs=(), cache_dir=str(tmp_path / "cache")), got)


# --------------------------------- K1 ----------------------------------------


@pytest.mark.parametrize("m", [1, 7, 12, 100])
def test_tri_matmul_cpu_matches_fp64(small_L, m):
    """On CPU tensors the wrapper takes the plain fp32 version (no launch)."""
    w = np.random.default_rng(m).standard_normal((small_L.shape[0], m)).astype(np.float32)
    before = tri_matmul.launches
    got = tri_matmul(torch.from_numpy(small_L), torch.from_numpy(w))
    assert tri_matmul.launches == before
    want = small_L.astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)


def test_apply_L_fold_matches_fp64(small_L):
    """(B, HW, C) -> fold to (HW, B*C) -> K1 -> unfold, against per-sample fp64."""
    wf = np.random.default_rng(1).standard_normal((3, small_L.shape[0], 4)).astype(np.float32)
    got = _np(apply_L(torch.from_numpy(small_L), torch.from_numpy(wf)))
    want = np.einsum("pq,bqc->bpc", small_L.astype(np.float64), wf.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_tri_matmul_rejects_what_it_does_not_take():
    L = torch.tril(torch.ones(8, 8))
    with pytest.raises(TypeError):
        tri_matmul(L.double(), torch.ones(8, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tri_matmul(L, torch.ones(7, 2))
    with pytest.raises(ValueError):
        tri_matmul(L, torch.ones(2, 8).t())  # not contiguous
    with pytest.raises(ValueError):
        tri_matmul(L[:, :4], torch.ones(8, 2))
    with pytest.raises(ValueError):
        apply_L(L, torch.ones(1, 7, 3))


# -------------------------------- noise --------------------------------------

CORRELATED = ["gaussianBN", "gaussianRN", "GBN"]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("res", [32, 64, 128])
@pytest.mark.parametrize("noise_type", ["gaussian"] + CORRELATED)
def test_get_noise_matches_jax(small_L, noise_type, res, train):
    """Every (type, res, train) case of tests/test_noise.py, inplace, same
    white tensor and small_L: noise, noise_bn and noise_wn within 2e-5."""
    rng = np.random.default_rng(res + 7 * train)
    b = 2
    x = rng.standard_normal((b, 3, res, res)).astype(np.float32)
    gamma = np.array([0.3, 0.9], np.float32)
    with jax.default_matmul_precision("float32"):
        want = jnoise.get_noise(jnp.asarray(x), jnp.asarray(small_L), jnp.asarray(gamma),
                                noise_type=noise_type, train=train, inplace=True)
    got = tnoise.get_noise(torch.from_numpy(x), torch.from_numpy(small_L),
                           torch.from_numpy(gamma), noise_type=noise_type, train=train,
                           inplace=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_noise_padding_and_v2_adapter_match_jax(small_L):
    rng = np.random.default_rng(5)
    tiles = rng.standard_normal((2, 4, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(_np(tnoise.noise_padding(torch.from_numpy(tiles))),
                                  np.asarray(jnoise.noise_padding(jnp.asarray(tiles))))
    x = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = jnoise.get_noise_v2(None, jnp.asarray(x), jnp.asarray(small_L), jnp.array([0.5]),
                                   None, noise_type="gaussianBN", train_or_test="test",
                                   inplace=True)
    got = tnoise.get_noise_v2(None, torch.from_numpy(x), torch.from_numpy(small_L),
                              torch.tensor([0.5]), None, noise_type="gaussianBN",
                              train_or_test="test", inplace=True)
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_fresh_noise_uses_the_generator(small_L):
    """Fresh draws come from the caller's generator: the same seed gives the
    same noise, and gamma=1 gives unit-variance white noise."""
    L = torch.from_numpy(small_L)
    x = torch.zeros(16, 3, 64, 64)
    a = tnoise.get_noise(x, L, torch.ones(16), noise_type="gaussianBN",
                         generator=torch.Generator().manual_seed(0))
    b = tnoise.get_noise(x, L, torch.ones(16), noise_type="gaussianBN",
                         generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.noise, b.noise, rtol=0, atol=0)
    assert abs(float(a.noise.mean())) < 0.02
    assert abs(float(a.noise.var()) - 1.0) < 0.03
    u = tnoise.get_noise(x, None, torch.zeros(16), noise_type="uniform",
                         generator=torch.Generator().manual_seed(1)).noise
    assert abs(float(u.var()) - 1.0) < 0.03 and float(u.abs().max()) <= np.sqrt(3) + 1e-6


def test_noise_argument_rules():
    x = torch.zeros(2, 3, 64, 64)
    with pytest.raises(ValueError, match="generator is required"):
        tnoise.get_noise(x, None, torch.zeros(2), noise_type="uniform", inplace=True)
    with pytest.raises(ValueError, match="generator is required"):
        tnoise.get_noise(x, None, torch.zeros(2), noise_type="gaussian")
    with pytest.raises(NotImplementedError, match="K2"):
        tnoise.get_noise(x, None, torch.zeros(2), noise_type="gaussianBN", engine="fused",
                         generator=torch.Generator())
    with pytest.raises(NotImplementedError):
        tnoise.get_noise(x, None, torch.zeros(2), noise_type="pink", inplace=True)


# ------------------------------ image utils ----------------------------------


def test_superres_condition_ssim_psnr_match_jax():
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    want_c = np.asarray(jimage.superres_condition(jnp.asarray(x), downscale=4))
    got_c = _np(timage.superres_condition(torch.from_numpy(x), downscale=4))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    a = (x + 1) / 2
    b = np.clip(a + rng.normal(0, 0.05, a.shape).astype(np.float32), 0, 1)
    with jax.default_matmul_precision("float32"):
        want_s = np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    got_s = _np(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    want_p = np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    got_p = _np(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
