"""K2 (fused RNG -> L-matmul -> mix) and K3 (its gamma gradient) on the CPU.

The CUDA kernel cannot run here; its plain version can, and it is the
kernel's oracle on the card (tests/test_torch_port_gpu.py, chip_smoke.py).
It is held by contract, as the JAX package's kernel is
(tests/test_fused_noise_tpu.py): the generator against Random123's known
answers, the white noise's moments, bn against fp64 L @ wn, the exact mix,
determinism, and the gradient rule. The engine switch is held to the JAX
package's noise engine on the same white noise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.ops.noise import get_noise as j_get_noise
from bndm_tpu_torch.ops import cuda_bluenoise as cb
from bndm_tpu_torch.ops.noise import fresh_shape, get_noise, takes_fused
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)

U32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's published philox4x32-10 vectors."""
    got = cb.philox4x32_10(tuple(torch.tensor(c, dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in got) == want
    assert all(0 <= int(w) <= U32 for w in got)


def test_philox_is_counter_based():
    """Each word depends only on (key, counter): a batch of counters gives
    the words of each counter alone."""
    rows = torch.arange(5, dtype=torch.int64)[:, None]
    cols = torch.arange(3, dtype=torch.int64)[None, :]
    zero = torch.zeros((), dtype=torch.int64)
    batch = cb.philox4x32_10((rows, cols, zero, zero), (7, 9))
    for r in range(5):
        for c in range(3):
            one = cb.philox4x32_10(tuple(torch.tensor(v) for v in (r, c, 0, 0)), (7, 9))
            assert [int(w[r, c]) for w in batch] == [int(w) for w in one]


@pytest.fixture(scope="module")
def flat(small_L):
    """(L, gamma, noise, bn, wn) of the plain K2 at the training shape
    M = 192 (batch 64, 3 channels)."""
    L = torch.from_numpy(small_L)
    gamma = torch.rand(192, generator=torch.Generator().manual_seed(0))
    return (L, gamma) + cb.fused_bluenoise_flat_plain(L, gamma, (11, 22))


def test_fused_plain_contract(flat):
    """wn standard normal, bn = L @ wn to 1e-5 of fp64, the mix exact."""
    L, gamma, noise, bn, wn = flat
    assert noise.shape == bn.shape == wn.shape == (4096, 192)
    assert abs(wn.mean().item()) < 0.02 and abs(wn.var().item() - 1.0) < 0.02
    ref = L.double() @ wn.double()
    np.testing.assert_allclose(bn.double().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(noise, bn * (1.0 - gamma[None, :]) + wn * gamma[None, :])
    gbn, gbn_bn, gbn_wn = cb.fused_bluenoise_flat_plain(L, gamma, (11, 22), gbn_only=True)
    assert torch.equal(gbn, bn) and torch.equal(gbn_bn, bn) and torch.equal(gbn_wn, wn)


def test_fused_plain_determinism(flat):
    L, gamma, noise, bn, wn = flat
    again = cb.fused_bluenoise_flat_plain(L, gamma, (11, 22))
    assert all(torch.equal(a, b) for a, b in zip(again, (noise, bn, wn)))
    for other in ((11, 23), (12, 22)):
        assert not torch.equal(cb.white_noise_plain(4096, 192, other), wn)
    # the white value of (row, column) does not depend on M: the operand
    # tile and the output tile of the kernel agree by construction
    assert torch.equal(cb.white_noise_plain(4096, 7, (11, 22)), wn[:, :7])


def test_fused_wrapper_takes_plain_on_cpu(flat):
    L, gamma, noise, bn, wn = flat
    before = cb.fused_bluenoise_flat.launches
    got = cb.fused_bluenoise_flat(L, gamma, (11, 22))
    assert cb.fused_bluenoise_flat.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (noise, bn, wn)))
    with pytest.raises(ValueError):
        cb.fused_bluenoise_flat(L, gamma, (11, -1))
    with pytest.raises(TypeError):
        cb.fused_bluenoise_flat(L.double(), gamma, (11, 22))


def test_fused_layout_matches_jax_engine(small_L):
    """fused_bluenoise's (N, B*C) -> (B, C, 64, 64) images equal the JAX
    package's noise engine fed the same white noise."""
    b, c = 2, 3
    L = torch.from_numpy(small_L)
    gamma = torch.tensor([0.3, 0.8])
    noise, bn, wn = cb.fused_bluenoise((5, 6), b, c, L, gamma)
    assert noise.shape == (b, c, 64, 64)
    flat_wn = cb.white_noise_plain(4096, b * c, (5, 6))
    assert torch.equal(wn, flat_wn.reshape(4096, b, c).permute(1, 2, 0).reshape(b, c, 64, 64))
    with jax.default_matmul_precision("float32"):
        want = j_get_noise(jnp.asarray(wn.numpy()), jnp.asarray(small_L),
                           jnp.asarray(gamma.numpy()), noise_type="gaussianBN", inplace=True)
    for got, w in zip((noise, bn, wn), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_k3_gradient_on_cpu(small_L):
    """K3: the gradient of sum(noise^2) in the per-sample gamma is
    2 * sum(noise * (wn - bn)); the tangent of each column is wn - bn; GBN
    has none; L and the seeds get none."""
    b, c = 4, 3
    L = torch.from_numpy(small_L)
    gamma = torch.tensor([0.1, 0.4, 0.6, 0.9], requires_grad=True)
    noise, bn, wn = cb.fused_bluenoise((1, 2), b, c, L, gamma)
    assert not bn.requires_grad and not wn.requires_grad
    (g,) = torch.autograd.grad((noise ** 2).sum(), gamma)
    want = (2.0 * noise * (wn - bn)).sum(dim=(1, 2, 3)).detach()
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-3)

    cols = gamma.detach().repeat_interleave(c).requires_grad_()
    out, obn, own = cb.FusedBlueNoise.apply(L, cols, (1, 2), False)
    for row in (0, 1234, 4095):
        sel = torch.zeros_like(out)
        sel[row] = 1.0
        (tan,) = torch.autograd.grad(out, cols, sel, retain_graph=True)
        np.testing.assert_allclose(tan.numpy(), (own - obn)[row].numpy(), rtol=0, atol=1e-6)
    gbn = cb.FusedBlueNoise.apply(L, cols, (1, 2), True)[0]
    (zero,) = torch.autograd.grad(gbn.sum(), cols)
    assert torch.equal(zero, torch.zeros_like(zero))


def test_fused_rule():
    """K2 takes a fresh res-64 correlated draw of a CUDA tensor under
    "fused" or "auto" (the JAX rule, with CUDA for the TPU), nothing else."""
    def x(device="cuda", res=64):
        return types.SimpleNamespace(device=torch.device(device), shape=(2, 3, res, res))

    for nt in ("gaussianBN", "gaussianRN", "GBN"):
        assert takes_fused(x(), nt, False, "auto") and takes_fused(x(), nt, False, "fused")
    assert not takes_fused(x(), "gaussianBN", False, "xla")
    assert not takes_fused(x(), "gaussianBN", True, "auto")
    assert not takes_fused(x("cpu"), "gaussianBN", False, "fused")
    assert not takes_fused(x(res=128), "gaussianBN", False, "auto")
    assert not takes_fused(x(res=32), "GBN", False, "auto")
    assert not takes_fused(x(), "gaussian", False, "auto")


@pytest.mark.parametrize("engine", ["fused", "auto"])
def test_fused_engines_on_cpu_take_unfused_path(small_L, engine):
    """On a CPU tensor "fused" and "auto" are the unfused engine: the same
    generator gives the same noise as "xla", and K2 is not called."""
    L = torch.from_numpy(small_L)
    x = torch.zeros(2, 3, 64, 64)
    gamma = torch.tensor([0.2, 0.7])
    before = cb.fused_bluenoise_flat.launches
    got = get_noise(x, L, gamma, noise_type="gaussianBN",
                    generator=torch.Generator().manual_seed(4), engine=engine)
    want = get_noise(x, L, gamma, noise_type="gaussianBN",
                     generator=torch.Generator().manual_seed(4), engine="xla")
    assert cb.fused_bluenoise_flat.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("noise_type,res", [("gaussianBN", 32), ("gaussianBN", 64),
                                            ("GBN", 128), ("gaussian", 64),
                                            ("uniform", 64)])
def test_caller_white_matches_jax_fresh_draw(small_L, noise_type, res):
    """The train step's draw: the port's engine fed the white noise the JAX
    engine draws fresh from a key (in ``fresh_shape``) gives JAX's result."""
    x = np.zeros((2, 3, res, res), np.float32)
    gamma = np.array([0.25, 0.75], np.float32)
    key = jax.random.PRNGKey(res)
    shape = fresh_shape(x.shape, noise_type)
    draw = jax.random.uniform if noise_type == "uniform" else jax.random.normal
    white = np.array(draw(key, shape, jnp.float32))
    with jax.default_matmul_precision("float32"):
        want = j_get_noise(jnp.asarray(x), jnp.asarray(small_L), jnp.asarray(gamma),
                           noise_type=noise_type, key=key)
    got = get_noise(torch.from_numpy(x), torch.from_numpy(small_L), torch.from_numpy(gamma),
                    noise_type=noise_type, white=torch.from_numpy(white), engine="auto")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
