"""The port's CUDA kernels on the card (marked ``gpu``; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import pytest
import torch

from bndm_tpu_torch.ops.cuda_bluenoise import (FusedBlueNoise, fused_bluenoise,
                                               fused_bluenoise_flat, fused_bluenoise_flat_plain,
                                               tri_matmul, tri_matmul_plain)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode)")


def _random_L(n, seed):
    g = torch.Generator().manual_seed(seed)
    L = torch.tril(torch.randn(n, n, generator=g) * 0.02)
    L.fill_diagonal_(1.0)
    return L.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 12, 16, 17, 100, 1500])
def test_tri_matmul_kernel_matches_fp64_and_plain(m):
    """K1 on the card within 2e-5 of fp64 and of the plain version, one
    counted launch per call, across the narrow (M <= 16) and wide tiles and
    their ragged edges."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(m)
    L = torch.tril(torch.randn(4096, 4096, generator=g) * 0.02)
    L.fill_diagonal_(1.0)
    L = L.cuda()
    w = torch.randn(4096, m, generator=g).cuda()
    before = tri_matmul.launches
    got = tri_matmul(L, w)
    torch.cuda.synchronize()
    assert tri_matmul.launches == before + 1
    torch.testing.assert_close(got.double(), L.double() @ w.double(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, tri_matmul_plain(L, w), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_tri_matmul_small_and_odd_n():
    """n that is not a multiple of any tile: rows, K and columns all masked."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(0)
    for n, m in [(1, 1), (33, 5), (100, 70), (257, 16)]:
        L = torch.tril(torch.randn(n, n, generator=g)).cuda()
        w = torch.randn(n, m, generator=g).cuda()
        torch.testing.assert_close(tri_matmul(L, w).double(), L.double() @ w.double(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_tri_matmul_rejects_mixed_devices():
    _cuda_or_skip()
    with pytest.raises(ValueError):
        tri_matmul(torch.eye(8).cuda(), torch.ones(8, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 33, 192, 1500])
@pytest.mark.parametrize("gbn_only", [False, True])
def test_fused_bluenoise_kernel_matches_plain(m, gbn_only):
    """K2 on the card: its white noise equals the plain version's bits to
    1e-5 (libm against CUDA's logf/cosf), bn is within 2e-5 of fp64 L @ wn
    and of the plain bn, the mix is exact, and each call is one launch."""
    _cuda_or_skip()
    L = _random_L(4096, m)
    gamma = torch.rand(m, generator=torch.Generator().manual_seed(m)).cuda()
    seeds = (12345 + m, 678)
    before = fused_bluenoise_flat.launches
    noise, bn, wn = fused_bluenoise_flat(L, gamma, seeds, gbn_only)
    torch.cuda.synchronize()
    assert fused_bluenoise_flat.launches == before + 1
    p_noise, p_bn, p_wn = fused_bluenoise_flat_plain(L, gamma, seeds, gbn_only)
    torch.testing.assert_close(wn, p_wn, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.double(), L.double() @ wn.double(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(bn, p_bn, rtol=2e-5, atol=2e-5)
    want = bn if gbn_only else bn * (1.0 - gamma[None, :]) + wn * gamma[None, :]
    assert torch.equal(noise, want)


@pytest.mark.gpu
def test_fused_bluenoise_moments_and_determinism():
    """At the training shape (M = 192): standard-normal moments, the same
    seeds give the same bits, other seeds give other bits."""
    _cuda_or_skip()
    L = _random_L(4096, 1)
    gamma = torch.full((192,), 0.5, device="cuda")
    _, bn, wn = fused_bluenoise_flat(L, gamma, (1, 2))
    assert abs(wn.mean().item()) < 0.02 and abs(wn.var().item() - 1.0) < 0.02
    _, bn2, wn2 = fused_bluenoise_flat(L, gamma, (1, 2))
    assert torch.equal(wn, wn2) and torch.equal(bn, bn2)
    _, _, wn3 = fused_bluenoise_flat(L, gamma, (1, 3))
    _, _, wn4 = fused_bluenoise_flat(L, gamma, (2, 2))
    assert not torch.equal(wn, wn3) and not torch.equal(wn, wn4)


@pytest.mark.gpu
def test_fused_bluenoise_small_and_odd_n():
    """n that is not a multiple of any tile: rows, K and columns all masked."""
    _cuda_or_skip()
    for n, m in [(1, 1), (33, 5), (100, 70), (257, 16)]:
        L = _random_L(n, n)
        gamma = torch.linspace(0.1, 0.9, m, device="cuda")
        noise, bn, wn = fused_bluenoise_flat(L, gamma, (n, m))
        p_noise, p_bn, p_wn = fused_bluenoise_flat_plain(L, gamma, (n, m))
        torch.testing.assert_close(wn, p_wn, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(bn.double(), L.double() @ wn.double(), rtol=2e-5, atol=2e-5)
        assert torch.equal(noise, bn * (1.0 - gamma[None, :]) + wn * gamma[None, :])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 64, 500])
def test_fused_bluenoise_meets_the_tpu_kernels_contract(batch):
    """tests/test_fused_noise_tpu.py's contract, on its L: bn within 1e-5
    (absolute) of fp64 L @ wn, the mix exact, the same key the same noise;
    at its batch of 8, at the training batch and at a serving batch."""
    import numpy as np

    _cuda_or_skip()
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((4096, 4096)).astype(np.float32) * 0.02)
    np.fill_diagonal(L, 1.0)
    L = torch.from_numpy(L).cuda()
    gamma = torch.linspace(0.1, 0.9, batch, device="cuda")
    noise, bn, wn = fused_bluenoise((0, 1), batch, 3, L, gamma)
    flat = lambda x: x.reshape(batch * 3, 4096).T  # noqa: E731 -- (N, B*C) columns
    want = L.double() @ flat(wn).double()
    assert (flat(bn).double() - want).abs().max().item() < 1e-5
    g = gamma.reshape(-1, 1, 1, 1)
    assert torch.equal(noise, bn * (1 - g) + wn * g)
    assert torch.equal(noise, fused_bluenoise((0, 1), batch, 3, L, gamma)[0])


@pytest.mark.gpu
def test_fused_bluenoise_gamma_gradient():
    """K3: the tangent of noise in gamma is wn - bn, and the gradient of
    sum(noise^2) in the per-sample gamma is 2 * sum(noise * (wn - bn)) over
    the sample's pixels and channels."""
    _cuda_or_skip()
    b, c = 64, 3
    L = _random_L(4096, 2)
    gamma = torch.rand(b, generator=torch.Generator().manual_seed(3)).cuda().requires_grad_()
    noise, bn, wn = fused_bluenoise((5, 6), b, c, L, gamma)
    assert not bn.requires_grad and not wn.requires_grad
    (g,) = torch.autograd.grad((noise ** 2).sum(), gamma)
    want = (2.0 * noise * (wn - bn)).sum(dim=(1, 2, 3))
    torch.testing.assert_close(g, want.detach(), rtol=1e-5, atol=1e-3)
    # the tangent, read one pixel row at a time through the VJP
    gamma_cols = gamma.detach().repeat_interleave(c).requires_grad_()
    out, obn, own = FusedBlueNoise.apply(L, gamma_cols, (5, 6), False)
    for row in (0, 2047, 4095):
        sel = torch.zeros_like(out)
        sel[row] = 1.0
        (tan,) = torch.autograd.grad(out, gamma_cols, sel, retain_graph=True)
        torch.testing.assert_close(tan, (own - obn)[row], rtol=0, atol=1e-6)
    gbn = FusedBlueNoise.apply(L, gamma_cols, (5, 6), True)[0]
    (zero,) = torch.autograd.grad(gbn.sum(), gamma_cols)
    assert torch.equal(zero, torch.zeros_like(zero))


TINY = dict(block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"), attention_head_dim=4,
            norm_num_groups=4)


@pytest.mark.gpu
@pytest.mark.parametrize("noise_type,outc,engine", [
    ("gaussianBN", 6, "auto"), ("GBN", 3, "fused"), ("gaussianRN", 3, "auto"),
    ("gaussianBN", 6, "xla")])
def test_train_loss_on_card_matches_cpu(noise_type, outc, engine):
    """The train step's loss and its gradients on the card equal the CPU's
    on the same tiny weights and the same white noise: K2's draw, read back
    through the plain generator, feeds the CPU's unfused engine ("xla" on
    the card: K1 with the CPU's own draw). One kernel launch per loss."""
    from bndm_tpu_torch.cli.common import disable_tf32
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
    from bndm_tpu_torch.ops.cuda_bluenoise import white_noise_plain
    from bndm_tpu_torch.train.pixel import TrainConfig, make_train_step

    _cuda_or_skip()
    disable_tf32()
    cfg = TrainConfig(nb_steps=100, noise_type=noise_type, scheduler_gamma="sigmoid",
                      gamma_defaults=(0.5, -0.3, 2.0), optimize_scheduler_param=True,
                      out_channel=outc, noise_engine=engine)
    torch.manual_seed(0)
    cpu = UNet2D(UNet2DConfig(**TINY, out_channels=outc))
    gpu = UNet2D(UNet2DConfig(**TINY, out_channels=outc), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    L = _random_L(4096, 5)
    g = torch.Generator().manual_seed(6)
    x1 = torch.rand(2, 3, 64, 64, generator=g) * 2.0 - 1.0
    t = torch.tensor([10.0, 91.0])
    seeds = (11, 12)
    white = white_noise_plain(4096, 6, seeds).reshape(4096, 2, 3).permute(1, 2, 0)
    white = white.reshape(2, 3, 64, 64).contiguous()
    draw = seeds if engine != "xla" else white.cuda()

    results = []
    for model, dev, noise in ((gpu, "cuda", draw), (cpu, "cpu", white)):
        step, _ = make_train_step(cfg, L.to(dev))
        sp = torch.tensor([0.5, -0.3, 2.0], device=dev, requires_grad=True)
        before = (fused_bluenoise_flat.launches, tri_matmul.launches)
        loss = step.loss_fn(model, sp, x1.to(dev), t.to(dev), noise)
        loss.backward()
        # GBN's loss does not reach (tau, s, e): the CPU leaves no grad, K3 zeros
        results.append((loss.item(), torch.zeros(3) if sp.grad is None else sp.grad.cpu(),
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        (fused_bluenoise_flat.launches - before[0],
                         tri_matmul.launches - before[1])))
    (lg, sg, gg, launched), (lc, sc, gc, _) = results
    assert launched == ((0, 1) if engine == "xla" else (1, 0))
    assert lg == pytest.approx(lc, rel=1e-4)
    torch.testing.assert_close(sg, sc, rtol=1e-3, atol=1e-3 * float(sc.abs().max()))
    # each leaf within 1e-3 of its module's largest |g|: the key projection's
    # bias has a gradient of exactly zero (the softmax is blind to it), and
    # its rounding noise is on the scale of the kernel's gradient
    module = {k: k.rsplit(".", 1)[0] for k in gc}
    scale = {}
    for k, v in gc.items():
        scale[module[k]] = max(scale.get(module[k], 0.0), float(v.abs().max()))
    for k in gc:
        torch.testing.assert_close(gg[k], gc[k], rtol=1e-3, atol=1e-3 * scale[module[k]])
