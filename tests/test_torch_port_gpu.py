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
from bndm_tpu_torch.scripts import bench_stream


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


def _sweep():
    from bndm_tpu_torch.ops.cuda_bluenoise import SKINNY_MAX_M

    return sorted({1, 7, 12, 24, 48, 96, 192, 768, 1500, SKINNY_MAX_M, SKINNY_MAX_M + 1})


@pytest.mark.gpu
@pytest.mark.parametrize("m", _sweep())
def test_tri_matmul_m_sweep_is_right_and_deterministic(m):
    """K1 over the M sweep of chip_smoke.py phase 3 and both sides of the
    crossover (both designs): within 2e-5 of fp64 and of the plain version,
    and the same bits on a second call (no float atomics, fixed summation
    order)."""
    _cuda_or_skip()
    L = _random_L(4096, 100 + m)
    w = torch.randn(4096, m, generator=torch.Generator().manual_seed(m)).cuda()
    got = tri_matmul(L, w)
    again = tri_matmul(L, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.double(), L.double() @ w.double(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, tri_matmul_plain(L, w), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("side,regime", [(0, "skinny"), (0, "wide"), (1, "wide")])
def test_tri_matmul_both_designs_at_the_crossover(side, regime):
    """Both designs at M = SKINNY_MAX_M and the wide one just past it, each
    within 2e-5 of fp64 and uncounted; tri_matmul takes the skinny design up
    to the crossover and the wide one past it (the same bits)."""
    from bndm_tpu_torch.ops.cuda_bluenoise import SKINNY_MAX_M, _launch

    _cuda_or_skip()
    m = SKINNY_MAX_M + side
    L = _random_L(4096, 7)
    w = torch.randn(4096, m, generator=torch.Generator().manual_seed(8)).cuda()
    before = tri_matmul.launches
    got = _launch(L, w, regime)
    torch.cuda.synchronize()
    assert tri_matmul.launches == before
    torch.testing.assert_close(got.double(), L.double() @ w.double(), rtol=2e-5, atol=2e-5)
    if regime == ("skinny" if side == 0 else "wide"):
        assert torch.equal(tri_matmul(L, w), got)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["skinny", "wide"])
def test_tri_matmul_designs_mask_ragged_shapes(regime):
    """Each design on n, M not multiples of 4 or of a tile (the 4-byte copy
    path), a misaligned W (a view 4 bytes in) and a tile cut between blocks."""
    from bndm_tpu_torch.ops.cuda_bluenoise import _launch

    _cuda_or_skip()
    g = torch.Generator().manual_seed(9)
    for n, m in [(1, 1), (33, 5), (257, 16), (1000, 33), (130, 64), (4093, 3)]:
        L = _random_L(n, n)
        w = torch.randn(n * m + 1, generator=g).cuda()[1:].view(n, m)
        torch.testing.assert_close(_launch(L, w, regime).double(), L.double() @ w.double(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_tri_matmul_rejects_mixed_devices():
    _cuda_or_skip()
    with pytest.raises(ValueError):
        tri_matmul(torch.eye(8).cuda(), torch.ones(8, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 33, 48, 96, 192, 768, 1500])
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
def test_fused_bluenoise_split_tiles_give_the_same_bits():
    """At M = 192 the schedule cuts tiles between blocks, so their partial
    sums go through the fix-up kernel (which also writes the mix): a second
    call gives the same bits in all three outputs."""
    from bndm_tpu_torch.ops.cuda_bluenoise import _schedule_on

    _cuda_or_skip()
    L = _random_L(4096, 4)
    gamma = torch.rand(192, generator=torch.Generator().manual_seed(4)).cuda()
    assert _schedule_on(L.device, 4096, 192, "wide")[2].shape[0] > 0  # fix-ups
    first = fused_bluenoise_flat(L, gamma, (9, 10))
    again = fused_bluenoise_flat(L, gamma, (9, 10))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


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
@pytest.mark.parametrize("batch", [8, 16, 32, 64, 256, 500])
def test_fused_bluenoise_meets_the_tpu_kernels_contract(batch):
    """tests/test_fused_noise_tpu.py's contract, on its L: bn within 1e-5
    (absolute) of fp64 L @ wn, the mix exact, the same key the same noise;
    at its batch of 8, at M = 48, 96 and 768 (batch 16, 32, 256), at the
    training batch and at a serving batch."""
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


# ------------------- the pixel train step's UNet as CUDA graphs ---------------


def _graph_trainers(dtype="float32", conditional=False):
    """Two pixel trainers on the card from the same weights and state (the
    tiny UNet, (tau, s, e) learnable, K2's draw, the clip): the train step
    replays the UNet's graphs in both but where :func:`_eager_step` runs
    it eagerly."""
    from bndm_tpu_torch.cli.common import disable_tf32
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
    from bndm_tpu_torch.train.pixel import PixelTrainer, TrainConfig

    _cuda_or_skip()
    disable_tf32()
    cfg = TrainConfig(nb_steps=100, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                      gamma_defaults=(0.5, -0.3, 2.0), optimize_scheduler_param=True,
                      out_channel=6, grad_clip=1.0, conditional=conditional)
    ucfg = UNet2DConfig(**TINY, in_channels=6 if conditional else 3, out_channels=6,
                        dtype=dtype)
    torch.manual_seed(0)
    weights = UNet2D(ucfg).state_dict()
    L = _random_L(4096, 5)
    trainers = []
    for _ in range(2):
        model = UNet2D(ucfg, device="cuda")
        model.load_state_dict(weights)
        trainers.append(PixelTrainer(model.train(), cfg, L, seed=3))
    return trainers


def _eager_step(monkeypatch, trainer, batch, key):
    from bndm_tpu_torch.train import pixel

    with monkeypatch.context() as m:
        m.setattr(pixel, "graphs_unet", lambda *args: False)
        return trainer.step(batch, key)


def _batch(n, seed):
    return torch.rand(n, 3, 64, 64, generator=torch.Generator().manual_seed(seed)).cuda()


def _assert_rel(got, want, what, rel=1e-6):
    """``got`` within ``rel`` of ``want`` in norm."""
    err = float((got.detach().double() - want.detach().double()).norm())
    assert err <= rel * float(want.detach().double().norm()), (what, err, float(want.norm()))


def _assert_tree_rel(got, want, rel=1e-6):
    """Each leaf of ``got`` (name: tensor) within ``rel`` of ``want``'s in
    norm, relative to the largest norm among its module's leaves: the key
    projection's bias has a gradient of exactly zero (the softmax is blind
    to it), its rounding noise is on the scale of the kernel's gradient, and
    AdamW turns that noise into steps of the learning rate's size."""
    want = {k: v.detach().double() for k, v in want.items()}
    scale = {}
    for k, v in want.items():
        module = k.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(v.norm()))
    for k, v in want.items():
        err = float((got[k].detach().double() - v).norm())
        assert err <= rel * scale[k.rsplit(".", 1)[0]], (k, err, float(v.norm()))


def _grads(trainer):
    return {k: p.grad for k, p in trainer.model.named_parameters()}


def _counts(trainer):
    graphs = trainer.train_step.unet_graph
    return graphs.captures, graphs.replays


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_train_step_equals_the_eager_one(monkeypatch, dtype):
    """From the same state, the graphed step and the eager one give the
    same loss, every gradient (the schedule's through the input's gradient
    and K3 too) and, after 3 steps, the same parameters; K2 runs once a
    step in both."""
    graphed, eager = _graph_trainers(dtype)
    batch = _batch(4, 7)
    for k in range(3):
        before = fused_bluenoise_flat.launches
        lg = graphed.step(batch, (1, k))["loss"]
        assert fused_bluenoise_flat.launches == before + 1
        le = _eager_step(monkeypatch, eager, batch, (1, k))["loss"]
        _assert_rel(lg, le, f"loss {k}")
        if k == 0:
            _assert_tree_rel(_grads(graphed), _grads(eager))
            assert float(eager.state.sched_params.grad.abs().sum()) > 0
            _assert_rel(graphed.state.sched_params.grad, eager.state.sched_params.grad,
                        "sched_params.grad")
    _assert_tree_rel(dict(graphed.model.named_parameters()), dict(eager.model.named_parameters()))
    _assert_rel(graphed.state.sched_params, eager.state.sched_params, "sched_params")
    assert _counts(graphed) == (1, 3) and _counts(eager) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("conditional", [False, True])
def test_a_second_input_shape_captures_a_second_graph(monkeypatch, conditional):
    """A short batch between full ones (and the super-res step's 6-channel
    input) captures its own pair of graphs; each step equals the eager
    one."""
    graphed, eager = _graph_trainers(conditional=conditional)
    for k, n in enumerate((4, 2, 4)):
        batch = _batch(n, 8 + k)
        lg = graphed.step(batch, (2, k))["loss"]
        _assert_rel(lg, _eager_step(monkeypatch, eager, batch, (2, k))["loss"], f"loss {k}")
    _assert_tree_rel(dict(graphed.model.named_parameters()), dict(eager.model.named_parameters()))
    assert _counts(graphed) == (2, 3)


@pytest.mark.gpu
def test_eval_sampling_and_loads_between_graphed_steps(monkeypatch):
    """Sampling with the model in eval mode, a resume's load in place (the
    graphs kept) and a load that assigns new tensors (the graphs dropped
    and captured again) leave the next graphed step equal to the eager
    one."""
    import copy

    from bndm_tpu_torch.samplers.iadb import sample_iadb

    graphed, eager = _graph_trainers()
    batch = _batch(4, 11)
    start = copy.deepcopy(graphed.state.state_dict())
    graphed.step(batch, (3, 0))
    _eager_step(monkeypatch, eager, batch, (3, 0))
    x0 = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(12)).cuda()
    for t in (graphed, eager):
        t.model.eval()
        with torch.no_grad():
            s, _ = sample_iadb(t.model, x0, nb_steps=4, two_head=True)
        assert torch.isfinite(s).all()
        t.model.train()
        t.state.load_state_dict(copy.deepcopy(start))
    lg = graphed.step(batch, (3, 1))["loss"]
    _assert_rel(lg, _eager_step(monkeypatch, eager, batch, (3, 1))["loss"], "after the load")
    _assert_tree_rel(_grads(graphed), _grads(eager))
    assert _counts(graphed) == (1, 2)
    for t in (graphed, eager):
        t.model.load_state_dict({k: v.clone() for k, v in start["model"].items()}, assign=True)
    lg = graphed.step(batch, (3, 2))["loss"]
    _assert_rel(lg, _eager_step(monkeypatch, eager, batch, (3, 2))["loss"], "after assign")
    assert _counts(graphed) == (2, 3)


# ------------------------- P1-P3: the streaming probes -----------------------


def _edge_bf16(shape, seed):
    """bf16 N(0, 64^2) values with +-0, +-inf, values of 256 and more (where
    +1 rounds), values far below 2^-8 and subnormals at the start and end."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 64.0
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 256.0, 257.0, -256.0, 511.0,
                          -1.0, 2.0**-9, 1e-20, -1e-30, 1e-39])
    flat = x.view(-1)
    k = min(len(edges), flat.numel())
    flat[:k], flat[-k:] = edges[:k], edges[-k:]
    return x.to(torch.bfloat16).cuda()


def _assert_bits(got, x):
    from bndm_tpu_torch.ops.stream_probes import add_one_plain

    assert torch.equal(got.view(torch.int16), add_one_plain(x).view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("rows_per_block", bench_stream.ROWS_PER_BLOCK)
@pytest.mark.parametrize("schedule", bench_stream.SCHEDULES)
def test_stream_add_one_kernel_is_bitwise_plain(rows_per_block, schedule):
    """P1 (Triton) equals add_one_plain bit for bit at ragged rows and
    columns (a block's last tile cut short), with one tile a program and
    with many (the persistent grid's turns), one counted launch per call."""
    from bndm_tpu_torch.ops.stream_probes import stream_add_one

    _cuda_or_skip()
    for seed, shape in enumerate([(257, 1024), (5, 1001), (3, 13), (2048, 1024),
                                  (65536, 1024), (20001, 1001)]):
        x = _edge_bf16(shape, seed)
        before = stream_add_one.launches
        got = stream_add_one(x, rows_per_block, schedule)
        torch.cuda.synchronize()
        assert stream_add_one.launches == before + 1
        _assert_bits(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_bytes,stages", [*bench_stream.DMA_SWEEP, (16, 2), (16, 8),
                                                (49152, 3)])
def test_dma_add_one_kernel_is_bitwise_plain(chunk_bytes, stages):
    """P2 (bulk TMA + mbarriers) equals add_one_plain bit for bit: a last
    chunk shorter than the others, a tail that is not a multiple of 16
    bytes, fewer chunks than SMs, and many chunks per block (the ring
    comes round many times)."""
    from bndm_tpu_torch.ops.stream_probes import dma_add_one

    _cuda_or_skip()
    for seed, shape in enumerate([(257, 1024), (5, 1001), (3, 13), (1, 7), (4096, 1024),
                                  (65536, 1024), (20001, 1001)]):
        x = _edge_bf16(shape, seed)
        before = dma_add_one.launches
        got = dma_add_one(x, chunk_bytes, stages)
        torch.cuda.synchronize()
        assert dma_add_one.launches == before + 1
        _assert_bits(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_bytes,stages", [(8192, 4), (16384, 8)])
def test_dma_claim_counters_are_back_at_zero_after_each_launch(chunk_bytes, stages):
    """P2's blocks claim their chunks from counters that the last block of
    each launch sets back to 0: launch after launch on shapes of other
    sizes, the counters read 0 and the output stays bitwise."""
    from bndm_tpu_torch.ops import stream_probes as sp

    _cuda_or_skip()
    for seed, shape in enumerate([(4096, 1024), (3, 13), (20001, 1001), (1, 7), (257, 1024)]):
        x = _edge_bf16(shape, seed)
        for _ in range(3):
            got = sp.dma_add_one(x, chunk_bytes, stages)
        torch.cuda.synchronize()
        _assert_bits(got, x)
        assert torch.equal(sp._claims(x.device).cpu(), torch.zeros(2, dtype=torch.int64))


@pytest.mark.gpu
def test_dma_add_one_refuses_what_shared_memory_cannot_hold():
    """4 stages x 64 KiB exceeds a block's shared memory: the launch is
    refused and the wrapper raises instead of returning garbage."""
    from bndm_tpu_torch.ops.stream_probes import dma_add_one

    _cuda_or_skip()
    x = _edge_bf16((64, 1024), 0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dma_add_one(x, 65536, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 8, 8, 128), (3, 5, 7, 9), (8, 64, 64, 128)])
def test_nhwc_add_one_kernel_is_bitwise_plain(shape):
    """P3 (Triton) equals add_one_plain bit for bit, with an odd image
    count (a last block of one image) and odd H, W, C."""
    from bndm_tpu_torch.ops.stream_probes import nhwc_add_one

    _cuda_or_skip()
    x = _edge_bf16(shape, 1)
    before = nhwc_add_one.launches
    got = nhwc_add_one(x)
    torch.cuda.synchronize()
    assert nhwc_add_one.launches == before + 1
    _assert_bits(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(3, 8, 8, 128), (3, 5, 7, 9), (500, 64, 64, 128)])
def test_nhwc_add_one_sweep_is_bitwise_plain(variant, shape):
    """Every P3 variant of the sweep (tile size, warps, cache hints) equals
    add_one_plain bit for bit at the bench's full shape and at ragged ones
    (a last tile that is mostly mask)."""
    from bndm_tpu_torch.ops.stream_probes import P3_SWEEP, nhwc_add_one

    _cuda_or_skip()
    x = _edge_bf16(shape, 2)
    _assert_bits(nhwc_add_one(x, *P3_SWEEP[variant]), x)


# ---------------------- the fused adaLN unit (Triton) ------------------------


def _ulp(want):
    """The spacing of ``want``'s dtype (bf16 or float32) at each element."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - mant)


def _close_to_twin(got, want, terms):
    """``got`` within one ulp of the plain twin's ``want`` in their dtype,
    plus 1e-5 of ``terms`` (the sum of the absolute values that made each
    element): float32 sums of up to D or N terms in another order before
    the store (~sqrt(1152) x 2^-24 = 2e-6 of them)."""
    err = (got.float() - want.float()).abs()
    worst = float((err - _ulp(want) - 1e-5 * terms).max())
    assert worst <= 0, worst


def _adaln_inputs(shape, dtype, seed):
    """A unit's operands on the card: the float32 stream x and its incoming
    gradient dxs, the branch output y and dz in ``dtype``, and gate, shift
    and scale as chunks of one (B, 1, 3 D) modulation row, as the DiT cuts
    them."""
    b, n, d = shape
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*s, dt=torch.float32, std=1.0):
        return (torch.randn(s, generator=g, device="cuda") * std).to(dt)

    gate, shift, scale = randn(b, 1, 3 * d, dt=dtype, std=0.3).chunk(3, dim=2)
    return dict(x=randn(b, n, d), y=randn(b, n, d, dt=dtype), gate=gate, shift=shift,
                scale=scale, dz=randn(b, n, d, dt=dtype), dxs=randn(b, n, d))


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 256, 1152), (3, 37, 72)])
def test_adaln_kernels_match_their_plain_twins(shape, dtype, residual):
    """The fused forward and backward against the plain twins at the cell's
    width and at an odd size (D not a power of two, N not a multiple of the
    token block): every output within one ulp of its dtype plus the float32
    rounding of the sums before it (``_close_to_twin``), the statistics to
    1e-5; one counted call each; the same bits on a second call."""
    from bndm_tpu_torch.ops import adaln as A

    _cuda_or_skip()
    t = _adaln_inputs(shape, dtype, 7)
    y, gate = (t["y"], t["gate"]) if residual else (None, None)
    f0, b0 = A.adaln_forward.launches, A.adaln_backward.launches
    got = A.adaln_forward(t["x"], t["shift"], t["scale"], 1e-6, y, gate)
    gotb = A.adaln_backward(t["dz"], t["dxs"], *got[:1], *got[2:], t["scale"], y, gate)
    torch.cuda.synchronize()
    assert (A.adaln_forward.launches, A.adaln_backward.launches) == (f0 + 1, b0 + 1)
    want = A.adaln_forward_plain(t["x"], t["shift"], t["scale"], 1e-6, y, gate)
    # the backward twin on the kernel's own forward outputs, so that each
    # pass is held to its twin alone
    wantb = A.adaln_backward_plain(t["dz"], t["dxs"], got[0], got[2], got[3], t["scale"], y,
                                   gate)
    xs, z, mean, rstd = got
    _close_to_twin(xs, want[0], t["x"].abs() + (t["gate"].float() * t["y"].float()).abs()
                   if residual else 0)
    torch.testing.assert_close(mean, want[2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, want[3], rtol=1e-5, atol=1e-6)
    xhat = (xs - mean[..., None]) * rstd[..., None]
    _close_to_twin(z, want[1], xhat.abs() * (1 + t["scale"].float()).abs()
                   + t["shift"].float().abs())
    dx, dshift, dscale, dy, dgate = gotb
    dz = t["dz"].float()
    dxhat = (dz * (1 + t["scale"].float())).abs()
    terms_dx = rstd[..., None] * (dxhat + xhat.abs() * (dxhat * xhat.abs()).mean(-1, True)
                                  + dxhat.mean(-1, True)) + t["dxs"].abs()
    _close_to_twin(dx, wantb[0], terms_dx)
    _close_to_twin(dshift, wantb[1], dz.abs().sum(1, keepdim=True))
    _close_to_twin(dscale, wantb[2], (dz * xhat).abs().sum(1, keepdim=True))
    if residual:
        _close_to_twin(dy, wantb[3], t["gate"].float().abs() * terms_dx)
        _close_to_twin(dgate, wantb[4], (terms_dx * t["y"].float().abs()).sum(1, keepdim=True))
    else:
        assert dy is None and dgate is None
    again = A.adaln_forward(t["x"], t["shift"], t["scale"], 1e-6, y, gate)
    againb = A.adaln_backward(t["dz"], t["dxs"], again[0], again[2], again[3], t["scale"], y,
                              gate)
    for a, b in zip(got + gotb, again + againb):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_tiny_dit_takes_the_fused_units_on_the_card(monkeypatch, dtype):
    """A tiny DiT's forward and backward on CUDA launch each fused pass once
    a sub-layer (2 a block and the final layer's), and agree with the same
    model through the plain sequence: in float32 to float32 noise; in bf16
    within the plain sequence's own rounding."""
    from bndm_tpu_torch.models import dit as D
    from bndm_tpu_torch.ops import adaln as A

    _cuda_or_skip()
    cfg = D.dit_config("tiny", input_size=8, dtype=dtype)
    torch.manual_seed(0)
    m = D.DiT(cfg, device="cuda")
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.1)
    x = torch.randn(3, 4, 8, 8, device="cuda")
    t = torch.rand(3, device="cuda")
    params = list(m.parameters())

    def run():
        out = m(x, t)
        return out.detach(), torch.autograd.grad(out.square().sum(), params)

    f0, b0 = A.adaln_forward.launches, A.adaln_backward.launches
    out, grads = run()
    torch.cuda.synchronize()
    units = 2 * cfg.depth + 1
    assert (A.adaln_forward.launches - f0, A.adaln_backward.launches - b0) == (units, units)
    monkeypatch.setattr(D, "fuses_adaln", lambda h: False)
    ref, ref_grads = run()
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert float((out - ref).norm() / ref.norm()) < tol
    num = torch.stack([(a - b).norm() for a, b in zip(grads, ref_grads)]).norm()
    assert float(num / torch.stack([b.norm() for b in ref_grads]).norm()) < tol
