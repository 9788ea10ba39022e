"""The cached sampling cell on the CPU at a tiny size: the reference outer
shell against the reference UNet and the program's shell, a sound run
judged correct with its shell share and FLOPs, and each fault the cell can
have, planted in the program underneath, judged not correct."""

import time

import pytest
import torch

from perfbench import flops, run, weights
from perfbench.drivers import sample_latent_cached as cached
from perfbench.reference import nets
from perfbench.tests.tiny import TINY_UNET, tiny

torch.set_num_threads(1)
CELL = "celeba256_latent.sample_cached"
SEED = 2**31 + 4321
# three levels, so that the shell can leave one or two of them to the trunk
UNET = dict(TINY_UNET, block_out_channels=[8, 16, 16],
            down_block_types=["DownBlock2D", "DownBlock2D", "AttnDownBlock2D"],
            up_block_types=["AttnUpBlock2D", "UpBlock2D", "UpBlock2D"], in_channels=4,
            out_channels=8, layers_per_block=2, norm_eps=1e-5)


def _inputs(res=16):
    gen = torch.Generator().manual_seed(3)
    return torch.randn(2, 4, res, res, generator=gen), torch.tensor([0.3, 0.9])


@pytest.mark.parametrize("depth", [1, 2])
def test_the_shell_given_its_own_trunk_is_the_full_forward(depth):
    P = weights.make(nets.unet_spec(UNET), 5, "cpu")
    x, t = _inputs()
    with torch.no_grad():
        full = nets.unet(P, UNET, x, t)
        out, deep = nets.unet(P, UNET, x, t, depth=depth)
        shell = nets.unet_shell(P, UNET, x, t, deep, depth)
    assert torch.equal(out, full)
    assert float((shell - full).abs().max() / full.abs().max()) < 1e-6


@pytest.mark.parametrize("depth", [1, 2])
def test_the_shell_matches_the_program(depth):
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig

    P = weights.make(nets.unet_spec(UNET), 6, "cpu")
    m = UNet2D(UNet2DConfig(cache_depth=depth, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in UNET.items() if k != "norm_eps"}))
    m.load_state_dict(P, strict=True)
    x, t = _inputs()
    with torch.no_grad():
        _, stale = m(x, torch.tensor([0.5, 0.6]), return_deep=True)
        _, deep = m(x, t, return_deep=True)
        _, ref_deep = nets.unet(P, UNET, x, t, depth=depth)
        got = m(x, t, deep_feature=stale)
        ref = nets.unet_shell(P, UNET, x, t, stale, depth)
    assert float((deep - ref_deep).abs().max() / ref_deep.abs().max()) < 1e-5
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_picks_keep_each_group_start():
    keep = cached.picks(SEED, 250, 6, 8)
    assert {0, 249} <= set(keep)
    assert all(i - i % 8 in keep for i in keep)


def _run(trace=0):
    config, traffic = tiny(CELL)
    ctx, driver = run.make_ctx(CELL, SEED, 0.3, trace, "cpu", config, traffic,
                               time.perf_counter())
    return ctx, driver.run(ctx)


def test_a_sound_run_counts_its_shell_share_and_flops():
    ctx, out = _run()
    rec, tr = out["record"], ctx.traffic
    n, steps, every = rec["batches"], tr["steps"], tr["cache_interval"]
    full = len(range(0, steps, every))
    assert out["checks"].correct
    assert (rec["full_calls"], rec["shallow_calls"]) == (n * full, n * (steps - full))
    assert run.read_metric("cached_shallow_pct.sample", {"run": rec}) == pytest.approx(
        100.0 * (steps - full) / steps)
    unet_cfg, bs, res = ctx.config["unet"], tr["batch_size"], ctx.config["unet"]["sample_size"]
    shell = flops.unet_shell_forward(unet_cfg, bs, res, tr["cache_depth"])
    assert 0 < shell < flops.unet_forward(unet_cfg, bs, res)
    assert rec["flops_per_batch"] == (full * flops.unet_forward(unet_cfg, bs, res)
                                      + (steps - full) * shell
                                      + flops.vae_decode(ctx.config["vae"], bs, res))


def test_the_cells_shell_share_and_flops_at_its_size():
    config, traffic = run.cell_files(run.load_bench(), CELL)[1:]
    cfg, bs, depth = config["unet"], traffic["batch_size"], traffic["cache_depth"]
    full = len(range(0, traffic["steps"], traffic["cache_interval"]))
    assert (full, traffic["steps"] - full) == (32, 218)
    assert flops.unet_forward(cfg, bs, 32) == 5770969088000
    assert flops.unet_shell_forward(cfg, bs, 32, depth) == 2246180864000


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys_and_metrics(trace):
    config, traffic = tiny(CELL)
    result, checks = run.run_cell(CELL, SEED, 0.3, trace, device="cpu", config=config,
                                  traffic=traffic, t_start=time.perf_counter())
    assert result["correct"] and checks.correct
    assert set(result["checks"]) == {"start_gap", "unet_gap", "shallow_gap", "update_gap",
                                     "decode_gap"}
    want = ({"sample_mfu_pct", "sampler_step_ms", "vae_decode_ms", "cached_shallow_pct.sample"}
            if trace else {"sample_images_per_s", "setup_s"})
    assert set(result["metrics"]) == want


def _sampler_step_skipped(monkeypatch):
    import bndm_tpu_torch.samplers.iadb as iadb

    monkeypatch.setattr(iadb, "iadb_step", lambda x, d, *a, **k: x)


def _half_batch_denoised(monkeypatch):
    from bndm_tpu_torch.models.unet2d import UNet2D

    forward = UNet2D.forward

    def half(self, x, t, *a, deep_feature=None, **k):
        h = x.shape[0] // 2
        deep = None if deep_feature is None else deep_feature[:h]
        out = forward(self, x[:h], t[:h], *a, deep_feature=deep, **k)
        pair = out if isinstance(out, tuple) else (out,)
        whole = tuple(torch.cat([v, v])[:x.shape[0]] for v in pair)
        return whole if isinstance(out, tuple) else whole[0]

    monkeypatch.setattr(UNet2D, "forward", half)


def _trunk_dropped(monkeypatch):
    from bndm_tpu_torch.models.unet2d import UNet2D

    forward = UNet2D.forward

    def dropped(self, x, t, *a, deep_feature=None, **k):
        if deep_feature is not None:
            deep_feature = torch.zeros_like(deep_feature)
        return forward(self, x, t, *a, deep_feature=deep_feature, **k)

    monkeypatch.setattr(UNet2D, "forward", dropped)


def _image_altered(monkeypatch):
    from bndm_tpu_torch.models.vae import AutoencoderKL

    decode = AutoencoderKL.decode

    def altered(self, z):
        out = decode(self, z).clone()
        out[0] += 0.2
        return out

    monkeypatch.setattr(AutoencoderKL, "decode", altered)


@pytest.mark.parametrize("fault", [_sampler_step_skipped, _half_batch_denoised, _trunk_dropped,
                                   _image_altered])
def test_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, out = _run()
    assert out["checks"].correct is False
