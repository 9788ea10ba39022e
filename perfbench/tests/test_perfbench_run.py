"""Runs of every cell at a tiny size on the CPU, past the harness's look for
a card: the result's keys, a sound run judged correct, and each fault a
cell can have, planted in the program underneath, judged not correct."""

import time

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny

torch.set_num_threads(1)
SEED = 2**31 + 4321
CELLS = ["cat64_bndm.train", "celeba256_latent.train", "celeba256_latent.sample"]


def _run(cell, trace=0):
    config, traffic = tiny(cell)
    return run.run_cell(cell, SEED, 0.3, trace, device="cpu", config=config, traffic=traffic,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys_and_a_sound_run(cell, trace):
    result, checks = _run(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"]
    assert result["correct"] and checks.correct and result["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    import bndm_tpu_torch.train.latent as latent
    import bndm_tpu_torch.train.pixel as pixel

    def half(loss):
        def f(d, x1, x0, bn, wn, a, ap, g, gp, two):
            h = d.shape[0] // 2
            return 2.0 * loss(d[:h], x1[:h], x0[:h], bn[:h], wn[:h], a[:h], ap[:h], g[:h],
                              gp[:h], two)
        return f

    monkeypatch.setattr(pixel, "bndm_loss", half(pixel.bndm_loss))
    monkeypatch.setattr(latent, "bndm_loss", half(latent.bndm_loss))


def _doubled_update(monkeypatch):
    step = torch.optim.AdamW.step

    def doubled(self, closure=None):
        p = self.param_groups[0]["params"][0]
        before = p.detach().clone()
        out = step(self, closure)
        with torch.no_grad():
            p.add_(p - before)
        return out

    monkeypatch.setattr(torch.optim.AdamW, "step", doubled)


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _doubled_update])
def test_train_faults_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = _run(cell)
    assert result["correct"] is False


def _sampler_step_skipped(monkeypatch):
    import bndm_tpu_torch.samplers.iadb as iadb

    monkeypatch.setattr(iadb, "iadb_step", lambda x, d, *a, **k: x)


def _half_batch_denoised(monkeypatch):
    from bndm_tpu_torch.models.unet2d import UNet2D

    forward = UNet2D.forward

    def half(self, x, t, *a, **k):
        h = x.shape[0] // 2
        d = forward(self, x[:h], t[:h], *a, **k)
        return torch.cat([d, d])[:x.shape[0]]

    monkeypatch.setattr(UNet2D, "forward", half)


def _image_altered(monkeypatch):
    from bndm_tpu_torch.models.vae import AutoencoderKL

    decode = AutoencoderKL.decode

    def altered(self, z):
        out = decode(self, z).clone()
        out[0] += 0.2
        return out

    monkeypatch.setattr(AutoencoderKL, "decode", altered)


@pytest.mark.parametrize("fault", [_sampler_step_skipped, _half_batch_denoised, _image_altered])
def test_sample_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, _ = _run("celeba256_latent.sample")
    assert result["correct"] is False
