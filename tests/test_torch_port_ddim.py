"""The port's DDIM baseline against the JAX package, on the CPU.

The scheduler (tables, timesteps, ``step`` for the three prediction types
with and without the clip, ``add_noise``), ``ddim_loss``, the train step's
loss and gradients on injected noise and t, ``sample_ddim`` plain and
cached on the tiny UNet, ``calibrate_sampling_ddim``, the DDIM serving
sampler on JAX's calibration batch, the UNet's dropout on injected masks,
and an exact resume of the HF train state. Weights are made with numpy at
the flax shapes and carried across; JAX runs at fp32 matmul precision.

Tolerances: 1e-6 for the scheduler's arithmetic; 1e-5 relative for losses;
1e-4 of each module's largest gradient; 5e-4 for forwards and sampled
chains in fp32 (the ROADMAP's parity rules); calibrated activation scales
1e-5 relative, GN tables 5e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu import serving as JS
from bndm_tpu.models import unet2d as J
from bndm_tpu.models.convert import ddim_scheduler_config
from bndm_tpu.ops import int8 as JI
from bndm_tpu.samplers import ddim as JD
from bndm_tpu.train import ddim as JT
from bndm_tpu.train import losses as JL
from bndm_tpu_torch import serving as TS
from bndm_tpu_torch.ckpt.manager import CheckpointManager
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import (collection_from_flax, flax_from_state_dict,
                                           state_dict_from_flax)
from bndm_tpu_torch.ops import int8 as TI
from bndm_tpu_torch.samplers import ddim as TD
from bndm_tpu_torch.train import ddim as TT
from bndm_tpu_torch.train import losses as TL
from bndm_tpu_torch.train.schedules_lr import HFAdamW
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_train import PLAIN, _assert_tree_close
from test_torch_port_unet import TINY, random_flax_params

FWD = dict(rtol=5e-4, atol=5e-4)
N_INF = 10


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(kw=TINY, seed=0, **cfg):
    """A tiny JAX UNet (3 -> 3) with seeded numpy params and the port's UNet
    on the same weights."""
    jm = J.UNet2D(J.UNet2DConfig(**kw, **cfg))
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 16, 16)), jnp.zeros(1),
                                               seed=seed))
    tm = P.UNet2D(P.UNet2DConfig(**kw, **cfg))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm


# --------------------------------- scheduler ---------------------------------


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_scheduler_tables_and_timesteps_match_jax(beta_schedule, spacing):
    kw = dict(beta_schedule=beta_schedule, timestep_spacing=spacing)
    js, ts = JD.DDIMScheduler(**kw), TD.DDIMScheduler(**kw)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=1e-6, atol=0)
    for n in (250, 10, 7):
        got = ts.set_timesteps(n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(js.set_timesteps(n)))


def test_scheduler_from_config_matches_jax():
    cfg = ddim_scheduler_config(500, "squaredcos_cap_v2", "sample", steps_offset=1)
    js, ts = JD.DDIMScheduler.from_config(cfg), TD.DDIMScheduler.from_config(cfg)
    for name in ("num_train_timesteps", "prediction_type", "clip_sample", "steps_offset"):
        assert getattr(ts, name) == getattr(js, name)
    np.testing.assert_array_equal(ts.set_timesteps(50).numpy(), np.asarray(js.set_timesteps(50)))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_step_and_add_noise_match_jax(prediction_type, clip):
    """``step`` at t = 900 (and the last step, whose previous t < 0 takes
    the final alpha), with the eps recomputed from the clipped x0; and
    ``add_noise`` on per-sample int64 timesteps: to 1e-6 of the values'
    scale."""
    kw = dict(prediction_type=prediction_type, clip_sample=clip)
    js, ts = JD.DDIMScheduler(**kw), TD.DDIMScheduler(**kw)
    js.set_timesteps(N_INF)
    ts.set_timesteps(N_INF)
    sample, out = _x((2, 3, 8, 8), 1), _x((2, 3, 8, 8), 2)
    for t in (900, 400, 0):
        want = np.asarray(js.step(jnp.asarray(out), t, jnp.asarray(sample)))
        got = ts.step(torch.from_numpy(out), torch.tensor(t), torch.from_numpy(sample)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    t = np.array([0, 999], np.int64)
    want = np.asarray(js.add_noise(jnp.asarray(sample), jnp.asarray(out), jnp.asarray(t)))
    got = ts.add_noise(torch.from_numpy(sample), torch.from_numpy(out), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
def test_ddim_loss_matches_jax(prediction_type):
    d, noise, clean = _x((3, 3, 8, 8), 3), _x((3, 3, 8, 8), 4), _x((3, 3, 8, 8), 5)
    t = np.array([3, 500, 990], np.int64)
    acp = JD.DDIMScheduler().alphas_cumprod
    want = JL.ddim_loss(*map(jnp.asarray, (d, noise, clean, t)), acp, prediction_type)
    got = TL.ddim_loss(*map(torch.from_numpy, (d, noise, clean, t)),
                       TD.DDIMScheduler().alphas_cumprod, prediction_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# -------------------------------- train step ---------------------------------


def test_train_step_loss_and_grads_match_jax():
    """The DDIM step's loss (1e-5 relative) and every gradient (1e-4 of its
    module's largest) on the same weights, t and noise (JAX's draw from the
    step's noise key, fed to the port); the SNR-weighted sample loss is held
    by test_ddim_loss_matches_jax."""
    jm, params, tm = _pair(PLAIN, seed=7)
    cfg = dict(prediction_type="epsilon")
    jstep, _ = JT.make_ddim_train_step(jm.apply, JT.DDIMTrainConfig(**cfg), None)
    clean = np.random.default_rng(8).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    t, key = np.array([17, 981], np.int32), jax.random.PRNGKey(9)
    with jax.default_matmul_precision("float32"):
        loss, grads = jax.jit(jax.value_and_grad(jstep.loss_fn))(
            params, jnp.asarray(clean), jnp.asarray(t), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, clean.shape, jnp.float32)))
    tstep, _ = TT.make_ddim_train_step(TT.DDIMTrainConfig(**cfg), None)
    got = tstep.loss_fn(tm, torch.from_numpy(clean), torch.from_numpy(t).long(), noise)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    _assert_tree_close(flax_from_state_dict({k: p.grad for k, p in tm.named_parameters()}),
                       jax.device_get(grads), 1e-4)


def test_resume_restores_the_whole_state(tmp_path):
    """Three DDIM steps with EMA and 2-step accumulation, straight or cut
    after the first by a checkpoint restored into a fresh state: the same
    weights, EMA, moments, accumulation buffer and counts, bit for bit."""
    cfg = TT.DDIMTrainConfig(use_ema=True)

    def make_opt(params):
        return HFAdamW(params, lr=1e-3, betas=(0.95, 0.999), eps=1e-8, weight_decay=1e-6,
                       schedule=lambda n: 1e-3 * min(1.0, (n + 1) / 2), accum=2)

    step, init = TT.make_ddim_train_step(cfg, make_opt)
    batches = [torch.from_numpy(np.random.default_rng(10 + i).uniform(0, 1, (2, 3, 16, 16))
                                .astype(np.float32)) for i in range(3)]

    def fresh():
        torch.manual_seed(11)
        return init(P.UNet2D(P.UNet2DConfig(**PLAIN)).train())

    straight = fresh()
    for i, b in enumerate(batches):
        step(straight, b, (0, i))
    cut = fresh()
    step(cut, batches[0], (0, 0))
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, cut)
    resumed = fresh()
    assert mgr.restore(resumed).step == 1
    for i in (1, 2):
        step(resumed, batches[i], (0, i))
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 3 and a["opt"]["count"] == b["opt"]["count"] == 1
    assert a["opt"]["mini_step"] == b["opt"]["mini_step"] == 1
    flat = [(a["model"], b["model"]), (a["ema"]["params"], b["ema"]["params"])]
    for x, y in flat:
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(u, v) for u, v in zip(a["opt"]["acc"], b["opt"]["acc"]))
    assert all(torch.equal(u["exp_avg"], v["exp_avg"])
               for u, v in zip(a["opt"]["adamw"]["state"].values(),
                               b["opt"]["adamw"]["state"].values()))


# --------------------------------- dropout -----------------------------------


def test_dropout_in_train_mode_matches_jax(monkeypatch):
    """``dropout`` > 0: in eval mode the forward is JAX's deterministic one;
    in train mode it is JAX's with deterministic=False on the same masks
    (each dropout site, in call order, takes the next mask of a seeded
    stream on both sides)."""
    jm, params, tm = _pair(PLAIN, seed=12, dropout=0.3)
    x, t = _x((2, 3, 16, 16), 13), np.array([0.2, 0.7], np.float32)

    def masks():
        rng = np.random.default_rng(14)
        return lambda shape: (rng.uniform(size=shape) >= 0.3).astype(np.float32)

    draw = masks()
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, h, deterministic=None, rng=None:
                        h if deterministic else h * jnp.asarray(draw(h.shape)) / 0.7)
    with jax.default_matmul_precision("float32"):  # one trace each: a mask per site
        want_eval = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
        want_train = np.asarray(jax.jit(lambda *a: jm.apply(*a, deterministic=False))(
            params, jnp.asarray(x), jnp.asarray(t)))
    draw_nhwc = masks()
    # the port is NCHW: the same mask values, drawn NHWC and transposed
    monkeypatch.setattr(torch.nn.Dropout, "forward", lambda self, h: h if not self.training
                        else h * torch.from_numpy(draw_nhwc(tuple(h.permute(0, 2, 3, 1).shape)))
                        .permute(0, 3, 1, 2) / 0.7)
    with torch.no_grad():
        got_eval = tm.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        got_train = tm.train()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got_eval, want_eval, **FWD)
    np.testing.assert_allclose(got_train, want_train, **FWD)
    assert np.abs(want_train - want_eval).max() > 1e-2  # the masks reached the output


# --------------------------------- samplers ----------------------------------


@pytest.mark.parametrize("cached", [False, True])
def test_sample_ddim_matches_jax(cached):
    """``sample_ddim`` with its frames, and ``sample_ddim_cached`` at
    interval 3 (three groups and a trailing one), on the tiny UNet: 5e-4."""
    jm, params, tm = _pair(seed=15)
    tm.eval()
    x0 = _x((2, 3, 16, 16), 16)
    js, ts = JD.DDIMScheduler(), TD.DDIMScheduler()
    with jax.default_matmul_precision("float32"):
        if cached:
            want = JD.sample_ddim_cached(
                lambda p, x, t: jm.apply(p, x, t, return_deep=True),
                lambda p, x, t, deep: jm.apply(p, x, t, deep_feature=deep), params,
                jnp.asarray(x0), scheduler=js, num_inference_steps=N_INF, cache_interval=3)
        else:
            want, want_frames = JD.sample_ddim(jm.apply, params, jnp.asarray(x0), scheduler=js,
                                               num_inference_steps=N_INF, collect_frames=True)
    if cached:
        got = TD.sample_ddim_cached(lambda x, t: tm(x, t, return_deep=True),
                                    lambda x, t, deep: tm(x, t, deep_feature=deep),
                                    torch.from_numpy(x0), scheduler=ts,
                                    num_inference_steps=N_INF, cache_interval=3)
    else:
        got, frames = TD.sample_ddim(tm, torch.from_numpy(x0), scheduler=ts,
                                     num_inference_steps=N_INF, collect_frames=True)
        assert frames.shape == (N_INF + 1, 1, 3, 16, 16)
        np.testing.assert_allclose(frames.numpy(), np.asarray(want_frames), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


CAL_KW = dict(conv_int8=True, int8_mode="calibrate", gn_mode="calibrate", gn_steps=N_INF)


def test_calibrate_sampling_ddim_matches_jax():
    """One calibration trajectory on each side from the same x: the int8
    activation scales to 1e-5 relative, the GN tables (keyed on the scan
    position) to 5e-4."""
    jm, params, _ = _pair(PLAIN, seed=17)
    tm = TS.build_model(P.UNet2DConfig(**PLAIN, **CAL_KW), state_dict_from_flax(params), "cpu")
    x = _x((2, 3, 16, 16), 18)
    with jax.default_matmul_precision("float32"):
        jq = JI.calibrate_sampling_ddim(J.UNet2D(J.UNet2DConfig(**PLAIN, **CAL_KW)), params,
                                        jnp.asarray(x), JD.DDIMScheduler(), N_INF)
    jq = collection_from_flax(jax.device_get(jq))
    tq = TI.calibrate_sampling_ddim(tm, torch.from_numpy(x), TD.DDIMScheduler(), N_INF)
    assert sorted(tq) == sorted(jq) and any(k.endswith(".gn_mean") for k in tq)
    for key in tq:
        rtol, atol = (1e-5, 0) if key.endswith(".act_amax") else (5e-4, 5e-4)
        np.testing.assert_allclose(tq[key].numpy(), jq[key].numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def test_serving_sampler_ddim_matches_jax(monkeypatch):
    """``make_serving_sampler_ddim`` with static GN (smoothed over 3 steps)
    and the cached chain at interval 2, fed JAX's calibration batch: the
    same samples as JAX's to 5e-4."""
    jm, params, _ = _pair(PLAIN, seed=19)
    sd = state_dict_from_flax(params)
    x0, key = _x((2, 3, 16, 16), 20), jax.random.PRNGKey(21)
    kw = dict(conv_int8=False, static_gn=True, gn_smooth_window=3, cache_interval=2)
    with jax.default_matmul_precision("float32"):
        want = JS.make_serving_sampler_ddim(J.UNet2DConfig(**PLAIN), params, JD.DDIMScheduler(),
                                            N_INF, key=key, **kw)(jnp.asarray(x0))
    x_cal = torch.from_numpy(np.array(jax.random.normal(key, x0.shape, jnp.float32)))
    real = TS.calibrate_sampling_ddim
    monkeypatch.setattr(TS, "calibrate_sampling_ddim",
                        lambda m, x, *a: real(m, x_cal.to(x.device), *a))
    got = TS.make_serving_sampler_ddim(P.UNet2DConfig(**PLAIN), sd, TD.DDIMScheduler(), N_INF,
                                       device="cpu", **kw)(torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
