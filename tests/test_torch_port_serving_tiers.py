"""The port's serving tiers against the JAX package, piece by piece.

``ops/int8.py`` (the quantizer, the int32 products, the STE and a QAT
step), ``ops/static_norm.py`` (record / reuse GroupNorm, table smoothing,
the drift correction, the step index), the carry of the ``gnstats``
collection, and ``serving.py``'s argument checks, model pair and validated
ladder. The calibrated tables and the tier samplers are held in
``test_torch_port_serving_calibrated.py``, the CLI's tier flags in
``test_torch_port_serving_cli.py``; both take their helpers from here.
Weights and inputs are made once by JAX and carried across; JAX runs at
fp32 matmul precision.

Tolerances: exact where the arithmetic is (the quantizer's integers and the
int32 sums on equal operands, the table transforms to 1e-6); 5e-4 for
forwards in fp32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu import serving as JS
from bndm_tpu.models import unet2d as J
from bndm_tpu.ops import int8 as JI
from bndm_tpu.ops import static_norm as JN
from bndm_tpu_torch import serving as TS
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import collection_from_flax, state_dict_from_flax
from bndm_tpu_torch.ops import int8 as TI
from bndm_tpu_torch.ops import static_norm as TN
from bndm_tpu_torch.samplers.iadb import _coefficients
from test_torch_port_unet import TINY, random_flax_params

FWD = dict(rtol=5e-4, atol=5e-4)
EXACT = dict(rtol=0, atol=1e-6)
NB = 6
SCHED = dict(scheduler_gamma="sigmoid", gamma_params=(1000.0, 0.0, 3.0), two_head=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is fastest, and a pool
    per test worker would oversubscribe the cores the workers share."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _jcfg(**kw):
    return J.UNet2DConfig(**TINY, out_channels=6, **kw)


def _tcfg(**kw):
    return P.UNet2DConfig(**TINY, out_channels=6, **kw)


def _tmodel(sd, **kw):
    return TS.build_model(_tcfg(**kw), sd, "cpu")


@pytest.fixture(scope="module")
def weights():
    """The tiny two-head UNet's weights: the flax tree and its state_dict."""
    jm = J.UNet2D(_jcfg())
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 16, 16)), jnp.zeros(1),
                                               seed=11))
    return params, state_dict_from_flax(params)


# ------------------------------ the int8 product -----------------------------


def test_quantize_symmetric_matches_jax():
    """q exactly (half to even included), the scales to 1e-7 relative:
    per sample for activations, per output channel for weights."""
    x = _x((4, 8, 6, 6), 0) * np.array([1.0, 1e-3, 30.0, 1.0], np.float32)[:, None, None, None]
    x[3] = 0.0
    x[3, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: three ties
    q, s = TI.quantize_symmetric(torch.from_numpy(x), dims=(1, 2, 3))
    jq, js = JI.quantize_symmetric(_nhwc(x), axes=(1, 2, 3))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), _nchw(jq))
    assert q[3, 0, 0, :4].tolist() == [127, 0, 2, -2]
    np.testing.assert_allclose(s.numpy().ravel(), np.asarray(js).ravel(), rtol=1e-7, atol=0)
    w = _x((16, 8, 3, 3), 1)
    q, s = TI.quantize_symmetric(torch.from_numpy(w), dims=(1, 2, 3))
    jq, js = JI.quantize_symmetric(jnp.asarray(np.transpose(w, (2, 3, 1, 0))), axes=(0, 1, 2))
    assert np.array_equal(q.numpy(), np.transpose(np.asarray(jq), (3, 2, 0, 1)))
    np.testing.assert_allclose(s.numpy().ravel(), np.asarray(js).ravel(), rtol=1e-7, atol=0)


@pytest.mark.parametrize("c,o,k,stride,pad,b,h", [
    (16, 24, 3, 1, 1, 2, 8),     # a 3x3 site
    (16, 16, 3, 2, 1, 2, 8),     # the downsampler
    (16, 32, 1, 1, 0, 1, 4),     # the shortcut (1x1)
    (3, 8, 3, 1, 1, 1, 4),       # conv_in: K = 27, padded to 32
    (512, 512, 3, 1, 1, 1, 4)])  # the innermost level at batch 1: 16 rows, padded
def test_int8_accumulators_are_exact(c, o, k, stride, pad, b, h):
    """The int32 sums of the port's im2col product equal XLA's int8 conv's
    on the same int8 operands, exactly (the 512-channel case reaches
    1.3e6: no fp32 product of the integers could be held to that)."""
    rng = np.random.default_rng(c + o + k)
    xq = rng.integers(-127, 128, (b, c, h, h)).astype(np.int8)
    wq = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        _nhwc(xq), jnp.asarray(np.transpose(wq, (2, 3, 1, 0))), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = TI.int8_conv_accum(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _nchw(want))


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_and_its_ste_gradient_match_jax(stride):
    """The dynamic W8A8 conv's output (to 1e-6: the same integers, the same
    fp32 dequantization) and its straight-through gradients, the exact fp32
    conv's, to 1e-5."""
    x, w, g = _x((2, 16, 8, 8), 2), _x((24, 16, 3, 3), 3, 0.1), _x((2, 24, 8 // stride,
                                                                  8 // stride), 4)

    def jf(xx, ww):
        y = JI.int8_conv(xx, ww, (stride, stride), ((1, 1), (1, 1)))
        return jnp.sum(y * _nhwc(g)), y

    with jax.default_matmul_precision("float32"):
        (_, jy), (jgx, jgw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
            _nhwc(x), jnp.asarray(np.transpose(w, (2, 3, 1, 0))))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = TI.int8_conv(tx, tw, stride, 1)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _nchw(jy), **EXACT)
    np.testing.assert_allclose(tx.grad.numpy(), _nchw(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.transpose(np.asarray(jgw), (3, 2, 0, 1)),
                               rtol=1e-5, atol=1e-5)


def test_qat_train_step_runs_through_the_ste(small_L):
    """A train step of a conv_int8 model (dynamic int8 convs, the STE's
    backward) moves the int8 sites' weights and gives a finite loss."""
    from bndm_tpu_torch.train import pixel as tp

    cfg = tp.TrainConfig(nb_steps=NB, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), out_channel=6)
    torch.manual_seed(0)
    model = P.UNet2D(_tcfg(conv_int8=True))
    before = model.down_blocks[0].resnets[0].conv1.weight.detach().clone()
    tr = tp.PixelTrainer(model, cfg, small_L)
    m = tr.step(torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 3, 64, 64))
                                 .astype(np.float32)), (0, 0))
    assert math.isfinite(m["loss"].item())
    assert not torch.equal(model.down_blocks[0].resnets[0].conv1.weight, before)


# ------------------------- GroupNorm statistics and tables -------------------


def test_record_reuse_on_jax_gnstats(weights):
    """record: the per-sample (B, G) statistics against JAX's gnstats
    (1e-5: E[x^2] - mu^2 in fp32 on both sides); reuse on JAX's gnstats and
    JAX's trunk feature: the shallow forward to 5e-4."""
    params, sd = weights
    x, t = _x((2, 3, 16, 16), 9), np.array([0.5, 0.5], np.float32)
    x2, t2 = _x((2, 3, 16, 16), 10), np.array([0.4, 0.4], np.float32)
    rec_j, reu_j = J.UNet2D(_jcfg(gn_mode="record")), J.UNet2D(_jcfg(gn_mode="reuse"))

    @jax.jit
    def record_then_reuse(params, x, t, x2, t2):
        (out, deep), gv = rec_j.apply(params, x, t, return_deep=True, mutable=["gnstats"])
        reuse = reu_j.apply({"params": params["params"], "gnstats": gv["gnstats"]}, x2, t2,
                            deep_feature=deep)
        return out, deep, gv, reuse

    with jax.default_matmul_precision("float32"):
        j_out, j_deep, gv, j_reuse = record_then_reuse(
            params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(x2), jnp.asarray(t2))
    jstats = collection_from_flax(jax.device_get(gv["gnstats"]))
    rec, reu = _tmodel(sd, gn_mode="record"), _tmodel(sd, gn_mode="reuse")
    with torch.no_grad():
        out, _ = rec(torch.from_numpy(x), torch.from_numpy(t), return_deep=True)
        stats = rec.gnstats()
        with pytest.raises(ValueError, match="mode='record'"):
            reu(torch.from_numpy(x2), torch.from_numpy(t2))
        got = reu.load_gnstats(jstats)(torch.from_numpy(x2), torch.from_numpy(t2),
                                        deep_feature=torch.from_numpy(_nchw(j_deep)))
    assert sorted(stats) == sorted(jstats)
    for key in stats:
        np.testing.assert_allclose(stats[key].numpy(), jstats[key].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_reuse), **FWD)


def test_gn_table_transforms_match_jax():
    """smooth_gn_tables (windows 1, 3, 4) and drift_correct_gnstats (a site
    without tables passes through; indices past the tables clip), to 1e-6."""
    T, G, B = 7, 4, 3
    quant = {"down_blocks_0": {"resnets_0": {
        "norm1": {"gn_mean": _x((T, G), 11), "gn_var": np.abs(_x((T, G), 12)) + 0.1},
        "conv1": {"act_amax": np.float32(3.0)}}}}
    stats = {"down_blocks_0": {"resnets_0": {"norm1": {"mu": _x((B, G), 13),
                                                       "rstd": np.abs(_x((B, G), 14))}}},
             "conv_norm_out": {"mu": _x((B, G), 15), "rstd": np.abs(_x((B, G), 16))}}
    for window in (1, 3, 4):
        want = collection_from_flax(JN.smooth_gn_tables(quant, window))
        got = TN.smooth_gn_tables(collection_from_flax(quant), window)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **EXACT)
    tq = collection_from_flax(quant)
    for cur, ref in ((5, 2), (0, 6), (9, -3)):
        want = collection_from_flax(jax.device_get(JN.drift_correct_gnstats(
            stats, quant, jnp.int32(cur), jnp.int32(ref))))
        got = TN.drift_correct_gnstats(collection_from_flax(stats), tq, torch.tensor(cur), ref)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **EXACT)


@pytest.mark.parametrize("nb_steps", [7, 250])
def test_gn_step_index_at_every_step(nb_steps):
    """round(alpha * T) - 1 in fp32 gives t at every step of the chain, as
    JAX's formula does on the same alpha."""
    a_now, _, _ = _coefficients(nb_steps, "linear", 0.02, "linear", (1.0, 0.0, 3.0))
    got = [int(TN.gn_step_index(torch.tensor([a]), nb_steps)) for a in a_now]
    want = np.asarray(jnp.round(jnp.asarray(a_now, jnp.float32) * nb_steps)
                      .astype(jnp.int32) - 1).tolist()
    assert got == want == list(range(nb_steps - 1, -1, -1))


# ------------------------------ the serving API ------------------------------


@pytest.mark.parametrize("kw", [
    dict(static_gn=True, scheduler_alpha="cosine"),
    dict(x_c="yes", microbatch=2),
    dict(gn_carry="bogus"),
    dict(gn_carry=True, static_gn=True, cache_interval=2),
    dict(gn_carry=True, static_gn=False),
    dict(gn_carry="drift", static_gn=False, cache_interval=2, scheduler_alpha="cosine")])
def test_serving_sampler_checks_match_jax(weights, kw):
    params, sd = weights
    jkw, tkw = dict(kw), dict(kw)
    if "x_c" in kw:
        jkw["x_c"], tkw["x_c"] = jnp.zeros((2, 3, 16, 16)), torch.zeros(2, 3, 16, 16)
    with pytest.raises(ValueError) as j_err:
        JS.make_serving_sampler(_jcfg(), params, NB, **jkw)
    with pytest.raises(ValueError) as t_err:
        TS.make_serving_sampler(_tcfg(), sd, NB, device="cpu", **tkw)
    assert str(t_err.value) == str(j_err.value)


def test_serving_model_pair_and_microbatch_checks(weights):
    params, sd = weights
    with pytest.raises(ValueError, match="static_gn requires gn_steps"):
        JS.serving_model_pair(_jcfg(), static_gn=True)
    with pytest.raises(ValueError, match="static_gn requires gn_steps"):
        TS.serving_model_pair(_tcfg(), sd, device="cpu", static_gn=True)
    m_cal, m = TS.serving_model_pair(_tcfg(), sd, device="cpu", conv_int8=True,
                                     int8_static=True, relax_kw={"attn_softmax_dtype":
                                                                 "bfloat16"})
    assert (m_cal.cfg.int8_mode, m_cal.cfg.attn_softmax_dtype) == ("calibrate", "float32")
    assert (m.cfg.int8_mode, m.cfg.attn_softmax_dtype) == ("static", "bfloat16")
    sample = TS.make_serving_sampler(_tcfg(), sd, 2, device="cpu", conv_int8=False,
                                     static_gn=False, microbatch=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by microbatch 2"):
        sample(torch.zeros(3, 3, 16, 16))


def test_validated_ladder_trivial_and_impossible_gates(weights):
    """A gate every tier passes serves the ladder's first tier; a gate none
    can pass falls back to the plain path, whose samples it then serves."""
    _, sd = weights
    kw = dict(device="cpu", probe_batch=2, verbose=False, **SCHED)
    _, report = TS.make_validated_serving_sampler(_tcfg(), sd, 3, 16, gate_ssim=-1.0,
                                                  gate_psnr_db=-math.inf, **kw)
    assert report[0]["gate"] == "pass"
    assert report[-1] == {"chosen": "int8+staticGN+bf16sm+cached(i=12)"} and len(report) == 2
    cands = [("bf16+cached(i=2)", dict(conv_int8=False, static_gn=False, cache_interval=2)),
             ("int8", dict(conv_int8=True, static_gn=False))]
    sample, report = TS.make_validated_serving_sampler(_tcfg(), sd, 3, 16, gate_ssim=2.0,
                                                       _candidates=cands, **kw)
    assert [r.get("gate") for r in report[:2]] == ["fail", "fail"]
    assert report[-1] == {"chosen": "bf16 parity path"}
    x = torch.from_numpy(_x((2, 3, 16, 16), 18))
    plain = TS.make_serving_sampler(_tcfg(), sd, 3, device="cpu", conv_int8=False,
                                    static_gn=False, **SCHED)
    assert torch.equal(sample(x), plain(x))
