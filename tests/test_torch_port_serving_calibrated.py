"""The port's calibrated serving tiers against the JAX package.

``ops/int8.py::calibrate_sampling`` (the int8 activation scales and the
per-step GroupNorm tables of one exact trajectory), the static int8 and
static-GN forwards on JAX's own tables (the ``quant`` collection carried
across), and ``serving.py::make_serving_sampler``'s tier stacks against
JAX's on the same x0, weights and calibration batch. JAX calibrates once
per module; JAX runs at fp32 matmul precision.

Tolerances: 5e-4 for forwards and chains in fp32. An int8 forward is held
exactly site by site on JAX's own site inputs; end to end it cannot be
held to fp32 noise, because the two sides' fp32 activations differ by
~1e-6 and now and then one lands on the other side of a rounding boundary,
after which the chain carries the step (ROADMAP.md section 3). There it is
held to a PSNR over the output's range, between the sound readings and the
wrong chains read in the same test.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu import serving as JS
from bndm_tpu.models import unet2d as J
from bndm_tpu.ops import int8 as JI
from bndm_tpu_torch import serving as TS
from bndm_tpu_torch.models.convert import _torch_name, collection_from_flax
from bndm_tpu_torch.ops import int8 as TI
from test_torch_port_serving_tiers import (  # noqa: F401 (fixtures, used by name)
    EXACT, FWD, NB, SCHED, _jcfg, _nchw, _one_torch_thread, _tcfg, _tmodel, _x, weights)


# ------------------------- calibration and static forwards -------------------


CAL_KEY = jax.random.PRNGKey(3)  # make_serving_sampler's calibration key below
CAL_KW = dict(conv_int8=True, int8_mode="calibrate", gn_mode="calibrate", gn_steps=NB)


def _x_cal():
    """The calibration batch JAX's make_serving_sampler draws from CAL_KEY
    for a batch of 4."""
    return np.asarray(jax.random.normal(CAL_KEY, (4, 3, 16, 16), jnp.float32))


@pytest.fixture(scope="module")
def calibrated(weights):
    """One calibration trajectory (int8 sites and GN tables together) on
    each side from the same x_cal; JAX's quant collection as flax holds it
    and in the port's names, beside the port's own."""
    params, sd = weights
    x_cal = _x_cal()
    with jax.default_matmul_precision("float32"):
        jq = jax.device_get(JI.calibrate_sampling(J.UNet2D(_jcfg(**CAL_KW)), params,
                                                  jnp.asarray(x_cal), NB, **SCHED))
    tq = TI.calibrate_sampling(_tmodel(sd, **CAL_KW), torch.from_numpy(x_cal), NB, **SCHED)
    return jq, collection_from_flax(jq), tq


def test_calibrate_sampling_matches_jax(calibrated):
    """The int8 activation scales (amax) to 1e-5 relative, the per-step GN
    tables (batch means over one fp32 trajectory) to 5e-4."""
    _, jq, tq = calibrated
    assert sorted(tq) == sorted(jq)
    assert sum(k.endswith(".act_amax") for k in tq) > 0 and sum(k.endswith(".gn_mean")
                                                                 for k in tq) > 0
    for key in tq:
        rtol, atol = (1e-5, 0) if key.endswith(".act_amax") else (5e-4, 5e-4)
        np.testing.assert_allclose(tq[key].numpy(), jq[key].numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def test_static_gn_forward_on_jax_tables(weights, calibrated):
    jflax, jq, _ = calibrated
    params, sd = weights
    x, t = _x((2, 3, 16, 16), 7), np.array([3 / NB, 3 / NB], np.float32)
    kw = dict(gn_mode="static", gn_steps=NB)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(J.UNet2D(_jcfg(**kw)).apply)(
            {"params": params["params"], "quant": jflax}, jnp.asarray(x), jnp.asarray(t))
    tm = _tmodel(sd, **kw).load_quant(jq)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("gn", ["static", "dynamic"])
def test_int8_static_sites_on_jax_inputs_are_exact(weights, calibrated, gn):
    """An int8-static forward (static or dynamic GN) on JAX's tables: every int8 site
    of the port, fed the activation JAX's site saw, returns JAX's site
    output to 1e-6 (the same integers, the same dequantization).

    Free-running, the port's own site inputs differ from JAX's by fp32
    noise (<= 1e-5 at the first site where a quantized value differs, the
    rounding boundary's neighbourhood), and the differing values stay a
    small share; printed with -s: sites, flips, first flip."""
    from bndm_tpu.ops.int8 import Int8Conv

    jflax, jq, _ = calibrated
    params, sd = weights
    kw = dict(conv_int8=True, int8_mode="static", gn_mode=gn, gn_steps=NB)
    seen = {}

    def capture(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if isinstance(ctx.module, Int8Conv) and ctx.method_name == "__call__":
            seen[_torch_name(ctx.module.path)] = (args[0], out)
        return out

    @jax.jit
    def sites(variables, x, t):  # the captured values leave the trace as outputs
        seen.clear()
        with nn.intercept_methods(capture):
            J.UNet2D(_jcfg(**kw)).apply(variables, x, t)
        return dict(seen)

    x, t = _x((2, 3, 16, 16), 2), np.array([3 / NB, 3 / NB], np.float32)
    with jax.default_matmul_precision("float32"):
        seen = jax.device_get(sites({"params": params["params"], "quant": jflax},
                                    jnp.asarray(x), jnp.asarray(t)))
    tm = _tmodel(sd, **kw).load_quant(jq)
    mods = {name: m for name, m in tm.named_modules() if isinstance(m, TI.Int8Conv2d)}
    assert sorted(mods) == sorted(seen)
    ours = {}
    for name, m in mods.items():
        m.register_forward_pre_hook(lambda mod, a, name=name: ours.__setitem__(name, a[0]))
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.from_numpy(t))  # free-running: its own site inputs
        for name, (inp, out) in seen.items():
            got = mods[name](torch.from_numpy(_nchw(inp)))
            np.testing.assert_allclose(got.numpy(), _nchw(out), err_msg=name, **EXACT)
    flips, total, first = 0, 0, None
    for name in sorted(mods, key=list(ours).index):  # in the order the forward ran them
        scale = torch.clamp_min(jq[f"{name}.act_amax"], 1e-12) / 127.0
        mine, theirs = ours[name].float(), torch.from_numpy(_nchw(seen[name][0]))
        differ = TI._quantize_static(mine, scale) != TI._quantize_static(theirs, scale)
        flips, total = flips + int(differ.sum()), total + differ.numel()
        if first is None and differ.any():
            first = (name, int(differ.sum()), float((mine - theirs).abs().max()))
    print(f"int8 sites {len(mods)}, quantized values {total}, differing {flips}, first {first}")
    assert flips <= total // 100
    assert first is None or first[2] <= 1e-5


# ------------------------------ the tier samplers ----------------------------

# An int8 tier chain against JAX's: the sound chains read 66.7-67.9 dB over
# the output's range, the wrong ones below read 47.8-58.4 dB (ROADMAP.md
# section 3); the ladder gates a tier at 35 dB against the exact path.
INT8_CHAIN_DB = 62.0


def _psnr_over_range(got, want):
    rmse = np.sqrt(np.mean((got - want) ** 2))
    return 20 * np.log10((want.max() - want.min()) / max(rmse, 1e-12))


@pytest.mark.parametrize("name,kw", [
    ("gndrift+cached", dict(conv_int8=False, static_gn=False, gn_carry="drift",
                            cache_interval=3)),
    ("int8+staticGN+cached", dict(conv_int8=True, static_gn=True, cache_interval=2))])
def test_serving_tier_matches_jax(weights, calibrated, monkeypatch, name, kw):
    """make_serving_sampler's tier stacks against JAX's on the same x0,
    weights and calibration batch (JAX's draw from its key, handed to the
    port as x_cal): the drift-corrected GN carry (its GN calibration, the
    record/reuse pair, the correction) through the cached chain, to 5e-4;
    int8-static and static GN through the cached chain. The plain carry,
    static GN alone and int8 with dynamic GN are held at the forward above,
    the microbatched chain and the bf16 softmax in
    test_torch_port_cached.py, and all of them run through the CLI.

    The int8 chain is held to INT8_CHAIN_DB over the output's range, on the
    constants JAX calibrated (the module's calibration, which JAX's sampler
    is checked to ask for) and on the port's own (its scales sit ~1e-6
    relative from XLA's). Two wrong chains must fall below it: the tier
    with int8 left out, and the tier with every activation scale one level
    too wide (amax x 128/127). The readings are printed with -s."""
    params, sd = weights
    x0 = torch.from_numpy(_x((4, 3, 16, 16), 17))
    x_cal = _x_cal()
    common = dict(scheduler_gamma="sigmoid", gamma_params=(1000.0, 0.0, 3.0))
    if kw["conv_int8"]:
        def jax_calibration(model, p, xc, nb_steps, **sched):
            """The module's calibration, once JAX's sampler has asked for
            the same trajectory."""
            assert model.cfg == _jcfg(**CAL_KW) and nb_steps == NB and sched["x_c"] is None
            assert np.array_equal(np.asarray(xc), x_cal)
            assert (sched["scheduler_gamma"], sched["two_head"]) == ("sigmoid", True)
            assert np.asarray(sched["gamma_params"]).tolist() == [1000.0, 0.0, 3.0]
            return calibrated[0]

        monkeypatch.setattr(JI, "calibrate_sampling", jax_calibration)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JS.make_serving_sampler(_jcfg(), params, NB, key=CAL_KEY, **common,
                                                  **kw)(jnp.array(x0.numpy())))

    def served(quant=None, **over):
        """The port's tier on its own calibration, or on ``quant``."""
        if quant is not None:
            monkeypatch.setattr(TS, "calibrate_sampling", lambda *a, **k: quant)
        sample = TS.make_serving_sampler(_tcfg(), sd, NB, device="cpu",
                                         x_cal=torch.from_numpy(x_cal), **common,
                                         **dict(kw, **over))
        out = sample(x0).numpy()
        np.testing.assert_array_equal(sample(x0).numpy(), out)  # calibrated once
        return out

    got = served()
    if not kw["conv_int8"]:
        np.testing.assert_allclose(got, want, **FWD)
        return
    jq = calibrated[1]
    db = {"own": got, "no int8": served(conv_int8=False), "shared": served(jq),
          "scales one level wide": served({k: v * (128 / 127) if k.endswith(".act_amax") else v
                                           for k, v in jq.items()})}
    db = {k: float(_psnr_over_range(v, want)) for k, v in db.items()}
    print(f"{name} against JAX, dB over the output's range: "
          + ", ".join(f"{k} {v:.1f}" for k, v in db.items()))
    assert min(db["own"], db["shared"]) >= INT8_CHAIN_DB
    assert max(db["no int8"], db["scales one level wide"]) < INT8_CHAIN_DB
