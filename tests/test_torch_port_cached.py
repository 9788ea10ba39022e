"""The port's feature-reuse and microbatched samplers against the JAX package.

Items of the serving slice that change no arithmetic of a forward:
``IADBScheduler``; the UNet's ``cache_depth`` split (``return_deep`` and
the shallow ``deep_feature`` forward); the cached chain with its remainder
group, ``x_c`` conditioning and a bf16 carry; the microbatched sampler; the
bf16 attention softmax of the serving model. The same numpy-seeded inputs
and JAX-made weights go through both sides; JAX at fp32 matmul precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.cli.common import serving_relax_kw as j_relax_kw
from bndm_tpu.models import unet2d as J
from bndm_tpu.samplers import iadb as jiadb
from bndm_tpu_torch.cli.common import serving_relax_kw as t_relax_kw
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import state_dict_from_flax
from bndm_tpu_torch.samplers import iadb as tiadb
from test_torch_port_unet import TINY, random_flax_params

# three levels, so that cache_depth takes 1 and 2
TINY3 = dict(
    block_out_channels=(8, 8, 16),
    down_block_types=("DownBlock2D", "DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D", "UpBlock2D"),
    attention_head_dim=4, norm_num_groups=4,
)
FWD = dict(rtol=5e-4, atol=5e-4)  # model forwards and chains (ROADMAP parity rules)
SCHED = dict(scheduler_gamma="sigmoid", gamma_params=(1000.0, 0.0, 3.0), two_head=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is fastest, and a pool
    per test worker would oversubscribe the cores the workers share."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _pair(cfg_kw, in_ch=3, seed=0, tiny=TINY3):
    jm = J.UNet2D(J.UNet2DConfig(**tiny, in_channels=in_ch, out_channels=6, **cfg_kw))
    params = random_flax_params(jm, jnp.zeros((1, in_ch, 16, 16)), jnp.zeros(1), seed=seed)
    tm = P.UNet2D(P.UNet2DConfig(**tiny, in_channels=in_ch, out_channels=6, **cfg_kw))
    tm.load_state_dict(state_dict_from_flax(jax.device_get(params)), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def models():
    """The two-level tiny two-head UNet at cache_depth 1, unconditional and
    with the super-res concat, on both sides with the same weights (the
    chains' JAX side compiles a UNet per forward of a group)."""
    return {"uncond": _pair({}, 3, seed=1, tiny=TINY), "cond": _pair({}, 6, seed=2, tiny=TINY)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------- scheduler -----------------------------------


@pytest.mark.parametrize("two_head", [True, False])
def test_iadb_scheduler_matches_jax(two_head):
    js, ts = jiadb.IADBScheduler(), tiadb.IADBScheduler()
    for s in (js, ts):
        with pytest.raises(ValueError, match="set_timesteps"):
            s.step(None, 0, None)
        s.set_timesteps(10)
    assert ts.timesteps == js.timesteps and len(ts) == len(js) == 1000
    x, d = _x((2, 3, 4, 4), 0), _x((2, 6 if two_head else 3, 4, 4), 1)
    for step in (9, 4, 0):
        want = np.asarray(js.step(jnp.asarray(d), step, jnp.asarray(x), two_head=two_head))
        got = ts.step(torch.from_numpy(d), step, torch.from_numpy(x), two_head=two_head)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    clean, noise = _x((3, 3, 4, 4), 2), _x((3, 3, 4, 4), 3)
    alpha = np.array([0.1, 0.5, 0.9])  # float64 on purpose: both sides compute in fp32
    want = np.asarray(js.add_noise(jnp.asarray(clean), jnp.asarray(noise), alpha))
    got = ts.add_noise(torch.from_numpy(clean), torch.from_numpy(noise), alpha)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------ the UNet split -------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_shallow_forward_and_deep_feature_match(depth):
    """At every valid depth: return_deep's output and trunk feature against
    JAX's (NHWC there, transposed), and the shallow forward on the deep
    feature of the same (x, t) against the full forward, on both sides."""
    jm, params, tm = _pair(dict(cache_depth=depth), seed=3)
    x, t = _x((2, 3, 16, 16), 4), np.array([0.3, 0.8], np.float32)
    @jax.jit
    def full_then_shallow(params, x, t):
        out, deep = jm.apply(params, x, t, return_deep=True)
        return out, deep, jm.apply(params, x, t, deep_feature=deep)

    with jax.default_matmul_precision("float32"):
        j_out, j_deep, j_shallow = full_then_shallow(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        plain = tm(torch.from_numpy(x), torch.from_numpy(t))
        out, deep = tm(torch.from_numpy(x), torch.from_numpy(t), return_deep=True)
        shallow = tm(torch.from_numpy(x), torch.from_numpy(t), deep_feature=deep)
    assert torch.equal(out, plain)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD)
    np.testing.assert_allclose(deep.numpy(), np.transpose(np.asarray(j_deep), (0, 3, 1, 2)),
                               **FWD)
    np.testing.assert_allclose(shallow.numpy(), out.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(shallow.numpy(), np.asarray(j_shallow), **FWD)


@pytest.mark.parametrize("depth,kw,match", [
    (1, "both", "cannot return_deep"), (0, "deep", r"cache_depth 0 must be in \[1, 2\]"),
    (3, "deep", r"cache_depth 3 must be in \[1, 2\]")])
def test_cache_depth_checks_match_jax(depth, kw, match):
    jm, params, tm = _pair(dict(cache_depth=depth), seed=5)
    x, t = np.zeros((1, 3, 16, 16), np.float32), np.zeros(1, np.float32)
    feat = np.zeros((1, 16, 8, 8), np.float32)
    jkw = dict(return_deep=True)
    tkw = dict(return_deep=True)
    if kw == "both":
        jkw["deep_feature"] = jnp.zeros((1, 8, 8, 16))
        tkw["deep_feature"] = torch.from_numpy(feat)
    with pytest.raises(ValueError, match=match):
        jax.jit(lambda p, x, t: jm.apply(p, x, t, **jkw))(params, jnp.asarray(x), jnp.asarray(t))
    with pytest.raises(ValueError, match=match):
        tm(torch.from_numpy(x), torch.from_numpy(t), **tkw)


# -------------------------------- the chains ---------------------------------


def _j_cached(jm, params, x0, **kw):
    def full(p, x, t):
        return jm.apply(p, x, t, return_deep=True)

    def shallow(p, x, t, deep):
        return jm.apply(p, x, t, deep_feature=deep)

    with jax.default_matmul_precision("float32"):
        return np.asarray(jiadb.sample_iadb_cached(full, shallow, params, jnp.asarray(x0),
                                                   **kw))


def _t_forwards(tm):
    return (lambda x, t: tm(x, t, return_deep=True),
            lambda x, t, deep: tm(x, t, deep_feature=deep))


@pytest.mark.parametrize("case", ["plain", "x_c_bf16_carry"])
def test_cached_chain_matches_jax(models, case):
    """7 steps at interval 3: two groups and a remainder group of one;
    unconditional with an fp32 carry, and with super-res conditioning and a
    bf16 carry (x rounded to bf16 after every step on both sides)."""
    jm, params, tm = models["uncond" if case == "plain" else "cond"]
    x0 = _x((2, 3, 16, 16), 6)
    kw = dict(nb_steps=7, cache_interval=3, **SCHED)
    j_kw, t_kw = dict(kw), dict(kw)
    if case != "plain":
        x_c = _x((2, 3, 16, 16), 7)
        j_kw.update(x_c=jnp.asarray(x_c), carry_dtype=jnp.bfloat16)
        t_kw.update(x_c=torch.from_numpy(x_c), carry_dtype=torch.bfloat16)
    want = _j_cached(jm, params, x0, **j_kw)
    got = tiadb.sample_iadb_cached(*_t_forwards(tm), torch.from_numpy(x0), **t_kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_cache_interval_one_is_the_plain_sampler(models):
    _, _, tm = models["uncond"]
    x0 = torch.from_numpy(_x((2, 3, 16, 16), 8))
    plain, _ = tiadb.sample_iadb(tm, x0, nb_steps=5, **SCHED)
    cached = tiadb.sample_iadb_cached(*_t_forwards(tm), x0, nb_steps=5, cache_interval=1,
                                      **SCHED)
    assert torch.equal(cached, plain)
    with pytest.raises(ValueError, match="cache_interval 0 must be >= 1"):
        tiadb.sample_iadb_cached(*_t_forwards(tm), x0, nb_steps=5, cache_interval=0)


@pytest.mark.parametrize("cached", [False, True])
def test_microbatched_matches_jax_and_the_plain_sampler(models, cached):
    """K = 2 microbatches of 2: against the JAX sampler on the same x0, and
    each microbatch exactly the port's plain (or cached) chain on its rows.
    x0 itself is left as it was."""
    jm, params, tm = models["uncond"]
    x0 = _x((4, 3, 16, 16), 9)
    kw = dict(nb_steps=5, **SCHED)
    if cached:
        def j_full(p, x, t):
            return jm.apply(p, x, t, return_deep=True)

        def j_shallow(p, x, t, deep):
            return jm.apply(p, x, t, deep_feature=deep)

        j_args = dict(apply_shallow_fn=j_shallow, cache_interval=2)
        full, shallow = _t_forwards(tm)
        t_args = dict(apply_shallow=shallow, cache_interval=2)
    else:
        j_full, j_args, full, t_args = jm.apply, {}, tm, {}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jiadb.sample_iadb_microbatched(j_full, params, jnp.array(x0),
                                                         microbatch=2, **j_args, **kw))
    tx0 = torch.from_numpy(x0.copy())
    got = tiadb.sample_iadb_microbatched(full, tx0, microbatch=2, **t_args, **kw)
    assert torch.equal(tx0, torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    for k in range(2):
        rows = tx0[2 * k:2 * k + 2]
        if cached:
            one = tiadb.sample_iadb_cached(full, shallow, rows, cache_interval=2, **kw)
        else:
            one, _ = tiadb.sample_iadb(tm, rows, **kw)
        assert torch.equal(got[2 * k:2 * k + 2], one)
    stacked = tiadb.sample_iadb_microbatched(full, tx0.reshape(2, 2, 3, 16, 16), microbatch=2,
                                             **t_args, **kw)
    assert torch.equal(stacked.reshape(4, 3, 16, 16), got)
    with pytest.raises(ValueError, match="batch 4 not divisible by microbatch 3"):
        tiadb.sample_iadb_microbatched(full, tx0, microbatch=3, **t_args, **kw)


# --------------------------- the bf16 softmax tier ---------------------------


def test_bf16_softmax_serving_model_matches_jax(models):
    """serving_relax_kw as the JAX CLI's; the bf16 softmax against JAX's.

    On the same logits, the port's bf16 softmax equals the one XLA fuses
    from ``jax.nn.softmax`` exactly (its rounding points: the shifted
    logits and the numerator round to bf16, the row sum once, the quotient
    not), where ``torch.softmax`` in bf16 does not. The serving model on the
    same weights: within 2e-3 of JAX's bf16-softmax forward (read: 1.1e-3,
    logits that land on the other side of a bf16 rounding boundary), while
    the fp32 softmax reads 3.9e-3 from it and must stay outside."""
    class Opt:
        attn_softmax_dtype = "bfloat16"

    assert t_relax_kw(Opt) == j_relax_kw(Opt) == {"attn_softmax_dtype": "bfloat16"}
    Opt.attn_softmax_dtype = "float32"
    assert t_relax_kw(Opt) == j_relax_kw(Opt) == {}
    logits = _x((2, 4, 64, 64), 11) * 3
    want = np.asarray(jax.jit(lambda z: jax.nn.softmax(z.astype(jnp.bfloat16) * 0.5, axis=-1)
                              .astype(jnp.float32))(jnp.asarray(logits)))
    lb = torch.from_numpy(logits).to(torch.bfloat16) * 0.5
    np.testing.assert_array_equal(P._softmax(lb).numpy(), want)
    assert not np.array_equal(torch.softmax(lb, dim=-1).float().numpy(), want)

    jm, params, tm = models["uncond"]
    relax = {"attn_softmax_dtype": "bfloat16"}
    jr = J.UNet2D(dataclasses.replace(jm.cfg, **relax))
    tr = P.UNet2D(dataclasses.replace(tm.cfg, **relax))
    tr.load_state_dict(tm.state_dict(), strict=True)
    x, t = _x((2, 3, 16, 16), 10), np.array([0.2, 0.9], np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jr.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tr.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        exact = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    print(f"bf16-softmax forward against JAX's: max|diff| {np.abs(got - want).max():.2e}; "
          f"the fp32 softmax {np.abs(exact - want).max():.2e} (limit 2e-3)")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert np.abs(exact - want).max() > 2e-3  # the fp32 softmax fails the same limit
