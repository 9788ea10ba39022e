"""The PyTorch UNet against the flax UNet on the same weights and inputs.

Weights are made with numpy at the flax shapes and cross through the port's
own converter (``state_dict_from_flax``); JAX runs at full fp32 matmul
precision on the CPU. Full widths are checked at a small spatial size, and
the full-size parameter trees by name and shape on the meta device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.models import unet2d as J
from bndm_tpu.models.convert import convert_flax_params
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import canonical_state_dict, state_dict_from_flax

TINY = dict(
    block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    attention_head_dim=4, norm_num_groups=4,
)


def _nhwc(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 3, 1))


def random_flax_params(module, *args, seed=0):
    """Params for a flax module without running its init: shapes from
    ``jax.eval_shape``, values from numpy (fan-in scaled kernels, and norm
    scales and biases away from their 1 / 0 defaults, so they are tested)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_apply(module, params, *args):
    with jax.default_matmul_precision("float32"):
        return np.asarray(jax.jit(module.apply)(params, *args))


def _load(module, flax_params):
    module.load_state_dict(state_dict_from_flax(jax.device_get(flax_params)), strict=True)
    return module.eval()


def test_resnet_block_full_width():
    """The res-64 bottleneck widths: 256 -> 512 channels, 32 groups, temb 512."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 256, 8, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 512)).astype(np.float32)
    blk = J.ResnetBlock2D(out_channels=512, groups=32)
    params = random_flax_params(blk, _nhwc(x), jnp.asarray(temb), seed=11)
    want = np.transpose(jax_apply(blk, params, _nhwc(x), jnp.asarray(temb)), (0, 3, 1, 2))
    t = _load(P.ResnetBlock2D(256, 512, 512, groups=32), params)
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(temb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_attention_block_full_width():
    """c = 512, head_dim 8 -> 64 heads, fp32 softmax, residual."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 512, 8, 8)).astype(np.float32)
    blk = J.AttentionBlock(head_dim=8, groups=32)
    params = random_flax_params(blk, _nhwc(x), seed=13)
    want = np.transpose(jax_apply(blk, params, _nhwc(x)), (0, 3, 1, 2))
    t = _load(P.AttentionBlock(512, head_dim=8, groups=32), params)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,atol", [
    ([0.0, 0.004, 0.5, 0.996, 1.0], 1e-6),  # IADB's float alpha timesteps
    ([1.0, 250.0, 999.0], 5e-5),  # integer steps: sin/cos of arguments up to
    # 999 rad, where one fp32 ulp of the argument is already 6e-5
])
def test_timestep_embedding_matches_jax(t, atol):
    t = np.asarray(t, np.float32)
    for flip in (True, False):
        want = np.asarray(J.get_timestep_embedding(jnp.asarray(t), 128, flip_sin_to_cos=flip))
        got = P.get_timestep_embedding(torch.from_numpy(t), 128, flip_sin_to_cos=flip).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("act", ["silu", "swish", "gelu", "mish", "relu"])
def test_activations_match_flax(act):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(J.ACT[act](jnp.asarray(x)))
    got = P.ACT[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_ch,act", [(3, "silu"), (6, "silu"), (3, "mish")])
def test_tiny_unet_matches_jax(in_ch, act):
    """The whole skip wiring, up/down sampling and output conv (two-head out)."""
    cfg = dict(TINY, in_channels=in_ch, out_channels=6, act_fn=act)
    jm = J.UNet2D(J.UNet2DConfig(**cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, in_ch, 16, 16)).astype(np.float32)
    t = np.array([0.25, 0.9], np.float32)
    params = random_flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=5)
    want = jax_apply(jm, params, jnp.asarray(x), jnp.asarray(t))
    tm = _load(P.UNet2D(P.UNet2DConfig(**cfg)), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_bf16_compute_and_cast_params():
    """bf16 compute: casting the weights once (``cast_params_``) gives the
    same numbers as casting at every call; GroupNorm and conv_out stay fp32
    and the output is fp32."""
    cfg = P.UNet2DConfig(**TINY, out_channels=6, dtype="bfloat16")
    torch.manual_seed(0)
    m = P.UNet2D(cfg).eval()
    x = torch.randn(2, 3, 16, 16)
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        per_call = m(x, t)
        m.cast_params_()
        once = m(x, t)
    assert once.dtype == torch.float32
    torch.testing.assert_close(once, per_call, rtol=0, atol=0)
    assert m.conv_in.weight.dtype == torch.bfloat16
    assert m.conv_norm_out.weight.dtype == torch.float32
    assert m.conv_out.weight.dtype == torch.float32


def _flax_shapes_as_state_dict(jcfg, in_ch, res):
    """convert_flax_params of jax.eval_shape params: zero-stride numpy leaves
    carry the shapes without allocating the weights."""
    model = J.UNet2D(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, in_ch, res, res)), jnp.zeros((1,)))
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    return {k: tuple(v.shape) for k, v in convert_flax_params(leaves).items()}


@pytest.mark.parametrize("res,in_ch,n_params", [(64, 3, 113_676_678), (128, 6, 116_323_846)])
def test_full_width_state_dict_names_and_shapes(res, in_ch, n_params):
    """The full-size configs (res-64 two-head, res-128 conditional): the
    port's state_dict has exactly the converted flax names and shapes, and
    loads strictly (on the meta device: nothing is allocated)."""
    jcfg = J.unet_config_for_res(res, in_channels=in_ch, out_channels=6)
    want = _flax_shapes_as_state_dict(jcfg, in_ch, res)
    tm = P.UNet2D(P.unet_config_for_res(res, in_channels=in_ch, out_channels=6),
                  device="meta")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == n_params
    sd = {k: torch.empty(s, device="meta") for k, s in want.items()}
    result = tm.load_state_dict(sd, strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_configs_match_jax_and_later_tiers_raise():
    for res in (64, 128, 256, "latent32"):
        j = dataclasses.asdict(J.unet_config_for_res(res, in_channels=6, out_channels=6))
        p = dataclasses.asdict(P.unet_config_for_res(res, in_channels=6, out_channels=6))
        assert p == j
    for field, value in [("conv_int8", True), ("gn_mode", "static"), ("fast_upsample", True),
                         ("cache_depth", 2), ("dropout", 0.1), ("int8_wide", True)]:
        with pytest.raises(NotImplementedError, match=field):
            P.UNet2D(dataclasses.replace(P.UNet2DConfig(**TINY), **{field: value}))


@pytest.mark.parametrize("legacy", [False, True])
def test_reference_ckpt_loads_like_the_npz(tmp_path, legacy):
    """A reference-style ``model.ckpt`` (written by the JAX package's
    ``export_torch_ckpt``; with pre-0.14 attention names when ``legacy``)
    resolves to the same strict-loadable state_dict as the flax params."""
    from bndm_tpu.models.convert import export_torch_ckpt
    from bndm_tpu_torch.cli.common import load_pixel_unet_params

    jm = J.UNet2D(J.UNet2DConfig(**TINY, out_channels=6))
    params = jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 16, 16)), jnp.zeros(1),
                                               seed=6))
    path = tmp_path / "model.ckpt"
    export_torch_ckpt(params, str(path))
    if legacy:
        new = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        sd = torch.load(path, weights_only=True)
        for a, b in new.items():
            sd = {k.replace(f".{a}.", f".{b}."): v for k, v in sd.items()}
        assert any(".proj_attn." in k for k in sd)
        torch.save(sd, path)
    got = load_pixel_unet_params(str(tmp_path))
    want = state_dict_from_flax(params)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    P.UNet2D(P.UNet2DConfig(**TINY, out_channels=6)).load_state_dict(got, strict=True)


def test_legacy_checkpoint_names_are_renamed():
    sd = {"mid_block.attentions.0.query.weight": 1, "mid_block.attentions.0.proj_attn.bias": 2,
          "mid_block.attentions.0.key.weight": 3, "x.num_batches_tracked": 4}
    assert canonical_state_dict(sd) == {
        "mid_block.attentions.0.to_q.weight": 1, "mid_block.attentions.0.to_out.0.bias": 2,
        "mid_block.attentions.0.to_k.weight": 3}
