"""The PyTorch port's training slice against the JAX package, on the CPU.

The losses, the remap, one train step on the tiny UNet (the loss and every
gradient, model and (tau, s, e), against ``jax.value_and_grad`` of the JAX
step's ``loss_fn`` on the same weights, timesteps and white noise), the two
optimizers fed JAX's own gradients against optax, the loader, checkpoint
resume, and the CLI's train mode, whose ``model.npz`` the JAX package loads.
JAX runs at full fp32 matmul precision and both sides compute in fp32.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bndm_tpu.data import imagefolder as jdata
from bndm_tpu.models import unet2d as J
from bndm_tpu.train import losses as jl
from bndm_tpu.train import pixel as jp
from bndm_tpu_torch.ckpt.manager import CheckpointManager
from bndm_tpu_torch.data import imagefolder as tdata
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import flax_from_state_dict, state_dict_from_flax
from bndm_tpu_torch.train import losses as tl
from bndm_tpu_torch.train import pixel as tp
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet import TINY, random_flax_params

# the trainer's own behaviour (learning, resume, the clamp, remat) on a tiny
# UNet without attention: a CPU step of it costs a quarter of TINY's
PLAIN = dict(TINY, down_block_types=("DownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "UpBlock2D"))

# ------------------------------- losses --------------------------------------


@pytest.mark.parametrize("bs", [64, 7])
def test_antithetic_timesteps(bs):
    g = torch.Generator().manual_seed(0)
    t = tl.antithetic_timesteps(g, bs, 1000).numpy()
    half = (bs + 1) // 2
    assert t.shape == (bs,) and t.min() >= 1 and t.max() <= 1000
    np.testing.assert_array_equal(t[half:], 1000 - t[:bs - half] + 1)
    td = tl.antithetic_timesteps_ddim(g, bs, 1000).numpy()
    assert td.shape == (bs,) and td.min() >= 0 and td.max() <= 999
    np.testing.assert_array_equal(td[half:], 1000 - td[:bs - half] - 1)


@pytest.mark.parametrize("b", [2, 6, 9])
def test_remap_batch_matches_jax(b):
    rng = np.random.default_rng(b)
    x0 = rng.standard_normal((b, 3, 8, 8)).astype(np.float32)
    x1 = rng.standard_normal((b, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jl.remap_batch(jnp.asarray(x0), jnp.asarray(x1)))
    got = tl.remap_batch(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got) == list(range(b))


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    d6 = rng.standard_normal((3, 6, 8, 8)).astype(np.float32)
    x1, x0, bn, wn = (rng.standard_normal((3, 3, 8, 8)).astype(np.float32) for _ in range(4))
    a, ap, g, gp = (rng.uniform(0.1, 0.9, 3).astype(np.float32) for _ in range(4))
    j, t = (lambda *v: [jnp.asarray(u) for u in v]), (lambda *v: [torch.from_numpy(u) for u in v])
    close = dict(rtol=1e-5, atol=0)
    np.testing.assert_allclose(tl.iadb_loss(*t(d6[:, :3], x1, x0)).item(),
                               float(jl.iadb_loss(*j(d6[:, :3], x1, x0))), **close)
    for two_head, d in ((True, d6), (False, d6[:, :3])):
        want = jl.bndm_loss(*j(d, x1, x0, bn, wn, a, ap, g, gp), two_head)
        got = tl.bndm_loss(*t(d, x1, x0, bn, wn, a, ap, g, gp), two_head)
        np.testing.assert_allclose(got.item(), float(want), **close)


# ---------------------------- one train step ---------------------------------

T = 100
SP = np.array([0.5, -0.3, 2.0], np.float32)  # inside the learnable sigmoid ranges
CASES = {  # name: (noise_type, out_channel, remap, conditional)
    "gaussianBN-two-head": ("gaussianBN", 6, False, False),
    "gaussianBN-one-head": ("gaussianBN", 3, False, False),
    "GBN": ("GBN", 3, False, False),
    "gaussian": ("gaussian", 3, False, False),
    "gaussianBN-remap": ("gaussianBN", 6, True, False),
    "gaussianBN-superres": ("gaussianBN", 6, False, True),
}


def _cfgs(noise_type, outc, remap, conditional=False, **kw):
    common = dict(nb_steps=T, noise_type=noise_type, scheduler_gamma="sigmoid",
                  gamma_defaults=tuple(float(v) for v in SP), optimize_scheduler_param=True,
                  out_channel=outc, remap=remap, conditional=conditional, **kw)
    return jp.TrainConfig(**common), tp.TrainConfig(**common)


@functools.cache
def _jax_model(outc, seed, in_ch=3):
    jm = J.UNet2D(J.UNet2DConfig(**TINY, in_channels=in_ch, out_channels=outc))
    return jm, random_flax_params(jm, jnp.zeros((1, in_ch, 64, 64)), jnp.zeros(1), seed=seed)


def _pair(outc, seed, in_ch=3):
    """The tiny JAX UNet with seeded random params, and the port's UNet
    carrying the same weights (fresh on every call); ``in_ch`` 6 for the
    super-res concat."""
    jm, params = _jax_model(outc, seed, in_ch)
    tm = P.UNet2D(P.UNet2DConfig(**TINY, in_channels=in_ch, out_channels=outc))
    tm.load_state_dict(state_dict_from_flax(jax.device_get(params)), strict=True)
    return jm, params, tm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    return x1, np.array([10.0, 91.0], np.float32), jax.random.PRNGKey(seed)


def _jax_step(jm, jcfg, L, params, x1, t, key):
    def grads(params, sp, x1, t, key, L):
        # L is an argument, not a constant of the step: XLA would spend
        # seconds folding the transpose of a 64 MB constant
        step, _ = jp.make_train_step(jm.apply, jcfg, L)
        return jax.value_and_grad(step.loss_fn, argnums=(0, 1), has_aux=True)(
            params, sp, x1, t, key)

    with jax.default_matmul_precision("float32"):
        (loss, _), (g_model, g_sp) = jax.jit(grads)(
            params, jnp.asarray(SP), jnp.asarray(x1), jnp.asarray(t), key, jnp.asarray(L))
    return float(loss), jax.device_get(g_model), np.asarray(g_sp)


def _port_grads(tm, tcfg, L, x1, t, white):
    step, init = tp.make_train_step(tcfg, torch.from_numpy(L))
    sp = torch.from_numpy(SP.copy()).requires_grad_()
    loss = step.loss_fn(tm, sp, torch.from_numpy(x1), torch.from_numpy(t), white)
    loss.backward()
    grads = flax_from_state_dict({k: p.grad for k, p in tm.named_parameters()})
    # GBN's loss does not reach (tau, s, e): torch leaves no grad, JAX zeros
    return loss.item(), grads, np.zeros(3, np.float32) if sp.grad is None else sp.grad.numpy()


def _assert_tree_close(got, want, frac):
    """Every leaf within ``frac`` of the largest |value| of its module (its
    kernel and bias together: the key projection's bias has a gradient of
    exactly zero, the softmax being blind to it, and its rounding noise is on
    the scale of the kernel's gradient)."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    module_max = {}
    for path, w in wl:
        m = path[:-1]
        module_max[m] = max(module_max.get(m, 0.0), float(np.abs(w).max()))
    for (path, g), (_, w) in zip(gl, wl):
        scale = max(module_max[path[:-1]], 1e-12)
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= frac * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.fixture(scope="module")
def jax_case(small_L):
    """JAX's (params, loss, model grads, (tau, s, e) grads) of one step of
    a case, computed once per case for this module."""
    cache = {}

    def get(case):
        if case not in cache:
            noise_type, outc, remap, cond = CASES[case]
            jm, params, _ = _pair(outc, seed=20, in_ch=6 if cond else 3)
            x1, t, key = _inputs(21)
            cache[case] = (params,) + _jax_step(jm, _cfgs(noise_type, outc, remap, cond)[0],
                                                small_L, params, x1, t, key)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_loss_and_grads_match_jax(small_L, jax_case, case):
    """One step on the tiny UNet: the loss to 1e-5 relative, the model
    gradients to 1e-4 of their module's largest |g|, the (tau, s, e)
    gradients to 1e-4 of their largest."""
    noise_type, outc, remap, cond = CASES[case]
    _, tcfg = _cfgs(noise_type, outc, remap, cond)
    _, _, tm = _pair(outc, seed=20, in_ch=6 if cond else 3)
    x1, t, key = _inputs(21)
    _, want_loss, want_g, want_sp = jax_case(case)
    white = torch.from_numpy(np.array(jax.random.normal(key, x1.shape, jnp.float32)))
    loss, g, g_sp = _port_grads(tm, tcfg, small_L, x1, t, white)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_tree_close(g, {"params": want_g["params"]}, 1e-4)
    np.testing.assert_allclose(g_sp, want_sp, rtol=0, atol=1e-4 * np.abs(want_sp).max())


def test_remat_gives_the_same_grads(small_L):
    """Checkpointing the UNet changes memory, not the gradients."""
    _, tcfg = _cfgs("gaussianBN", 6, False)
    x1, t, key = _inputs(22)
    white = torch.from_numpy(np.array(jax.random.normal(key, x1.shape, jnp.float32)))
    torch.manual_seed(23)
    weights = P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)).state_dict()
    out = []
    for remat in (False, True):
        tm = P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6))
        tm.load_state_dict(weights)
        out.append(_port_grads(tm, dataclasses.replace(tcfg, remat=remat), small_L, x1, t,
                               white))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    _assert_tree_close(out[1][1], out[0][1], 1e-6)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_optimizer_step_matches_optax(small_L, jax_case, grad_clip):
    """Both optimizers fed JAX's own gradients: the updated weights and the
    clamped (tau, s, e) match optax's AdamW (with the global-norm clip,
    which these gradients, of norm far above 1, trigger) to 1e-6."""
    jcfg, tcfg = _cfgs("gaussianBN", 6, False, grad_clip=grad_clip)
    _, _, tm = _pair(6, seed=20)
    params, _, g_model, g_sp = jax_case("gaussianBN-two-head")

    def first_update(opt, grads, params):  # one optax step from a fresh state
        return optax.apply_updates(params, opt.update(grads, opt.init(params), params)[0])

    new_params = jax.jit(functools.partial(first_update, jp._make_optimizer(jcfg)))(
        g_model, params)
    ranges = np.array(jp.gamma_param_ranges("sigmoid", True), np.float32)
    new_sp = np.clip(np.asarray(first_update(optax.adamw(jcfg.sched_lr), jnp.asarray(g_sp),
                                             jnp.asarray(SP))), ranges[:, 0], ranges[:, 1])

    tstep, tinit = tp.make_train_step(tcfg, torch.from_numpy(small_L))
    state = tinit(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        state.sched_params.copy_(torch.from_numpy(SP))
    grads = state_dict_from_flax(g_model)
    for name, p in tm.named_parameters():
        p.grad = grads[name].clone()
    state.sched_params.grad = torch.from_numpy(g_sp.copy())
    tstep.apply_gradients(state)
    assert state.step == 1
    _assert_tree_close(flax_from_state_dict(tm.state_dict()), jax.device_get(new_params), 1e-6)
    np.testing.assert_allclose(state.sched_params.detach().numpy(), new_sp, rtol=0, atol=1e-6)


def test_fixed_sched_params_stay_fixed(small_L):
    cfg = tp.TrainConfig(nb_steps=T, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), out_channel=6)
    tr = tp.PixelTrainer(P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)), cfg, small_L)
    m = tr.step(torch.full((2, 3, 64, 64), 0.5), (0, 0))
    assert np.isfinite(m["loss"].item())
    np.testing.assert_array_equal(tr.state.sched_params.detach().numpy(),
                                  np.array([0.2, 0.0, 3.0], np.float32))


def test_train_loss_decreases(small_L):
    """The tiny model learns a fixed batch under a fixed key (the JAX
    package's test of the same), and (tau, s, e) stay in their ranges."""
    cfg = tp.TrainConfig(nb_steps=T, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), optimize_scheduler_param=True,
                         out_channel=6, lr=2e-3, grad_clip=1.0)
    torch.manual_seed(0)
    tr = tp.PixelTrainer(P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)), cfg, small_L)
    batch = torch.from_numpy(
        np.random.default_rng(1).uniform(0.3, 0.7, (2, 3, 64, 64)).astype(np.float32))
    losses = [tr.step(batch, (100,))["loss"].item() for _ in range(12)]
    assert losses[-1] < losses[0] * 0.7, losses
    sp = tr.state.sched_params.detach().numpy()
    assert 0.01 <= sp[0] <= 10.0 and -3.0 <= sp[1] <= -0.01 and 0.01 <= sp[2] <= 3.0


def test_checkpoint_resume_equals_uninterrupted(small_L, tmp_path):
    """2 steps, save, a fresh trainer restores and steps once: the same
    weights, optimizer state and (tau, s, e) as 3 steps in one go."""
    cfg = tp.TrainConfig(nb_steps=T, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), optimize_scheduler_param=True,
                         out_channel=6, grad_clip=1.0)
    batch = torch.from_numpy(
        np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))

    def trainer(init_seed):
        torch.manual_seed(init_seed)
        return tp.PixelTrainer(P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)), cfg, small_L)

    whole = trainer(0)
    for s in range(3):
        whole.step(batch, (0, s))
    first = trainer(0)
    for s in range(2):
        first.step(batch, (0, s))
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    mgr.save(first.state.step, first.state)
    mgr.save(first.state.step + 5, first.state)  # keep-N prunes step 2
    assert mgr.latest_step() == 7 and mgr.all_steps() == [7]
    resumed = trainer(1)  # other initial weights: the restore must replace them
    assert mgr.restore(resumed.state).step == 2
    resumed.step(batch, (0, 2))
    assert resumed.state.step == whole.state.step == 3
    for a, b in zip(resumed.model.state_dict().values(), whole.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.state.sched_params, whole.state.sched_params)
    assert CheckpointManager(str(tmp_path / "empty")).restore(resumed.state) is None


# ----------------------- the UNet as CUDA graphs -----------------------------


@pytest.mark.parametrize("device,mesh,remat,training,engages", [
    ("cuda", None, False, True, True),
    ("cuda:1", None, False, True, True),
    ("cpu", None, False, True, False),
    ("cuda", "a mesh", False, True, False),
    ("cuda", None, True, True, False),
    ("cuda", None, False, False, False),
])
def test_unet_graphs_engage_on_one_cuda_device_in_training(device, mesh, remat, training,
                                                           engages):
    assert tp.graphs_unet(torch.device(device), mesh, remat, training) is engages


def test_a_cpu_train_step_never_captures(small_L):
    cfg = tp.TrainConfig(nb_steps=T, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), optimize_scheduler_param=True,
                         out_channel=6)
    tr = tp.PixelTrainer(P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)), cfg, small_L)
    for s in range(2):
        tr.step(torch.full((2, 3, 64, 64), 0.5), (0, s))
    graphs = tr.train_step.unet_graph
    assert (graphs.captures, graphs.replays) == (0, 0)


def test_unet_graphs_capture_once_per_signature_and_storage(monkeypatch):
    """One capture for each signature of the inputs (shape, dtype,
    requires_grad, grad mode), replays after it; a load in place keeps the
    graphs, one that assigns new tensors, or another model, drops them.
    The capture is faked: the module it is given runs eagerly."""
    captured = []
    monkeypatch.setattr(torch.cuda, "make_graphed_callables",
                        lambda module, sample: captured.append(sample) or module)
    torch.manual_seed(0)
    model = P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6))
    graphs = tp.UNetGraphs()
    x, a = torch.randn(2, 3, 16, 16, requires_grad=True), torch.rand(2)
    out = graphs(model, x, a)
    torch.testing.assert_close(out, model(x, a), rtol=0, atol=0)
    assert captured[0][0] is not x and torch.equal(captured[0][0], x)
    assert captured[0][0].requires_grad and not captured[0][1].requires_grad
    graphs(model, x * 2, a)
    assert (graphs.captures, graphs.replays) == (1, 2)
    graphs(model, x[:1], a[:1])  # a short batch
    graphs(model, x.detach(), a)  # an input without grad
    graphs(model, x.double(), a)
    with torch.no_grad():
        graphs(model, x, a)
    assert (graphs.captures, graphs.replays) == (5, 6)
    model.load_state_dict(model.state_dict())
    graphs(model, x, a)
    assert graphs.captures == 5
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    graphs(model, x, a)
    assert graphs.captures == 6
    graphs(P.UNet2D(P.UNet2DConfig(**PLAIN, out_channels=6)), x, a)
    assert (graphs.captures, graphs.replays) == (7, 9)


# ------------------------------- loader --------------------------------------


def test_batch_loader_matches_jax(tmp_path):
    """The same shuffle, flips and crops per (seed, epoch) as the JAX
    loader: the same batches, within 2/255."""
    root = tdata.make_synthetic_folder(str(tmp_path / "d"), n=10, res=24, seed=3)
    for epoch in (0, 1):
        kw = dict(seed=5)
        jb = list(jdata.BatchLoader(jdata.ImageFolderDataset(root, 16, random_flip=True,
                                                             random_crop=True), 3, **kw)
                  .epoch(epoch))
        tb = list(tdata.BatchLoader(tdata.ImageFolderDataset(root, 16, random_flip=True,
                                                             random_crop=True), 3, **kw)
                  .epoch(epoch))
        assert len(tb) == len(jb) == 3
        for a, b in zip(tb, jb):
            assert a.shape == b.shape == (3, 3, 16, 16) and a.dtype == np.float32
            assert np.abs(a - b).max() * 255.0 <= 2.0
    loader = tdata.BatchLoader(tdata.ImageFolderDataset(root, 16), 4, drop_last=False)
    assert len(loader) == 3 and [b.shape[0] for b in loader.epoch()] == [4, 4, 2]
    assert next(iter(loader.epoch())).shape == (4, 3, 16, 16)  # an early stop ends cleanly


# --------------------------------- CLI ---------------------------------------

CLI = ["--dataset=tinycat", "--res=64", "--batch_size=2", "--tiny_model",
       "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=0.2",
       "--out_channel=6", "--compute_dtype=float32", "--nb_steps=10", "--device=cpu"]
RUN = os.path.join("results_gaussianBN", "tinycat_gaussianBN_sigmoid_0.2_0_3_outc6_seed0")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's CLI, train (2 steps, then a resumed third) then test, in
    one folder, as tests/test_cli_iadb.py runs the JAX CLI. TensorBoard is
    hidden: where it is installed its import pulls in TensorFlow (seconds),
    and the test reads the JSONL log."""
    from bndm_tpu_torch.cli.iadb_bn import main

    root = tmp_path_factory.mktemp("train_cli")
    cwd = os.getcwd()
    os.chdir(root)
    hidden = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError
    try:
        tdata.make_synthetic_folder("data/tinycat", n=4, res=64)
        L = np.tril(np.random.default_rng(0).standard_normal((4096, 4096)).astype(np.float32)
                    * 0.01)
        np.fill_diagonal(L, 1.0)
        os.makedirs("bluenoise")
        np.savez("bluenoise/cov_gaussianBN_L_res64_d3.npz", x=L)
        main(CLI + ["--train_or_test=train", "--epochs=1", "--max_steps=2", "--lr=1e-4",
                    "--export_reference_ckpt"])
        main(CLI + ["--train_or_test=train", "--epochs=1", "--max_steps=3",
                    "--resume_training"])
        main(CLI + ["--train_or_test=test", "--test_samples=2", "--save_all_samples"])
    finally:
        os.chdir(cwd)
        if hidden is False:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = hidden
    return root / RUN


def test_cli_train_then_test(trained):
    run = trained
    for f in ("model.npz", "model.ckpt", "losses.txt", "losses.png", "scheduler_params.txt",
              "scheduler_params.png", "logs/metrics.jsonl"):
        assert (run / f).exists(), f
    assert sorted(os.listdir(run / "checkpoints")) == ["2", "3"]
    assert np.loadtxt(run / "losses.txt").shape == ()  # the resumed run's one step
    np.testing.assert_allclose(np.loadtxt(run / "scheduler_params.txt"), [0.2, 0.0, 3.0],
                               atol=1e-7)
    assert len(open(run / "logs" / "metrics.jsonl").readlines()) == 3
    imgdir = run / "tinycat_iadb_gwn2gbn_steps10" / "images"
    assert len(list(imgdir.glob("*.png"))) == 2
    assert len(list((run / "tinycat_iadb_gwn2gbn_steps10" / "seqs").glob("*.png"))) > 0


def test_cli_model_npz_loads_in_jax(trained):
    """The port's model.npz loads with the JAX package's load_params, and
    the JAX UNet on it matches the port's UNet on the same weights to 5e-4;
    the model.ckpt export holds the same weights."""
    from bndm_tpu.cli.common import load_params as j_load_params
    from bndm_tpu_torch.cli.common import load_pixel_unet_params

    params = j_load_params(str(trained / "model.npz"))
    tm = P.UNet2D(P.UNet2DConfig(**TINY, in_channels=3, out_channels=6))
    tm.load_state_dict(load_pixel_unet_params(str(trained)), strict=True)
    jm = J.UNet2D(J.UNet2DConfig(**TINY, in_channels=3, out_channels=6))
    x = np.random.default_rng(6).standard_normal((2, 3, 64, 64)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    ckpt = torch.load(trained / "model.ckpt", map_location="cpu", weights_only=True)
    assert set(ckpt) == set(tm.state_dict())
    # model.ckpt is written at the end of the first run (step 2), model.npz
    # after the resumed step 3
    assert all(v.dtype == torch.float32 for v in ckpt.values())
