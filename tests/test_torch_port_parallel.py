"""The PyTorch port's data parallelism against the JAX package, on the CPU.

The rank layouts (host grouping, the hybrid mesh, ``auto_mesh``) as pure
functions against JAX's meshes on the same group sizes; a 2-rank gloo run of
the tiny two-head UNet's train step against JAX's single-device loss and
gradients on the same weights, x1, t and white noise (the bounds of
``tests/mp_gradparity_worker.py``); one rank bit for bit the
non-distributed step; the pixel CLI's train mode on 2 ranks against one
process on the same global batches; the DDIM CLI's train and test modes on
2 ranks; and the port's 7-leg dry run. The ranks
are processes of their own (``bndm_tpu_torch/dryrun.py``), each bounded by a
timeout; they import only the port.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.models import unet2d as J
from bndm_tpu.parallel import distributed as jdist
from bndm_tpu.parallel import mesh as jmesh
from bndm_tpu.train import pixel as jp
from bndm_tpu_torch import dryrun
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import flax_from_state_dict, state_dict_from_flax
from bndm_tpu_torch.parallel import distributed as tdist
from bndm_tpu_torch.parallel import mesh as tmesh
from bndm_tpu_torch.train import pixel as tp
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, for every process a test starts

# ------------------------------ rank layouts ---------------------------------


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


@pytest.mark.parametrize("num_slices", [1, 2, 4, 8, 3])
def test_hybrid_layout_matches_jax(num_slices):
    """The port's (replica, data) rank array is JAX's device-id array on the
    8 virtual devices, and both refuse a split that does not divide."""
    if 8 % num_slices:
        with pytest.raises(ValueError):
            jdist.hybrid_mesh(num_slices=num_slices)
        with pytest.raises(ValueError, match="do not split"):
            tdist.hybrid_layout(8, num_slices)
        return
    assert tdist.hybrid_layout(8, num_slices) == _ids(jdist.hybrid_mesh(num_slices=num_slices))


class _Dev:
    def __init__(self, i, slice_index):
        self.id, self.slice_index = i, slice_index


@pytest.mark.parametrize("slice_of", [lambda i: i % 2, lambda i: i // 4, lambda i: i % 4,
                                      lambda i: int(i >= 5), lambda i: 0])
def test_host_grouping_matches_jax_slices(slice_of):
    """Ranks grouped by hostname as JAX groups devices by slice_index:
    the same groups, None for one host and for ragged hosts."""
    want = jdist._devices_by_slice([_Dev(i, slice_of(i)) for i in range(8)])
    got = tdist.groups_by_host([f"host{slice_of(i)}" for i in range(8)])
    assert got == (None if want is None else [[d.id for d in g] for g in want])


@pytest.mark.parametrize("batch,two_hosts", [(16, True), (32, True), (12, True),
                                             (16, False), (8, False), (12, False)])
def test_auto_layout_matches_jax(monkeypatch, batch, two_hosts):
    """Where JAX's auto_mesh keeps every device the port's layout is its
    device-id array; where JAX shrinks the mesh to divide the batch, the
    port (whose world is fixed at launch) raises the JAX CLIs' message."""
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]] if two_hosts else None
    devs = jax.devices()
    monkeypatch.setattr(jdist, "_devices_by_slice",
                        lambda d: [list(devs[:4]), list(devs[4:8])] if two_hosts else None)
    want = jmesh.auto_mesh(batch)
    if want.devices.size < 8:
        with pytest.raises(ValueError, match=f"--batch_size={batch} must divide across 8"):
            tmesh.auto_layout(batch, 8, groups)
        return
    assert tmesh.auto_layout(batch, 8, groups) == _ids(want)


# ---------------------- the train step on 2 ranks ----------------------------

SEED = 11


def _tiny_port_model():
    torch.manual_seed(SEED)
    return P.UNet2D(P.UNet2DConfig(**TINY, in_channels=3, out_channels=6))


@pytest.fixture(scope="module")
def two_rank_grads(tmp_path_factory):
    """One step of 2 gloo ranks, 2 rows each, on the tiny two-head UNet:
    (the inputs, rank 0's output of ``dryrun.py --job grads``)."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    L = dryrun._tril_L()
    rng = np.random.default_rng(3)
    # at 32^2 (the correlated noise's res-32 path), where a CPU spends a
    # quarter of a 64^2 step's time in the tiny UNet's attention
    x1 = rng.uniform(-0.6, 0.6, (4, 3, 32, 32)).astype(np.float32)
    t = np.array([3.0, 97.0, 40.0, 61.0], np.float32)
    key = jax.random.PRNGKey(5)
    white = np.asarray(jax.random.normal(key, (4, 3, 64, 64), jnp.float32))  # tiled to 64^2
    np.savez(tmp / "in.npz", L=L, seed=SEED, x1=x1, t=t, white=white)
    dryrun.run_ranks(2, ["--job", "grads", "--inputs", str(tmp / "in.npz"),
                         "--out", str(tmp / "out.npz")],
                     device="cpu", backend="gloo", timeout=TIMEOUT)
    return dict(L=L, x1=x1, t=t, key=key, white=white), dict(np.load(tmp / "out.npz"))


def test_two_rank_step_matches_jax_single_device(two_rank_grads):
    """2 gloo ranks, 2 rows each, on the tiny two-head UNet: the summed loss
    to rtol 1e-5 of JAX's single-device loss_fn on the same weights, x1, t
    and white noise, the UNet's gradients within 1e-4 x their global norm,
    the (tau, s, e) gradients to rtol 1e-3 / atol 1e-5."""
    inputs, got = two_rank_grads
    L, x1, t, key = inputs["L"], inputs["x1"], inputs["t"], inputs["key"]

    cfg = dryrun.grads_config(False)
    jcfg = jp.TrainConfig(nb_steps=cfg.nb_steps, noise_type=cfg.noise_type,
                          scheduler_gamma=cfg.scheduler_gamma,
                          gamma_defaults=cfg.gamma_defaults, out_channel=6)
    jm = J.UNet2D(J.UNet2DConfig(**TINY, in_channels=3, out_channels=6))
    params = flax_from_state_dict(_tiny_port_model().state_dict())
    sp = jnp.asarray(cfg.gamma_defaults, jnp.float32)

    def grads(params, sp, x1, t, key, L):
        step, _ = jp.make_train_step(jm.apply, jcfg, L)
        return jax.value_and_grad(step.loss_fn, argnums=(0, 1), has_aux=True)(
            params, sp, x1, t, key)

    with jax.default_matmul_precision("float32"):
        (loss, _), (g_model, g_sp) = jax.jit(grads)(params, sp, jnp.asarray(x1),
                                                    jnp.asarray(t), key, jnp.asarray(L))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    want = state_dict_from_flax(jax.device_get(g_model))
    norm = float(np.sqrt(sum(float(np.sum(np.square(v.numpy()))) for v in want.values())))
    for name, w in want.items():
        err = float(np.abs(got[f"g/{name}"] - w.numpy()).max())
        assert err < 1e-4 * max(norm, 1.0), (name, err, norm)
    np.testing.assert_allclose(got["sched"], np.asarray(g_sp), rtol=1e-3, atol=1e-5)


def test_two_ranks_sum_the_split_batch(two_rank_grads):
    """The 2 ranks' summed gradients are those of the same two row blocks
    stepped in turn in one process (``dryrun.split_grads``) within 1e-5 x
    their norm, the UNet's and the (tau, s, e) alike: the all-reduce adds
    the blocks' fp32 gradients and nothing else. What separates both from
    one pass over the whole batch is fp32 rounding of the other partition,
    held to the bounds of the test above and printed."""
    inputs, got = two_rank_grads
    cfg = dryrun.grads_config(False)
    L = torch.from_numpy(inputs["L"])
    x1, t, white = (torch.from_numpy(np.array(inputs[k])) for k in ("x1", "t", "white"))
    grads = {}
    for how in ("whole", "split"):
        model = _tiny_port_model().train()
        step, init = tp.make_train_step(cfg, L)
        state = init(model, torch.Generator().manual_seed(0))
        if how == "whole":
            step.loss_fn(model, state.sched_params, x1, t, white).backward()
        else:
            dryrun.split_grads(cfg, L, model, state.sched_params, x1, t, white, 2)
        grads[how] = ({k: p.grad.numpy() for k, p in model.named_parameters()},
                      state.sched_params.grad.numpy())
    (gw, sw), (gs, ss) = grads["whole"], grads["split"]
    norm = float(np.sqrt(sum(float(np.sum(np.square(v.astype(np.float64)))) for v in gs.values())))
    s_norm = float(np.linalg.norm(ss))
    ranks_err = max(float(np.abs(got[f"g/{k}"] - v).max()) for k, v in gs.items())
    whole_err = max(float(np.abs(gw[k] - v).max()) for k, v in gs.items())
    s_ranks_err = float(np.abs(got["sched"] - ss).max())
    s_whole_err = float(np.abs(sw - ss).max())
    print(f"UNet grads: ranks vs split {ranks_err / norm:.3e} x norm, whole vs split "
          f"{whole_err / norm:.3e}; (tau, s, e): ranks vs split {s_ranks_err / s_norm:.3e} x "
          f"norm, whole vs split {s_whole_err / s_norm:.3e}")
    assert ranks_err <= 1e-5 * norm
    assert s_ranks_err <= 1e-5 * s_norm
    assert whole_err <= 1e-4 * norm
    np.testing.assert_allclose(sw, ss, rtol=1e-3, atol=1e-5)


def test_one_rank_is_the_non_distributed_step_bit_for_bit():
    """One gloo rank through DDP, the summed-gradient hook and the
    all-reduces: the same losses, weights, optimizer states and (tau, s, e)
    as the step without a process group, bit for bit, over 2 steps."""
    cfg = tp.TrainConfig(nb_steps=100, noise_type="gaussianBN", scheduler_gamma="sigmoid",
                         gamma_defaults=(0.2, 0.0, 3.0), optimize_scheduler_param=True,
                         out_channel=6, grad_clip=1.0)
    L = dryrun._tril_L()
    batch = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 3, 32, 32))
                             .astype(np.float32))
    plain = tp.PixelTrainer(_tiny_port_model(), cfg, L)
    want = [plain.step(batch, (0, s))["loss"] for s in range(2)]
    tdist.init_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0, device="cpu")
    try:
        dp = tp.PixelTrainer(_tiny_port_model(), cfg, L, mesh=tdist.global_mesh())
        assert isinstance(dp.state.forward, torch.nn.parallel.DistributedDataParallel)
        got = [dp.step(batch, (0, s))["loss"] for s in range(2)]
    finally:
        tdist.shutdown()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a_sd, b_sd = dp.state.state_dict(), plain.state.state_dict()
    for k, v in b_sd["model"].items():
        assert torch.equal(a_sd["model"][k], v), k
    assert torch.equal(a_sd["sched_params"], b_sd["sched_params"])
    for opt in ("opt", "sched_opt"):
        for i, st in b_sd[opt]["state"].items():
            for k, v in st.items():
                assert torch.equal(a_sd[opt]["state"][i][k], v), (opt, i, k)


# ----------------------------- the pixel CLI ----------------------------------

# at 32^2 (the correlated noise's res-32 path): a CPU spends most of a 64^2
# step in the tiny UNet's attention
CLI = ["--dataset=tinycat", "--res=32", "--tiny_model", "--noise_type=gaussianBN",
       "--scheduler_gamma=sigmoid", "--scheduler_param=0.2", "--out_channel=6",
       "--compute_dtype=float32", "--nb_steps=10", "--device=cpu", "--train_or_test=train",
       "--epochs=1", "--max_steps=2", "--lr=1e-4", "--grad_clip=1.0"]
RUN = os.path.join("results_gaussianBN", "tinycat_gaussianBN_sigmoid_0.2_0_3_outc6_seed0")
# the ranks' interpreter: TensorBoard hidden (its import pulls in TensorFlow,
# seconds per process), then the CLI
LAUNCH = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
          "from bndm_tpu_torch.cli.{} import main; main(sys.argv[1:])")


def _run_cli_ranks(n, args, cwd, cli="iadb_bn"):
    port = dryrun.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", LAUNCH.format(cli), *args,
         f"--coordinator_address=127.0.0.1:{port}", f"--num_processes={n}",
         f"--process_id={r}"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), outs
    return outs


def test_cli_two_ranks_match_one_process(tmp_path):
    """The pixel CLI's train mode on 2 gloo ranks (2 rows each of a global
    batch of 4, 2 steps): rank 0's model.npz within 1e-5 of one process
    stepping the same global batches (rank 0's rows, then rank 1's) with
    the same keys; only rank 0 wrote the run's files."""
    from bndm_tpu_torch.cli import iadb_bn
    from bndm_tpu_torch.cli.common import load_params
    from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset, \
        make_synthetic_folder

    make_synthetic_folder(str(tmp_path / "data" / "tinycat"), n=8, res=32)
    L = dryrun._tril_L()
    os.makedirs(tmp_path / "bluenoise")
    np.savez(tmp_path / "bluenoise" / "cov_gaussianBN_L_res64_d3.npz", x=L)
    outs = _run_cli_ranks(2, CLI + ["--batch_size=4"], tmp_path)
    assert "output_folder:" in outs[0] and "output_folder:" not in outs[1]
    got = load_params(str(tmp_path / RUN / "model.npz"))

    opt = iadb_bn.parse_args(CLI + ["--batch_size=4", "--data_root", str(tmp_path / "data")])
    torch.manual_seed(opt.seed)
    model, tcfg, _, _ = iadb_bn.build(opt, "cpu")
    trainer = tp.PixelTrainer(model.train(), tcfg, L, seed=opt.seed)
    ds = ImageFolderDataset(str(tmp_path / "data" / "tinycat"), 32, random_flip=True)
    shards = [BatchLoader(ds, 2, seed=opt.seed, shard_index=r, shard_count=2).epoch(0)
              for r in range(2)]
    for step, blocks in zip(range(2), zip(*shards)):
        trainer.step(torch.from_numpy(np.concatenate(blocks)), (opt.seed, step))
    want = flax_from_state_dict(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got)) > 0
    for path, w in leaves:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_ddim_cli_on_two_ranks(tmp_path):
    """The DDIM CLI (the HF-style train loop the latent CLI shares; the
    latent step's data parallelism is the dry run's leg 6) on 2 gloo ranks:
    train, 2 rows a rank for 2 steps, rank 0 writing the tree, the
    checkpoint and the losses; then test, 1 sample a rank, gathered, rank 0
    writing both images."""
    from bndm_tpu_torch.data.imagefolder import make_synthetic_folder

    make_synthetic_folder(str(tmp_path / "data" / "tinycat"), n=8, res=32)
    out = tmp_path / "results_gaussianBN" / "run"
    common = ["--resolution=32", "--dataset_name=tinycat", "--tiny_model", "--output_dir=run",
              "--compute_dtype=float32", "--ddpm_num_inference_steps=4", "--device=cpu"]
    _run_cli_ranks(2, common + ["--train_or_test=train", "--train_batch_size=4",
                                "--num_epochs=1", "--max_steps=2", "--lr_warmup_steps=0"],
                   tmp_path, "ddim")
    for f in ("unet/model.npz", "unet/diffusion_pytorch_model.safetensors", "losses.txt",
              "checkpoints/2/state.pt", "logs/metrics.jsonl"):
        assert (out / f).exists(), f
    losses = np.loadtxt(out / "losses.txt")
    assert losses.shape == (2,) and np.isfinite(losses).all()
    outs = _run_cli_ranks(2, common + ["--train_or_test=test", "--eval_batch_size=2",
                                       "--test_samples=2"], tmp_path, "ddim")
    assert len(list((out / "images").glob("*.png"))) == 2
    assert "batch 0: 2 samples" in outs[0] and "batch 0" not in outs[1]


# ------------------------------- the dry run ----------------------------------


def test_dryrun_multichip_two_ranks():
    """The seven legs on 2 gloo ranks, each line printed by rank 0."""
    out = dryrun.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    for leg in ("one DP train step OK", "hybrid 2x1 (replica, data) step OK",
                "microbatched sampling OK", "cached (feature-reuse) sampling OK",
                "conditional (x_c) train + cached sampling OK",
                "latent train step + microbatched VAE decode OK",
                "EMA + grad-accum (k=2) DDIM train OK"):
        assert f"dryrun_multichip(2): {leg}" in out, leg
