"""The port's HF-style pipeline surfaces against the JAX package, and its DDIM
and latent CLIs end to end, on the CPU.

The LR schedules (all four kinds), the EMA, ``hf_adamw`` (one step, and a
2-step accumulation) against optax, the argparse surface, and the
``save_pretrained`` trees written by either package and read by the other.
Then ``bndm_tpu_torch.cli.ddim`` and ``bndm_tpu_torch.cli.latent_iadb`` with
``--device=cpu`` in the six flows of tests/test_cli_ddim_latent.py (DDIM
plain, int8-static + static GN, cached; latent plain, int8-static + static
GN, cached), each trained then tested, with the same artifacts checked
(DDIM at 32^2 pixels: the tiny UNet's attention costs a CPU 16x more at
64^2); the DDIM run's weights read back by the JAX package.

Tolerances: the schedules, the EMA and the optimizer to 1e-6; the trees'
weights exact.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bndm_tpu.cli import hf_args as JA
from bndm_tpu.models import unet2d as J
from bndm_tpu.models.convert import ddim_scheduler_config as j_ddim_sched
from bndm_tpu.models.convert import export_pipeline_tree as j_export_tree
from bndm_tpu.train import ema as JE
from bndm_tpu.train import schedules_lr as JL
from bndm_tpu_torch.cli import hf_args as TA
from bndm_tpu_torch.cli.common import load_tree_unet_params
from bndm_tpu_torch.models import convert as TCV
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.convert import state_dict_from_flax
from bndm_tpu_torch.train import ema as TE
from bndm_tpu_torch.train import schedules_lr as TL
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet import TINY, random_flax_params

# ------------------------ schedules, EMA, optimizer --------------------------


@pytest.mark.parametrize("warmup", [0, 5])
@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "cosine", "linear"])
def test_lr_schedule_matches_jax(kind, warmup):
    want = JL.hf_lr_schedule(kind, 3e-4, warmup, 40)
    got = TL.hf_lr_schedule(kind, 3e-4, warmup, 40)
    for step in range(0, 45):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0,
                                   err_msg=f"{kind} step {step}")


def test_ema_matches_jax():
    """ema_decay over the warmup and past max_decay, and three ema_update
    steps: to 1e-6; the EMA copy does not alias the live weights."""
    for step in (0, 1, 2, 10, 10**6):
        np.testing.assert_allclose(TE.ema_decay(step, 0.999), float(JE.ema_decay(
            jnp.int32(step), 0.999)), rtol=1e-6)
    model = torch.nn.Linear(5, 3)
    state = TE.ema_init(model)
    assert all(state.params[n].data_ptr() != p.data_ptr() for n, p in model.named_parameters())
    jstate = JE.ema_init({n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()})
    for i in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(np.random.default_rng(i).standard_normal(p.shape)
                                        .astype(np.float32)))
        TE.ema_update(state, model, 0.99, 1.0, 0.75)
        jstate = JE.ema_update(jstate, {n: jnp.asarray(p.detach().numpy())
                                        for n, p in model.named_parameters()}, 0.99, 1.0, 0.75)
    assert state.step == int(jstate.step) == 3
    for n in state.params:
        np.testing.assert_allclose(state.params[n].numpy(), np.asarray(jstate.params[n]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_hf_adamw_matches_optax(accum):
    """hf_adamw from the same flags on both sides, fed the same gradients
    (some of global norm above 1, so the clip acts) for 4 calls: the weights
    after every call to 1e-6. With accumulation the weights move on every
    second call only, on the mean gradient, and the schedule counts
    updates."""
    argv = ["--learning_rate=3e-3", "--lr_warmup_steps=1", "--lr_scheduler=cosine",
            f"--gradient_accumulation_steps={accum}", "--adam_weight_decay=1e-2"]
    jopt = JL.hf_adamw(JA.parse_args(argv), 8)
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    topt = TL.hf_adamw(TA.parse_args(argv), 8)(tparams.values())
    for call in range(4):
        scale = 3.0 if call % 2 else 0.05  # above and below the clip's norm of 1
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in init.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        moved = topt.step()
        assert moved == ((call + 1) % accum == 0)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"call {call} {k}")
    assert topt.count == 4 // accum


def test_hf_args_match_jax():
    """Every flag of the JAX parser with its default, plus --device
    (default cuda); resolve_args maps --mixed_precision as JAX does."""
    j = {a.dest: a.default for a in JA.build_parser()._actions if a.dest != "help"}
    t = {a.dest: a.default for a in TA.build_parser()._actions if a.dest != "help"}
    assert t.pop("device") == "cuda"
    assert t == j
    for argv in ([], ["--mixed_precision=no"], ["--mixed_precision=fp16"],
                 ["--mixed_precision=bf16", "--compute_dtype=float32"]):
        assert TA.parse_args(argv).compute_dtype == JA.parse_args(argv).compute_dtype
    with pytest.raises(SystemExit):
        TA.parse_args(["--cache_interval=1"])


# ------------------------------ pipeline trees -------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    jm = J.UNet2D(J.UNet2DConfig(**TINY, out_channels=6))
    return jax.device_get(random_flax_params(jm, jnp.zeros((1, 3, 16, 16)), jnp.zeros(1),
                                             seed=30))


def test_safetensors_cross_read(tmp_path):
    """A ``.safetensors`` file of every exportable dtype, written by either
    package, reads back in the other with the same values and metadata-free
    names."""
    from bndm_tpu.models.convert import load_safetensors as j_load
    from bndm_tpu.models.convert import save_safetensors as j_save

    rng = np.random.default_rng(31)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "h": rng.standard_normal(5).astype(np.float16),
              "d": rng.standard_normal((2, 2)), "i": np.arange(6, dtype=np.int64).reshape(2, 3),
              "j": np.arange(3, dtype=np.int32), "u": np.arange(4, dtype=np.uint8),
              "b": np.array([True, False])}
    for write, read, name in ((TCV.save_safetensors, j_load, "port"),
                              (j_save, TCV.load_safetensors, "jax")):
        path = str(tmp_path / f"{name}.safetensors")
        write(arrays, path, metadata={"format": "pt"})
        got = read(path)
        assert got.keys() == arrays.keys()
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (name, k)
    TCV.save_safetensors({"t": torch.arange(3.0)}, str(tmp_path / "t.safetensors"))
    np.testing.assert_array_equal(j_load(str(tmp_path / "t.safetensors"))["t"], [0.0, 1.0, 2.0])


@pytest.mark.parametrize("pipeline", ["DDIMPipeline", "IADBPipeline"])
def test_pipeline_trees_cross_load(tmp_path, tiny_params, pipeline):
    """A ``save_pretrained`` tree written by JAX loads in the port with the
    same weights and config, and the port's loads in JAX; the json files of
    the two are the same bytes."""
    from bndm_tpu.cli.common import load_tree_unet_params as j_load_tree
    from bndm_tpu.models.convert import iadb_scheduler_config as j_iadb_sched

    jcfg = J.UNet2DConfig(**TINY, out_channels=6)
    if pipeline == "DDIMPipeline":
        jsched, tsched = j_ddim_sched(500, "linear", "sample"), TCV.ddim_scheduler_config(
            500, "linear", "sample")
    else:
        jsched, tsched = j_iadb_sched(100), TCV.iadb_scheduler_config(100)
    j_export_tree(str(tmp_path / "jax"), tiny_params, jcfg, 16, jsched, pipeline)
    sd, tcfg = load_tree_unet_params(str(tmp_path / "jax"))
    want = state_dict_from_flax(tiny_params)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(P.UNet2DConfig(**TINY, out_channels=6))
    P.UNet2D(tcfg).load_state_dict(sd, strict=True)

    TCV.export_pipeline_tree(str(tmp_path / "port"), sd, tcfg, 16, tsched, pipeline)
    params, jcfg2 = j_load_tree(str(tmp_path / "port"))
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    got, ref = jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(
        tiny_params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(np.array_equal(np.asarray(a), b) for (_, a), (_, b) in zip(got, ref))
    for f in ("unet/config.json", "scheduler/scheduler_config.json", "model_index.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ------------------------------- the CLIs ------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Eight synthetic 64^2 images and a random triangular L. TensorBoard is
    hidden: where it is installed its import pulls in TensorFlow (seconds);
    the runs log to JSONL."""
    from bndm_tpu_torch.data.imagefolder import make_synthetic_folder

    root = tmp_path_factory.mktemp("hf_cli")
    make_synthetic_folder(str(root / "data" / "tinycat"), n=8, res=64)
    L = np.tril(np.random.default_rng(0).standard_normal((4096, 4096)).astype(np.float32)
                * 0.01)
    np.fill_diagonal(L, 1.0)
    os.makedirs(root / "bluenoise")
    np.savez(root / "bluenoise" / "cov_gaussianBN_L_res64_d3.npz", x=L)
    hidden = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError
    yield root
    if hidden is False:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = hidden


SERVE_INT8_GN = ["--conv_int8", "--int8_mode=static", "--static_gn"]
FLOWS = {  # name: (pipeline, test flags)
    "ddim": ("ddim", []),
    "ddim-int8-static-gn": ("ddim", SERVE_INT8_GN),
    "ddim-cached": ("ddim", ["--cache_interval=2"] + SERVE_INT8_GN),
    "latent": ("latent", []),
    "latent-int8-static-gn": ("latent", SERVE_INT8_GN),
    "latent-cached": ("latent", ["--cache_interval=2"]),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cli_train_then_test(workdir, monkeypatch, capsys, flow):
    pipeline, flags = FLOWS[flow]
    monkeypatch.chdir(workdir)
    name = flow.replace("-", "_")
    if pipeline == "ddim":
        from bndm_tpu_torch.cli.ddim import main

        common = ["--dataset_name=tinycat", "--resolution=32", "--tiny_model",
                  f"--output_dir={name}", "--compute_dtype=float32",
                  "--ddpm_num_inference_steps=10", "--device=cpu"]
        out = workdir / "results_gaussianBN" / name
    else:
        from bndm_tpu_torch.cli.latent_iadb import main

        common = ["--dataset_name=tinycat", "--resolution=256", "--tiny_model",
                  f"--output_dir={name}", "--compute_dtype=float32", "--noise_type=gaussianBN",
                  "--out_channels=4", "--ddpm_num_steps=100", "--ddpm_num_inference_steps=10",
                  "--device=cpu"]
        out = workdir / "results_gaussianBN" / f"{name}_gaussianBN"
    main(common + ["--train_or_test=train", "--train_batch_size=4", "--num_epochs=1",
                   "--max_steps=2", "--lr_warmup_steps=0"])
    for f in ("unet/model.npz", "unet/config.json", "unet/diffusion_pytorch_model.safetensors",
              "scheduler/scheduler_config.json", "model_index.json", "losses.txt",
              "checkpoints/2/state.pt", "logs/metrics.jsonl"):
        assert (out / f).exists(), f
    if pipeline == "latent":
        meta = json.loads((workdir / "data" / "tinycat_latent_cache" / "meta.json").read_text())
        assert meta == {"count": 16, "shape": [4, 32, 32], "dtype": "float16"}
    capsys.readouterr()
    main(common + ["--train_or_test=test", "--eval_batch_size=2", "--test_samples=2"] + flags)
    text = capsys.readouterr().out
    assert len(list((out / "images").glob("*.png"))) == 2
    assert ("serving calibration" in text) == ("--static_gn" in flags)
    seqs = len(list((out / "seqs").glob("*.png")))
    if pipeline == "ddim":  # frames every 25 of 250 named steps; none when cached
        assert seqs == (0 if "--cache_interval=2" in flags else 11)
    else:
        assert seqs == 0
    if flow == "ddim":
        # the run's weights, read by the JAX package from either file
        from bndm_tpu.cli.common import load_params as j_load_params
        from bndm_tpu.models.convert import load_pretrained_unet as j_load_pretrained

        npz = j_load_params(str(out / "unet" / "model.npz"))
        tree, _ = j_load_pretrained(str(out / "unet"))
        a, b = jax.tree_util.tree_leaves(npz), jax.tree_util.tree_leaves(tree)
        assert len(a) == len(b) > 0 and all(np.array_equal(np.asarray(u), np.asarray(v))
                                            for u, v in zip(a, b))


@pytest.mark.parametrize("module", ["ddim", "latent_iadb"])
def test_cli_multi_host_flags_raise(module):
    """The multi-host flags start a data-parallel run; a coordinator without
    the process count and id raises before anything is built."""
    import importlib

    main = importlib.import_module(f"bndm_tpu_torch.cli.{module}").main
    with pytest.raises(ValueError, match="needs --coordinator_address, --num_processes"):
        main(["--coordinator_address=localhost:1234", "--device=cpu"])
