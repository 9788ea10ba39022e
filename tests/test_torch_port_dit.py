"""The port's DiT (``bndm_tpu_torch/models/dit.py``) on the CPU at a tiny
size (depth 2, hidden 64, 4 heads of 16, patch 2), held to the benchmark's
plain float32 reference (``perfbench/reference/dit.py``), the one reference
of the model: the forward on seeded random weights, one latent train step's
loss and gradients through the unchanged ``make_latent_train_step``; the
published DiT-XL/2 size on the meta device; adaLN-Zero's zero output; the
attention counter and the spans; serving's cast; and the latent CLI with
``--backbone DiT-XL/2 --tiny_model``: train, resume, test, and each of the
UNet's serving flags refused.

Tolerances: the forward to 1e-5 of the output's largest magnitude (the same
float32 operations in another order: SDPA's math path against the written-out
softmax; measured ~1e-7); the train step's loss to 1e-5 and each gradient
leaf's norm to 1e-4 of the median leaf's (float32 products of different
order, and the reference's noise through float64; measured: the loss equal, ~1e-7)."""

import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bndm_tpu_torch.models import dit as D
from bndm_tpu_torch.utils.timing import take_spans
from perfbench import weights
from perfbench.reference import dit as R
from perfbench.reference import nets
from perfbench.reference import train as RT

XL2_PARAMETERS = 673_681_568  # models.py's 675,129,632 less y_embedder and pos_embed


@pytest.fixture(autouse=True)
def _one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _settings(cfg):
    """The reference's settings of a ``DiTConfig``."""
    return {k: getattr(cfg, k) for k in ("input_size", "patch_size", "in_channels",
                                         "hidden_size", "depth", "num_heads", "mlp_ratio",
                                         "learn_sigma", "frequency_embedding_size", "norm_eps")}


def _model(cfg, seed):
    P = weights.make(R.dit_spec(_settings(cfg)), seed, "cpu")
    m = D.DiT(cfg)
    m.load_state_dict(P, strict=True)
    return m, P


@pytest.mark.parametrize("learn_sigma,size", [(True, 8), (False, 16)])
def test_forward_matches_the_reference(learn_sigma, size):
    cfg = D.dit_config("tiny", input_size=size, learn_sigma=learn_sigma)
    m, P = _model(cfg, 5)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, size, size, generator=gen)
    t = torch.rand(3, generator=gen)
    with torch.no_grad():
        got, ref = m(x, t), R.dit(P, _settings(cfg), x, t, nets.exact)
    assert got.shape == ref.shape == (3, cfg.out_channels, size, size)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


class _KeepGrads:
    """An optimizer that keeps the gradients it is handed and moves
    nothing."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        self.grads = [p.grad.clone() for p in self.params]


def test_a_latent_train_step_matches_the_reference():
    from bndm_tpu_torch.train.latent import LatentTrainConfig, make_latent_train_step

    cfg = D.dit_config("tiny", input_size=32)
    m, P = _model(cfg, 9)
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((4096, 4096)).astype(np.float32) * 0.01)
    np.fill_diagonal(L, 1.0)
    L = torch.from_numpy(L)
    data = torch.from_numpy(rng.standard_normal((4, 4, 32, 32)).astype(np.float32))
    key = (2**31 + 3, 0)
    step, init_state = make_latent_train_step(
        LatentTrainConfig(ddpm_num_steps=1000, noise_type="gaussianBN", out_channels=8), L,
        _KeepGrads)
    state = init_state(m.train())
    loss = float(step(state, data, key)["loss"])
    spec = {"nb_steps": 1000, "scheduler_gamma": "linear"}
    ref_loss, ref_grads = RT.loss_and_grads(P, R.dit, _settings(cfg), spec, data, key, L)
    assert abs(loss - ref_loss) / abs(ref_loss) < 1e-5
    names = [n for n, _ in m.named_parameters()]
    got = {n: float(g.norm()) for n, g in zip(names, state.opt.grads)}
    ref = {n: float(ref_grads[n].norm()) for n in names}
    med = float(np.median(list(ref.values())))
    assert med > 0
    assert max(abs(got[n] - ref[n]) / max(ref[n], med) for n in names) < 1e-4


def test_the_published_size_on_the_meta_device():
    m = D.DiT(D.dit_config("DiT-XL/2"), device="meta")
    cfg = m.cfg
    assert (cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.patch_size, cfg.input_size,
            cfg.out_channels) == (28, 1152, 16, 2, 32, 8)
    assert int(cfg.hidden_size * cfg.mlp_ratio) == 4608
    assert sum(p.numel() for p in m.parameters()) == XL2_PARAMETERS
    spec = R.dit_spec(_settings(cfg))
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == spec
    # models.py's names: a published state dict less its label table and its
    # position table is exactly this one
    published = set(spec) | {"y_embedder.embedding_table.weight", "pos_embed"}
    assert set(m.state_dict()) == published - {"y_embedder.embedding_table.weight",
                                                "pos_embed"}
    assert m.pos_embed.shape == (1, 256, 1152)
    assert sum(math.prod(s) for k, s in spec.items() if k.startswith("blocks.0.")) == 23_905_152


def test_adaln_zero_starts_at_a_zero_output():
    m = D.DiT(D.dit_config("tiny", input_size=8))
    for b in m.blocks:
        assert not b.adaLN_modulation[-1].weight.any()
    x = torch.randn(2, 4, 8, 8)
    with torch.no_grad():
        out = m(x, torch.tensor([0.2, 0.7]))
    assert out.shape == (2, 8, 8, 8) and not out.any()
    assert m.x_embedder.proj.weight.any() and m.blocks[0].attn.qkv.weight.any()
    torch.testing.assert_close(m.pos_embed[0], R.pos_table(64, 4), rtol=0, atol=0)


def test_attention_calls_and_spans():
    from bndm_tpu_torch.samplers.iadb import sample_iadb

    cfg = D.dit_config("tiny", input_size=8)
    m, _ = _model(cfg, 3)
    x = torch.randn(2, 4, 8, 8)
    before = D.attention.calls
    with torch.no_grad():
        m(x, 0.5)
    assert D.attention.calls - before == cfg.depth
    take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        sample_iadb(m, x, nb_steps=2, two_head=True)
    spans = [s for s in take_spans() if s.name.startswith("bndm.dit.")]
    assert [s.name for s in spans] == 2 * (["bndm.dit.embed"] + cfg.depth * ["bndm.dit.block"]
                                           + ["bndm.dit.final"])
    assert {s.parent for s in spans} == {"bndm.sample.step"}
    assert D.attention.calls - before == 3 * cfg.depth


def test_serving_build_model_takes_a_dit_and_casts_it():
    from bndm_tpu_torch.serving import build_model

    cfg = D.dit_config("tiny", input_size=8, dtype="bfloat16")
    _, P = _model(cfg, 4)
    eager = D.DiT(cfg)
    eager.load_state_dict(P, strict=True)
    served = build_model(cfg, P, "cpu")
    assert isinstance(served, D.DiT) and not served.training
    assert served.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert served.pos_embed.dtype == torch.float32
    x = torch.randn(2, 4, 8, 8)
    with torch.no_grad():
        assert torch.equal(served(x, 0.3), eager(x, 0.3))


# ------------------------------- the CLI ------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Eight synthetic 64^2 images and a random triangular L; TensorBoard
    hidden (its import pulls in TensorFlow where installed: the runs log to
    JSONL)."""
    from bndm_tpu_torch.data.imagefolder import make_synthetic_folder

    root = tmp_path_factory.mktemp("dit_cli")
    make_synthetic_folder(str(root / "data" / "tinycat"), n=8, res=64)
    L = np.tril(np.random.default_rng(0).standard_normal((4096, 4096)).astype(np.float32)
                * 0.01)
    np.fill_diagonal(L, 1.0)
    os.makedirs(root / "bluenoise")
    np.savez(root / "bluenoise" / "cov_gaussianBN_L_res64_d3.npz", x=L)
    hidden = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None
    yield root
    if hidden is False:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = hidden


COMMON = ["--dataset_name=tinycat", "--resolution=256", "--tiny_model", "--backbone=DiT-XL/2",
          "--output_dir=dit", "--compute_dtype=float32", "--noise_type=gaussianBN",
          "--out_channels=4", "--ddpm_num_steps=100", "--ddpm_num_inference_steps=4",
          "--device=cpu"]
TRAIN = ["--train_or_test=train", "--train_batch_size=4", "--num_epochs=1",
         "--lr_warmup_steps=0"]


def test_cli_trains_resumes_and_tests_a_dit(workdir, monkeypatch, capsys):
    from bndm_tpu_torch.cli.latent_iadb import main

    monkeypatch.chdir(workdir)
    out = workdir / "results_gaussianBN" / "dit_gaussianBN"
    main(COMMON + TRAIN + ["--max_steps=2"])
    for f in ("dit/model.safetensors", "dit/config.json", "losses.txt",
              "checkpoints/2/state.pt"):
        assert (out / f).exists(), f
    assert not (out / "unet").exists()
    sd, cfg = D.load_tree(str(out))
    assert cfg == D.dit_config("tiny", input_size=32)
    assert set(sd) == set(R.dit_spec(_settings(cfg)))
    capsys.readouterr()
    main(COMMON + TRAIN + ["--max_steps=3", "--resume_from_checkpoint=latest"])
    assert "Resuming from checkpoint step 2" in capsys.readouterr().out
    assert (out / "checkpoints" / "3" / "state.pt").exists()
    main(COMMON + ["--train_or_test=test", "--eval_batch_size=2", "--test_samples=2"])
    assert len(list((out / "images").glob("*.png"))) == 2


@pytest.mark.parametrize("flags", [["--cache_interval=2"], ["--cache_depth=2"],
                                   ["--conv_int8"], ["--conv_int8", "--int8_mode=static"],
                                   ["--static_gn"], ["--attn_softmax_dtype=bfloat16"]])
def test_cli_refuses_the_unets_serving_tiers(flags):
    from bndm_tpu_torch.cli.latent_iadb import main

    with pytest.raises(SystemExit, match=flags[0].split("=")[0]):
        main(COMMON + ["--train_or_test=test"] + flags)
