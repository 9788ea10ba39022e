"""The port's iadb_bn CLI through the serving tiers, against the JAX CLI.

Tiny runs of both test modes with the tier flags (unconditional at res 32,
super-res at res 64, the size of its L), on weights JAX wrote, and the
flag checks, whose SystemExit messages must be the JAX CLI's.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from bndm_tpu.models import unet2d as J
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet import TINY, random_flax_params

CLI = ["--batch_size=2", "--tiny_model", "--noise_type=gaussianBN",
       "--scheduler_gamma=sigmoid", "--out_channel=6", "--compute_dtype=float32",
       "--nb_steps=4", "--train_or_test=test"]
UNCOND = ["--res=32", "--dataset=tinycat", "--scheduler_param=1000.0", "--test_samples=2",
          "--save_all_samples"]
SUPERRES = ["--res=64", "--dataset=tinychurch", "--scheduler_param=0.2", "--is_conditional",
            "--conditional_type=superres"]


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """Run folders with JAX-written weights for both test modes, an L (the
    identity: the tiers' checks need none other) and two 64x64 super-res
    test images."""
    from bndm_tpu.cli.common import save_params
    from bndm_tpu_torch.data.imagefolder import make_synthetic_folder

    root = tmp_path_factory.mktemp("tiers_cli")
    bn = root / "bluenoise"
    bn.mkdir()
    np.savez(bn / "cov_gaussianBN_L_res64_d3.npz", x=np.eye(4096, dtype=np.float32))
    for in_ch, folder, seed in (
            (3, "results_gaussianBN/tinycat_gaussianBN_sigmoid_1000.0_0_3_outc6_seed0", 7),
            (6, "results_gaussianBN_superres/tinychurch_gaussianBN_sigmoid_0.2_0_3_outc6_seed0",
             8)):
        jm = J.UNet2D(J.UNet2DConfig(**TINY, in_channels=in_ch, out_channels=6))
        save_params(str(root / folder / "model.npz"),
                    random_flax_params(jm, jnp.zeros((1, in_ch, 16, 16)), jnp.zeros(1),
                                       seed=seed))
    make_synthetic_folder(str(root / "data" / "tinychurch_test"), n=2, res=64)
    return root


@pytest.mark.parametrize("mode,flags", [
    ("uncond", ["--conv_int8", "--attn_softmax_dtype=bfloat16", "--cache_interval=2",
                "--gn_carry", "--microbatch=1"]),
    ("uncond", ["--conv_int8", "--static_gn", "--cache_interval=3", "--cache_depth=1"]),
    ("uncond", ["--conv_int8", "--int8_mode=dynamic", "--microbatch=1"]),
    ("superres", ["--conv_int8", "--static_gn", "--cache_interval=2",
                  "--attn_softmax_dtype=bfloat16"]),
    ("superres", ["--conv_int8", "--gn_carry", "--cache_interval=2", "--microbatch=1"])])
def test_cli_serves_through_the_tiers(run_root, monkeypatch, capsys, mode, flags):
    """Tiny runs of both test modes with the tier flags: calibration where
    a tier needs it, one image a sample, finite super-res metrics; super-res
    leaves --gn_carry out, as the JAX CLI does, and says so."""
    from bndm_tpu_torch.cli.iadb_bn import main

    monkeypatch.chdir(run_root)
    out = main(CLI + (UNCOND if mode == "uncond" else SUPERRES) + flags
               + [f"--bluenoise_dir={run_root / 'bluenoise'}", "--device=cpu"])
    text = capsys.readouterr().out
    calibrated = "--int8_mode=dynamic" not in flags
    assert ("serving calibration:" in text) == calibrated
    if mode == "uncond":
        assert len(os.listdir(os.path.join(out, "tinycat_iadb_gwn2gbn_steps4", "images"))) == 2
        assert text.count("samples in") == 1
    else:
        m = re.search(r"ssim: (\S+), psnr: (\S+), l2: (\S+), l1: (\S+)$", text, re.M)
        assert text.count("1 sample in") == 2
        assert ("--gn_carry: not applied in super-res" in text) == ("--gn_carry" in flags)
        assert all(math.isfinite(float(v.rstrip(","))) for v in m.groups())


@pytest.mark.parametrize("mode,flags", [
    ("uncond", ["--static_gn", "--scheduler_alpha=cosine"]),
    ("uncond", ["--gn_carry", "--static_gn", "--cache_interval=2"]),
    ("uncond", ["--gn_carry"]),
    ("superres", ["--static_gn", "--scheduler_alpha=cosine"])])
def test_cli_flag_checks_match_jax(run_root, monkeypatch, mode, flags):
    from bndm_tpu.cli.iadb_bn import main as j_main
    from bndm_tpu_torch.cli.iadb_bn import main as t_main

    monkeypatch.chdir(run_root)
    argv = CLI + (UNCOND if mode == "uncond" else SUPERRES) + flags + [
        f"--bluenoise_dir={run_root / 'bluenoise'}"]
    with pytest.raises(SystemExit) as j_err:
        j_main(argv)
    with pytest.raises(SystemExit) as t_err:
        t_main(argv + ["--device=cpu"])
    assert str(t_err.value) == str(j_err.value) and "--" in str(t_err.value)
