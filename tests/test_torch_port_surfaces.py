"""The PyTorch port's remaining surfaces against the JAX package, on the CPU.

The spectrum utilities; the figure CLI's noise and spectra (and its batched
supplementary draw against one realisation at a time) and the CLI's files;
the checkpoint-parity harness on both weight formats, written by the JAX
package's exporters, against JAX's own printout; the convenience API and
the lazy top-level surface; the demo's http server over a socket; and the
native image transform and the loader's batches, bit for bit JAX's.
"""

import ast
import json
import os
import re
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.utils import spectrum as jspec
from bndm_tpu_torch.utils import spectrum as tspec
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5

# ------------------------------- spectrum ------------------------------------


def test_spectrum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 24)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tspec.compute_fft(tx).numpy(), np.asarray(jspec.compute_fft(jx)),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jspec.power_spectrum(jx))
    np.testing.assert_allclose(tspec.power_spectrum(tx).numpy(), want, rtol=1e-5,
                               atol=1e-5 * want.max())
    (tc, tprof), (jc, jprof) = tspec.radial_power_profile(tx), jspec.radial_power_profile(jx)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=0)
    np.testing.assert_allclose(tprof, jprof, rtol=1e-5)


# --------------------------------- figs ---------------------------------------


@pytest.mark.parametrize("res,t_step,noise_type", [(64, 0, "gaussianBN"), (64, 500, "gaussianBN"),
                                                   (64, 999, "gaussianBN"),
                                                   (64, 0, "gaussianRN"),
                                                   (128, 0, "gaussianBN"),
                                                   (128, 500, "gaussianBN")])
def test_figs_noise_and_spectrum_match_jax(small_L, res, t_step, noise_type):
    """The figure's noise and |FFT| on JAX's white noise of the same key,
    against ``bndm_tpu/cli/figs.py::_noise_and_spectrum``, to 2e-5 (the
    spectrum relative to its largest value)."""
    from bndm_tpu.cli import figs as jfigs
    from bndm_tpu_torch.cli import figs as tfigs

    key = jax.random.PRNGKey(res + t_step)
    with jax.default_matmul_precision("float32"):
        jn, jf = jax.jit(jfigs._noise_and_spectrum, static_argnames=("t_step", "res",
                                                                      "noise_type"))(
            jnp.asarray(small_L), key, t_step=t_step, res=res, noise_type=noise_type)
    white = torch.from_numpy(np.array(jax.random.normal(key, (1, 3, res, res), jnp.float32)))
    tn, tf = tfigs.noise_and_spectrum(torch.from_numpy(small_L), white, t_step, noise_type)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=TOL)
    jf = np.asarray(jf)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=TOL * jf.max())


@pytest.mark.parametrize("repetitive", [True, False])
def test_supp_batched_draw_equals_one_realisation_at_a_time(small_L, repetitive):
    """One batched res-128 draw (K1 at M = R x 12 on CUDA) gives each
    realisation its own four tiles: the mean spectrum and the last noise
    of R = 3 realisations equal the draws of one realisation each."""
    from bndm_tpu_torch.cli import figs as tfigs

    L = torch.from_numpy(small_L)
    white = torch.randn((3, 3, 128, 128), generator=torch.Generator().manual_seed(1))
    avg, last = tfigs.supp_spectrum(L, white, repetitive)
    src = white[:, :, :64, :64].repeat(1, 1, 2, 2) if repetitive else white
    one = [tfigs.noise_and_spectrum(L, src[i:i + 1], 0) for i in range(3)]
    np.testing.assert_allclose(last.numpy(), one[-1][0][0].numpy(), rtol=0, atol=1e-6)
    want = torch.stack([m[0] for _, m in one]).mean(0)
    np.testing.assert_allclose(avg.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * float(want.max()))


def test_figs_cli(tmp_path, small_L):
    """The CLI at 4 realisations on the CPU: tests/test_figs_e2e.py's files
    and its check that the repetitive tiles' spectrum has the sparse grid of
    harmonics the independent tiles' lacks (a property of the tiling, so
    the fixture's L stands in for both generated ones: seconds saved)."""
    from bndm_tpu_torch.cli.figs import main

    out = tmp_path / "figs"
    os.makedirs(tmp_path / "bn")
    for tag in ("BN", "RN"):
        np.savez(tmp_path / "bn" / f"cov_gaussian{tag}_L_res64_d3.npz", x=small_L)
    spectra = main(["--output_dir", str(out), "--realizations", "4", "--bluenoise_dir",
                    str(tmp_path / "bn"), "--device", "cpu"])
    for f in ("gaussianBN_res64_0.png", "gaussianBN_res64_500.png", "gaussianBN_res64_999.png",
              "gaussianBN_res64_spectrum_0.png", "gaussianRN_res64_0.png", "inset.png",
              "gaussianBN_res128_repetitive_True_noise.png",
              "gaussianBN_res128_repetitive_False_noise.png"):
        assert (out / f).exists(), f
    rep = np.load(out / "gaussianBN_res128_repetitive_True_spectrum.npy")
    ind = np.load(out / "gaussianBN_res128_repetitive_False_spectrum.npy")
    assert (rep < 1e-3).mean() > (ind < 1e-3).mean()
    np.testing.assert_array_equal(rep, spectra[True])


# ------------------------------ parity_check -----------------------------------

_PROBE = re.compile(r"probe forward: shape \S+ \S+ \S+ \S+ mean (\S+) std (\S+) "
                    r"head0 mean (\S+) head1 mean (\S+)")


@pytest.fixture()
def tiny_ref_ckpts(tmp_path, monkeypatch):
    """A tiny two-head UNet's weights written by the JAX package's exporters
    (``export_reference_unet`` and a torch ``model.ckpt`` of
    ``convert_flax_params``), and both CLIs made to build that config."""
    monkeypatch.chdir(tmp_path)
    import bndm_tpu.models.unet2d as JU
    import bndm_tpu_torch.models.unet2d as TU
    from bndm_tpu.models.convert import convert_flax_params, export_reference_unet

    from test_torch_port_unet import TINY, random_flax_params

    jcfg = JU.UNet2DConfig(in_channels=3, out_channels=6, **TINY)
    tcfg = TU.UNet2DConfig(in_channels=3, out_channels=6, **TINY)
    params = random_flax_params(JU.UNet2D(jcfg), jnp.zeros((1, 3, 64, 64)), jnp.zeros((1,)),
                                seed=4)
    export_reference_unet(params, "ref.safetensors")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in convert_flax_params(params).items()},
               "model.ckpt")
    monkeypatch.setattr(JU, "unet_config_for_res", lambda *a, **k: jcfg)
    monkeypatch.setattr(TU, "unet_config_for_res", lambda *a, **k: tcfg)
    return tmp_path


@pytest.mark.parametrize("ckpt", ["model.ckpt", "ref.safetensors"])
def test_parity_check_matches_jax(tiny_ref_ckpts, capsys, ckpt):
    """The port's probe statistics within 5e-4 of the JAX harness's
    printout on the same file; the sample is written."""
    from bndm_tpu.cli.parity_check import main as jmain
    from bndm_tpu_torch.cli.parity_check import main as tmain

    with jax.default_matmul_precision("float32"):
        jmain(["--ckpt", ckpt, "--nb_steps", "2", "--output", f"j_{ckpt}.png"])
    want = [float(v) for v in _PROBE.search(capsys.readouterr().out).groups()]
    got = tmain(["--ckpt", ckpt, "--nb_steps", "2", "--output", f"t_{ckpt}.png",
                 "--device", "cpu"])
    line = _PROBE.search(capsys.readouterr().out)
    assert line is not None
    np.testing.assert_allclose([float(v) for v in line.groups()], want, rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["probe"], want, rtol=0, atol=5e-4)
    assert (tiny_ref_ckpts / f"t_{ckpt}_0.png").exists()


# ---------------------------------- api ----------------------------------------


def test_api_surface():
    """tests/test_demo_api.py's checks of the JAX API, on the port's."""
    from bndm_tpu import api as japi
    from bndm_tpu_torch.api import get_model, get_scheduler, get_scheduler_gamma, sample_iadb

    t = torch.arange(0, 1001.0)
    a = get_scheduler(t, "linear")
    g = get_scheduler_gamma(t, "sigmoid", (0.2, 0.0, 3.0))
    assert a.shape == g.shape == (1001,)
    np.testing.assert_allclose(g.numpy(), np.asarray(japi.get_scheduler_gamma(
        jnp.arange(0, 1001.0), "sigmoid", (0.2, 0.0, 3.0))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.numpy(), np.asarray(japi.get_scheduler(
        jnp.arange(0, 1001.0), "linear")), rtol=1e-6, atol=1e-7)

    m = get_model(res=64, out_channel=6, dtype="float32", device="meta")
    assert isinstance(m, torch.nn.Module)
    assert m.cfg.out_channels == 6
    assert m.cfg.block_out_channels == (128, 128, 256, 256, 512, 512)

    class FakeModel(torch.nn.Module):  # the module holds its weights: none here
        def forward(self, x, tt):
            return torch.cat([torch.ones_like(x), torch.zeros_like(x)], dim=1)

    out, _ = sample_iadb(FakeModel(), torch.zeros((1, 3, 8, 8)), 10, noise_type="gaussianBN",
                         out_channel=6)
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("entry", ["get_model", "dryrun_multichip"])
def test_library_entry_points_without_cuda_raise(monkeypatch, entry):
    """No quiet fallback: ``api.get_model`` and ``dryrun_multichip`` run on
    cuda unless the caller asks for another device, and without CUDA they
    raise before they build anything."""
    from bndm_tpu_torch import api, dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"get_model": lambda: api.get_model(res=64),
            "dryrun_multichip": lambda: dryrun.dryrun_multichip(2)}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _jax_surface_names():
    """The names of bndm_tpu/__init__.py's lazy surface (its dict's keys)."""
    tree = ast.parse(open(os.path.join(REPO, "bndm_tpu", "__init__.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    d = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict))
    return {k.value for k in d.keys}


def test_lazy_surface_has_the_jax_names():
    import bndm_tpu_torch

    assert set(bndm_tpu_torch._SURFACE) == _jax_surface_names()
    for name in bndm_tpu_torch._SURFACE:
        assert getattr(bndm_tpu_torch, name) is not None, name
    with pytest.raises(AttributeError):
        bndm_tpu_torch.no_such_name  # noqa: B018


# --------------------------------- demo -----------------------------------------

_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def test_demo_http_serving_e2e(tmp_path, monkeypatch):
    """The stdlib http front end over a socket with the tiny models: the
    page, the meta, frame PNGs (an index past the end clamps, an unknown
    method is 404), POST /api/generate for a new seed (the loaded models
    reused), a bad seed 400."""
    monkeypatch.chdir(tmp_path)
    import bndm_tpu_torch.cli.demo as demo

    opt = demo.parse_args(["--dataset=tinychurch", "--res=32", "--nb_steps=4", "--tiny_model",
                           "--compute_dtype=float32", "--port=0", "--device=cpu"])
    loaded = demo.load_all(opt, torch.device("cpu"))
    results = demo.generate_all(opt, loaded)
    assert set(results) == {"DDIM", "IADB", "BNDM"}
    assert all(v.ndim == 4 and v.shape[1:] == (3, 32, 32) for v in results.values())
    srv = demo.make_http_server(opt, results, loaded)
    monkeypatch.setattr(demo, "load_all", lambda *a: pytest.fail("server re-loaded models"))
    host, port = srv.server_address[:2]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://{host}:{port}"
    try:
        page = _NO_PROXY.open(f"{base}/", timeout=30).read().decode()
        assert all(m in page for m in ("DDIM", "IADB", "BNDM")) and 'type="range"' in page
        meta = json.loads(_NO_PROXY.open(f"{base}/api/meta", timeout=30).read())
        assert set(meta) == {"DDIM", "IADB", "BNDM"} and all(n >= 2 for n in meta.values())
        for path in ("/frame/BNDM/0.png", "/frame/IADB/999.png"):
            assert _NO_PROXY.open(base + path, timeout=30).read()[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            _NO_PROXY.open(f"{base}/frame/NOPE/0.png", timeout=30)
        assert e.value.code == 404
        before = results["BNDM"]
        req = urllib.request.Request(f"{base}/api/generate?seed=3", method="POST")
        assert json.loads(_NO_PROXY.open(req, timeout=60).read()) == {"ok": True}
        new = json.loads(_NO_PROXY.open(f"{base}/api/meta", timeout=30).read())
        assert new == meta
        png = _NO_PROXY.open(f"{base}/frame/BNDM/0.png", timeout=30).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            _NO_PROXY.open(urllib.request.Request(f"{base}/api/generate?seed=x",
                                                  method="POST"), timeout=30)
        assert e.value.code == 400
        assert before.shape == results["BNDM"].shape
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_demo_static_panel(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from bndm_tpu_torch.cli.demo import main

    main(["--dataset=tinychurch", "--res=32", "--nb_steps=6", "--tiny_model",
          "--compute_dtype=float32", f"--output={tmp_path}/panel.png", "--device=cpu"])
    assert (tmp_path / "panel.png").exists()


# ------------------------------- native path -----------------------------------


@pytest.mark.parametrize("shape,res,hflip,crop", [
    ((48, 80, 3), 32, False, (-1, -1)),
    ((80, 48, 3), 32, True, (-1, -1)),
    ((64, 64, 3), 64, False, (-1, -1)),
    ((100, 100, 3), 64, False, (-1, -1)),
    ((33, 57, 3), 16, True, (-1, -1)),
    ((48, 80, 3), 32, True, (0, 13)),
])
def test_fast_transform_bit_for_bit_jax(shape, res, hflip, crop):
    """The port's copy of fastimage.cpp, built by the port: JAX's native
    transform's bits on tests/test_native_image.py's shapes (and a random
    crop's offsets)."""
    from bndm_tpu.native import fast_transform as jfast
    from bndm_tpu_torch import native

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    got = native.fast_transform(img, res, hflip, crop_top=crop[0], crop_left=crop[1])
    want = jfast(img, res, hflip, crop_top=crop[0], crop_left=crop[1])
    assert got is not None and want is not None
    assert got.dtype == np.float32 and got.shape == (3, res, res)
    np.testing.assert_array_equal(got, want)


def test_batch_loader_bit_for_bit_jax_when_native(tmp_path):
    """Both loaders through their native transforms: the same batches bit
    for bit, every image counted on the native path, none on PIL's."""
    from bndm_tpu.data import imagefolder as jdata
    from bndm_tpu_torch import native
    from bndm_tpu_torch.data import imagefolder as tdata

    root = tdata.make_synthetic_folder(str(tmp_path / "d"), n=10, res=24, seed=3)
    native.reset_counts()
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
            np.testing.assert_array_equal(a, b)
    assert native.PATH_COUNTS == {"native": 18, "pil": 0}


def test_failed_native_build_is_logged_once(tmp_path, monkeypatch, capsys):
    """A source g++ rejects: the failure and the compiler's message on
    stderr, once; then the library is None (the loader takes PIL)."""
    from bndm_tpu_torch import native

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "_build" / "bad.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_fastimage() is None
    err = capsys.readouterr().err
    assert "g++ failed" in err and "bad.cpp" in err
    assert native.get_fastimage() is None
    assert capsys.readouterr().err == ""
