"""The streaming probes P1-P3, their bench entry points, the port's timing
utilities and the CLI's --profile_dir, on the CPU against the JAX package.

The probes' kernels cannot run here (Triton and CUDA C++); their wrappers
take the plain version for CPU tensors, which is the kernels' oracle on the
card (tests/test_torch_port_gpu.py, chip_smoke.py). The JAX scripts'
kernels are closures inside their ``main()`` and cannot be imported, and
running ``main()`` would stream 0.5 GB through XLA; so the tests write the
JAX side's one-line bodies in jnp, as the scripts have them
(scripts/bench_pallas_stream.py:32-33, :120-121;
scripts/bench_elementwise_tpu.py:36-76).
"""

import contextlib
import io
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.utils import timing as jtiming
from bndm_tpu_torch.ops import stream_probes as sp
from bndm_tpu_torch.scripts import bench_elementwise, bench_stream
from bndm_tpu_torch.utils import timing

EDGES = np.array([0.0, -0.0, np.inf, -np.inf, 256.0, 257.0, 258.0, -256.0, 511.0, 3e38, -1.0,
                  2.0**-9, -2.0**-9, 1e-20, -1e-30, 1e-39, -1e-39], np.float32)


def _edge_bf16(shape, seed):
    """numpy bf16 N(0, 64^2) values with +-0, +-inf, values of 256 and more
    (where +1 rounds to even), values far below 2^-8 and subnormals at the
    start, the end and every 97th element."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 64.0
    flat = x.reshape(-1)
    flat[:len(EDGES)] = EDGES
    flat[-len(EDGES):] = EDGES
    idx = np.arange(0, flat.size, 97)
    flat[idx] = np.resize(EDGES, idx.size)
    return x.astype(jnp.bfloat16)


def _to_torch(a):
    """numpy bf16 -> torch bf16, the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _counts():
    return (sp.stream_add_one.launches, sp.dma_add_one.launches, sp.nhwc_add_one.launches)


# ------------------------------ the probes -----------------------------------

WRAPPERS = {
    "plain": sp.add_one_plain,
    "P1 parallel": lambda y: sp.stream_add_one(y, 256, "parallel"),
    "P1 persistent": lambda y: sp.stream_add_one(y, 1024, "persistent"),
    "P2": lambda y: sp.dma_add_one(y, 16384, 2),
    "P3": sp.nhwc_add_one,
    "P3 2 KiB, no hints": lambda y: sp.nhwc_add_one(y, 2, 4, False),
}


@pytest.mark.parametrize("name,shape", [
    ("plain", (257, 1024)), ("P1 parallel", (257, 1024)), ("P1 persistent", (257, 1024)),
    ("P2", (257, 1024)), ("plain", (3, 8, 8, 128)), ("P3", (3, 8, 8, 128)),
    ("P3 2 KiB, no hints", (3, 5, 7, 9))])
def test_probe_matches_jax_add_one_bitwise(name, shape):
    """``y + jnp.bfloat16(1.0)`` (the body of every probe) and the port's
    version give the same bits, edge values included; on the CPU no kernel
    is launched."""
    x = _edge_bf16(shape, seed=len(name))
    want = np.asarray(jnp.asarray(x) + jnp.bfloat16(1.0))
    before = _counts()
    got = WRAPPERS[name](_to_torch(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), want.view(np.int16))
    assert _counts() == before == (0, 0, 0)


@pytest.mark.parametrize("call,exc", [
    (lambda: sp.stream_add_one(torch.zeros(4, 8)), TypeError),  # float32
    (lambda: sp.dma_add_one(torch.zeros(8, 4, dtype=torch.bfloat16).t()), ValueError),  # view
    (lambda: sp.nhwc_add_one(torch.zeros(17, dtype=torch.bfloat16)[1:].view(1, 2, 2, 4)),
     ValueError),  # a pointer 2 bytes past a 16-byte boundary
    (lambda: sp.dma_add_one(torch.zeros(17, dtype=torch.bfloat16)[1:].view(2, 8)), ValueError),
    (lambda: sp.stream_add_one(torch.zeros(2, 2, 2, dtype=torch.bfloat16)), ValueError),  # rank
    (lambda: sp.nhwc_add_one(torch.zeros(2, 8, dtype=torch.bfloat16)), ValueError),
    (lambda: sp.stream_add_one(torch.zeros(0, 8, dtype=torch.bfloat16)), ValueError),  # empty
    (lambda: sp.stream_add_one(torch.zeros(4, 8, dtype=torch.bfloat16), 4, "arbitrary"),
     ValueError),
    (lambda: sp.stream_add_one(torch.zeros(4, 8, dtype=torch.bfloat16), 0), ValueError),
    (lambda: sp.stream_add_one(torch.zeros(1, sp.MAX_COLS + 1, dtype=torch.bfloat16)),
     ValueError),
    (lambda: sp.dma_add_one(torch.zeros(4, 8, dtype=torch.bfloat16), 24), ValueError),
    (lambda: sp.dma_add_one(torch.zeros(4, 8, dtype=torch.bfloat16), 32, 5), ValueError),
    (lambda: sp.nhwc_add_one(torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16), 3), ValueError),
    (lambda: sp.nhwc_add_one(torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16), 4, 3), ValueError),
])
def test_probe_wrappers_refuse_what_their_kernels_do_not_take(call, exc):
    """Checked before the device is looked at, so the CPU raises as the
    card would: bad dtype, non-contiguous view, misaligned pointer, rank,
    empty tensor, and arguments out of range."""
    with pytest.raises(exc):
        call()


# --------------------------- the elementwise cases ----------------------------


def _jax_cases(channels):
    """The JAX script's cases, written in jnp as it has them
    (scripts/bench_elementwise_tpu.py:36-67)."""
    scale = jnp.ones((channels,), jnp.float32)
    bias = jnp.zeros((channels,), jnp.float32)
    gn = fnn.GroupNorm(32, epsilon=1e-5, dtype=jnp.bfloat16)
    gn_params = gn.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, channels), jnp.bfloat16))

    def stats_only(y):
        yf = y.astype(jnp.float32)
        s1 = jnp.sum(yf, axis=(1, 2))
        s2 = jnp.sum(yf * yf, axis=(1, 2))
        return y + (s1[:, None, None, :] * 0 + s2[:, None, None, :] * 0).astype(y.dtype)

    return {
        "copy(+1)": lambda y: y + jnp.bfloat16(1.0),
        "affine(scale,bias)": lambda y: y * scale.astype(jnp.bfloat16) + bias.astype(jnp.bfloat16),
        "silu bf16": jax.nn.silu,
        "silu fp32": lambda y: jax.nn.silu(y.astype(jnp.float32)).astype(jnp.bfloat16),
        "sigmoid": jax.nn.sigmoid,
        "tanh": jnp.tanh,
        "exp": jnp.exp,
        "gn_stats_vpu(fp32 sums)": stats_only,
        "flax GroupNorm": lambda y: gn.apply(gn_params, y),
        "flax GroupNorm+silu": lambda y: jax.nn.silu(gn.apply(gn_params, y)),
        "triton copy(+1)": lambda y: y + jnp.bfloat16(1.0),  # the Pallas copy's body
    }


# bf16 ulps allowed between the two sides, with the reason
ULPS = {
    "copy(+1)": 0,  # one correctly rounded add on both sides
    "triton copy(+1)": 0,
    "affine(scale,bias)": 0,  # times 1, plus 0: exact
    "gn_stats_vpu(fp32 sums)": 0,  # y + 0
    "silu fp32": 1,  # one rounding of an fp32 silu; two exp implementations may part in
    "tanh": 1,  # the last fp32 bit, and that can move the bf16 rounding by one ulp
    "exp": 1,
    # XLA's CPU sigmoid on bf16 rounds its intermediates to bf16 (2 ulps off
    # the fp64 value rounded once, on a third of this input); torch's is the
    # correctly rounded one
    "sigmoid": 2,
    "silu bf16": 2,
    "flax GroupNorm": 1,  # fp32 moments summed in another order, then a bf16 normalise
    "flax GroupNorm+silu": 2,  # XLA's bf16 silu, as above
}


@pytest.mark.parametrize("name", list(ULPS))
def test_elementwise_case_matches_jax(name):
    """Each case of the port's bench on a (2, 8, 8, 128) NHWC bf16 input
    equals the JAX script's case within the stated bf16 ulps of the JAX
    value; the GroupNorm cases take the port's own GroupNorm through a
    channels-last view and come back NHWC."""
    x = np.random.default_rng(7).standard_normal((2, 8, 8, 128)).astype(np.float32) * 2.0
    x = x.astype(jnp.bfloat16)
    want = np.asarray(_jax_cases(128)[name](jnp.asarray(x))).astype(np.float32)
    fn = dict(bench_elementwise.cases(128, "cpu"))[name]
    with torch.no_grad():
        got = fn(_to_torch(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    got = got.float().numpy()
    # one bf16 ulp of the wanted value: 2^(exponent - 7), at least the
    # smallest normal's
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert np.all(np.abs(got - want) <= ULPS[name] * ulp), np.abs(got - want).max()


# ---------------------------- the entry points --------------------------------


def _lines(fn, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = fn(**kw)
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert lines == rows
    return lines


def test_bench_stream_runs_its_cases_on_the_cpu():
    """One JSON line per case: P1 at 256, 512 and 1024 rows per block, each
    persistent (the TPU's "arbitrary") and parallel, P2 over its sweep, then
    the library's add; no share of the card's peak for a CPU time."""
    lines = _lines(bench_stream.main, shape=(64, 128), inner=2, device="cpu")
    names = [r["case"] for r in lines]
    assert names[:6] == [f"auto blk ({r * 128 * 2 / 2**20:g}MiB) {s}"
                         for r in (256, 512, 1024) for s in ("persistent", "parallel")]
    assert names[6:12] == [f"manual dma ({c // 1024}KiB chunks, {st} stages)"
                           for c, st in bench_stream.DMA_SWEEP]
    assert names[12:] == ["torch add same shape"]
    for r in lines:
        assert r["device"] == "cpu" and r["peak_share"] is None
        assert r["ms"] > 0 and r["gb_s"] == pytest.approx(2 * 64 * 128 * 2 / 1e6 / r["ms"])
    assert _counts() == (0, 0, 0)


def test_bench_elementwise_runs_the_jax_scripts_cases_on_the_cpu():
    """The JAX script's case names in its order (the fp32 copy first), with
    P3 in the Pallas copy's place; the fp32 copy counts twice the bytes."""
    lines = _lines(bench_elementwise.main, shape=(2, 8, 8, 128), inner=2, device="cpu")
    names = [r["case"] for r in lines]
    assert names == ["copy(+1) fp32", "copy(+1)", "affine(scale,bias)", "silu bf16",
                     "silu fp32", "sigmoid", "tanh", "exp", "gn_stats_vpu(fp32 sums)",
                     "flax GroupNorm", "flax GroupNorm+silu", "triton copy(+1)"]
    nbytes = 2 * 8 * 8 * 128 * 2
    assert lines[0]["gb_s"] == pytest.approx(2 * 2 * nbytes / 1e6 / lines[0]["ms"])
    assert lines[1]["gb_s"] == pytest.approx(2 * nbytes / 1e6 / lines[1]["ms"])


@pytest.mark.parametrize("main", [bench_stream.main, bench_elementwise.main])
def test_bench_entry_points_need_cuda_unless_asked(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(inner=1)


@pytest.mark.parametrize("mod", [bench_stream, bench_elementwise])
def test_a_failing_bench_case_ends_the_run(mod, monkeypatch):
    """No FAILED line: the exception propagates."""
    def boom(y):
        raise RuntimeError("case failed")

    monkeypatch.setattr(mod, "cases", lambda *a: [("boom", boom)])
    shape = (8, 16) if mod is bench_stream else (1, 2, 2, 32)
    with pytest.raises(RuntimeError, match="case failed"):
        mod.main(shape=shape, inner=1, device="cpu")


# -------------------------------- timing --------------------------------------


@pytest.mark.parametrize("times", [[], [0.5], [0.5, 0.125, 0.25, 1.0]])
def test_timer_matches_jax(times):
    """The same recorded times give the same mean (the first call left
    out) and total as the JAX package's Timer."""
    t, j = timing.Timer("a"), jtiming.Timer("a")
    t.times, j.times = list(times), list(times)
    np.testing.assert_equal(t.mean, j.mean)
    assert t.total == j.total
    with t.measure():
        pass
    assert len(t.times) == len(times) + 1 and t.times[-1] >= 0


def test_timed_call_returns_the_output():
    calls = []

    def fn(a, b=1):
        calls.append(1)
        return a + b

    mean_s, out = timing.timed_call(fn, torch.ones(3), b=2, iters=3, warmup=2, device="cpu")
    assert torch.equal(out, torch.full((3,), 3.0)) and len(calls) == 5 and mean_s >= 0


def test_pass_ms_chains_the_passes():
    seen = []

    def fn(y):
        seen.append(float(y))
        return y + 1

    assert timing.pass_ms(fn, torch.tensor(0.0), inner=3, device="cpu") >= 0
    assert seen == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0]  # a warm-up loop, then the timed one


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "t")):
        torch.ones(16).add_(1).sum()
    (f,) = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / f) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)


# ----------------------------- --profile_dir ----------------------------------


def test_cli_profile_dir_traces_the_first_batch_and_changes_no_sample(tmp_path, monkeypatch):
    """A tiny unconditional test run with --profile_dir writes one trace
    into that folder, and its images are those of the same run without it."""
    from bndm_tpu_torch.cli.iadb_bn import main
    from bndm_tpu_torch.models.unet2d import UNet2D, UNet2DConfig

    bn = tmp_path / "bluenoise"
    bn.mkdir()
    np.savez(bn / "cov_gaussianBN_L_res64_d3.npz", x=np.eye(4096, dtype=np.float32))
    torch.manual_seed(0)
    model = UNet2D(UNet2DConfig(in_channels=3, out_channels=6, block_out_channels=(8, 16),
                                down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                                up_block_types=("AttnUpBlock2D", "UpBlock2D"),
                                attention_head_dim=4, norm_num_groups=4))
    run = "results_gaussianBN/tinycat_gaussianBN_sigmoid_1000.0_0_3_outc6_seed0"
    argv = ["--dataset=tinycat", "--res=32", "--batch_size=2", "--test_samples=4",
            "--tiny_model", "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid",
            "--scheduler_param=1000", "--out_channel=6", "--compute_dtype=float32",
            "--nb_steps=3", "--train_or_test=test", "--save_all_samples", "--device=cpu",
            f"--bluenoise_dir={bn}"]
    images = {}
    for side, extra in (("plain", []), ("traced", [f"--profile_dir={tmp_path / 'trace'}"])):
        (tmp_path / side / run).mkdir(parents=True)
        torch.save(model.state_dict(), tmp_path / side / run / "model.ckpt")
        monkeypatch.chdir(tmp_path / side)
        main(argv + extra)
        imgs = sorted((tmp_path / side / run).rglob("images/*.png"))
        images[side] = [p.read_bytes() for p in imgs]
    assert len(images["plain"]) == 4 and images["traced"] == images["plain"]
    (f,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / f) as fh:
        assert json.load(fh)["traceEvents"]
