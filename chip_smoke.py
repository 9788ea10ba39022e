#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bndm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --kernels   # phases 1-4 alone (K1-K3)
    python3 chip_smoke.py --adaln     # phases 1, 2 and 4b alone (the fused adaLN units)
    python3 chip_smoke.py --probes    # phases 1, 2 and 5 alone (the probes)
    python3 chip_smoke.py --tiers     # phases 1, 2 and 9b alone (the serving tiers)
    python3 chip_smoke.py --pipelines # phases 1, 2 and 12-14 alone (DDIM, latent)
    python3 chip_smoke.py --train     # phases 1, 2 and 10 alone (pixel training)
    python3 chip_smoke.py --parallel  # phases 1, 2, 15 and 16 alone (data parallelism)
    python3 chip_smoke.py --surfaces  # phases 1, 2 and 17-19 alone (figs, parity, demo)

Drives the port's serving and training paths at full width with random
seeded weights and holds every hand-written kernel against its plain
PyTorch version:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under bndm_tpu_torch/csrc, one nvcc each, at once;
  3. K1 (tri_matmul) against fp64 and its plain version over the M sweep
     1-1500 on the TPU kernel test's L (tril(0.02 N(0,1)), unit diagonal)
     and on the generated blue-noise L, the same bits from a second call;
     both of its designs timed at each M (the crossover); then K1 against
     torch.matmul in alternating turns at M = 12, 48, 96, 768, 1024 (the
     latent res-256 train step) and 1500,
     beside its plain version and the bound, its share of the fp32 FMA
     bound and of the 3xTF32 tensor-core bound;
  4. K2 (fused_bluenoise_flat) against its plain version and fp64 at
     M = 7, 48, 96, 192, 768, 1500 on both L, the exact mix, GBN, the white
     noise's moments, determinism, and K3's gamma gradient; K2 and the
     unfused torch sequence timed in alternating turns at M = 192 and 1500,
     beside the plain version and both bounds; K3's backward (torch ops)
     timed beside its bound;
 4b. the fused adaLN units (ops/adaln.py) at the DiT-XL/2 train cell's
     shape (128, 256, 1152), with and without the residual input, against
     their plain twins within one ulp (plus the float32 rounding of the
     sums) and bit for bit twice; timed against the plain twin and the
     unfused model sequence in alternating turns, beside the byte bound;
     then DiT-XL/2's forward and backward on the card: 57 launches of each
     pass a step, and no farther from the float32 model than the plain
     bf16 sequence;
  5. the streaming probes P1-P3 (y + 1 in bf16) bitwise against their
     plain version at the full and ragged shapes, on edge values, every
     variant of the bench's sweep; each probe's variants and torch.add
     timed in alternating turns, the named default variant (P1_DEFAULT,
     P2_DEFAULT, P3_DEFAULT) beside the plain version and the bound; then both
     bench entry points (bndm_tpu_torch.scripts.
     bench_stream and bench_elementwise) at their full shapes;
  6. the noise engine (gaussianBN, inplace) at res 32, 64, 128 on CUDA and
     on the CPU, all three outputs compared;
  7. one full-width res-64 UNet forward in fp32 (TF32 off), CUDA vs CPU;
  8. super-res serving: the CLI with the flags of
     scripts/sampling/iadb_church_superres_test.sh (res 128, 116.3M UNet,
     250 steps) on 4 procedural images; K1 must launch once per request;
  9. unconditional serving: the CLI with the flags of
     scripts/sampling/cat_res64_test.sh (res 64, two-head 113.7M UNet, 250
     steps) on 2 batches of 16, the first traced by --profile_dir;
 9b. the serving tiers at full width (phase_serving_tiers): cache_interval=1
     bit for bit the plain chain; the shallow forward against the full one
     at every depth; the int8 product's int32 sums on the card against the
     CPU's; the cat_res64 CLI with --conv_int8 --attn_softmax_dtype=bfloat16
     --cache_interval 8 (plain, --gn_carry, --microbatch 8; and without
     --conv_int8 before and after, to weigh int8 on this card) and the
     super-res CLI with --conv_int8 --cache_interval 8 (K1 once per
     request), samples/s of each; the validated ladder at probe batch 4;
     one full and one shallow forward traced;
 10. training: the CLI with the flags of
     scripts/training/iadb_bn_cat_res64.sh (gaussianBN, two-head 113.7M
     UNet, batch 64) for 8 steps on 512 procedural images, then 12 steady
     steps (the last batch again, with no loader thread decoding beside
     them), then a resumed ninth step; K2 and K3 must run once per CLI
     step and K1 not at all, and the loader must decode through the native
     C++ transform; one step traced (torch.profiler);
 11. trace: one bf16 UNet forward of each served branch at its shape (the
     DDIM and latent ones too) and one bf16 VAE decode of 16 latents, its
     host-clock time beside the device's busy time and top kernels;
 12. the DDIM baseline (phase_ddim), the flags of
     scripts/sampling/cat_res64_test.sh:7 (res 64, the 113.7M 3->3 UNet,
     1000 train T, 250 leading steps, clip_sample): the CLI trains 8 steps
     at batch 64 with --use_ema on 512 procedural images, 12 steady steps
     as in phase 10, and one resumed step (traced), samples 2 batches of 16 with frames, then --conv_int8
     --cache_interval 8; one fp32 DDIM step on the card against the CPU;
     no hand kernel on the path;
 13. the latent pipeline at res 256 (phase_latent), the flags of
     scripts/training/latent_iadb_celeba_res256.sh:3 (latent32 UNet, out
     4 x 2 two-head, batch 256) with the SD-VAE config at random init: the
     cache from 128 procedural images, 10 train steps (the last traced), K1
     once per step at M = 1024; one batch of 16 sampled and decoded with
     --decode_microbatch 16; the fp32 VAE decode on the card against the
     CPU;
 14. the latent pipeline at res 512, reduced (phase_latent512,
     scripts/training/latent_iadb_cat_res512.sh:6 at batch 64, not 256): 6
     train steps on 32 procedural images (the last traced), K2 once per
     step;
 15. data parallelism at full width (phase_parallel): (a) the training CLI
     (phase 10's flags, batch 64, 3 steps) as one NCCL rank through
     --coordinator_address/--num_processes/--process_id, its losses and
     weights the run without a process group's bit for bit; (b) two gloo
     ranks sharing the card (NCCL refuses two ranks on one device), 32 rows
     each, one fp32 step: the summed UNet gradient within 1e-5 x its norm of
     one rank's step on the same batch, t and noise, (tau, s, e) within rtol
     1e-3, K2 and K3 once on each rank; the all-reduce of a step's gradient timed
     in both;
 16. the port's dry run (bndm_tpu_torch/dryrun.py) on 2 gloo ranks on the
     card: the seven legs;
 17. the figure CLI at 100 realisations: its files, K1 four times at M = 3
     and twice at M = 1200, the written spectra within TOL of the plain
     version's on the same white noise; K1 at both M against its plain
     version and timed against torch.matmul in alternating turns;
 18. parity_check on a full-width res-64 UNet from seeded weights written
     as .safetensors and as model.ckpt: the probe on the card within 1e-3
     of the CPU's, then the 250-step sample;
 19. the demo: the three full-width res-64 UNets from random init, 50
     steps; its http server on an ephemeral port (GET the page and a frame,
     POST /api/generate) and the static panel;
 20. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after; launches made to compare a kernel with its plain
version do not count.

Any failed phase ends the run with exit code 1 and no result line. It needs
CUDA and the rest of the repository beside it; it works in a temporary
directory and writes nothing into the repository except the kernels' build
(bndm_tpu_torch/_build/, ignored by git).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA data-sheet peaks (dense): HBM bytes/s, fp32 FLOP/s on the CUDA
# cores, TF32 FLOP/s on the tensor cores (the data sheets' sparse figures
# halved)
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 417.5e12),
    "H100": (3.35e12, 67e12, 495e12),  # SXM5 (H100 80GB HBM3)
}
TOL = 2e-5  # rtol = atol: the bound tests/test_noise.py holds the JAX engine to


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


class Tee(io.TextIOBase):
    """Copies what a phase prints to the real stdout and keeps it."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def roofline(nbytes, flops, peak_bytes, peak_flops):
    """(least ms, what bounds it) for ``nbytes`` moved once and ``flops`` at
    the peak rate of their type."""
    t_b, t_o = nbytes / peak_bytes, flops / peak_flops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def product_bounds(nbytes, n, m, peak):
    """The two bounds of a triangular product of n(n+1)/2 * m multiply-adds
    that moves ``nbytes``: in fp32 FMAs on the CUDA cores, and in 3xTF32
    (three TF32 products each) on the tensor cores."""
    flops = n * (n + 1) * m
    return {"fp32": roofline(nbytes, flops, peak[0], peak[1]),
            "3xtf32": roofline(nbytes, 3 * flops, peak[0], peak[2])}


def k1_bounds(n, m, peak):
    """L @ W with L lower-triangular: the triangle of L, W and the output
    each move once."""
    return product_bounds(4 * (n * (n + 1) // 2 + 2 * n * m), n, m, peak)


def k2_bounds(n, m, peak):
    """K2: the triangle of L and gamma read once, noise, bn and wn written
    once; the product's multiply-adds (the mix's three fp32 operations per
    element and the generator's integer work are not counted)."""
    return product_bounds(4 * (n * (n + 1) // 2 + m + 3 * n * m), n, m, peak)


def k3_bound(n, m, peak_bytes, peak_flops):
    """Least time for K3's backward: grad, wn and bn read once, the (M,)
    gradient written once; a subtract, a multiply and an add per element."""
    return roofline(4 * (3 * n * m + m), 3 * n * m, peak_bytes, peak_flops)


def shares(row, bounds, route):
    """Add to ``row`` the bound of ``route`` (the arithmetic the kernel
    runs) and the kernel's share of both bounds."""
    row["bound_ms"], row["bound_by"] = bounds[route]
    for k, (ms, by) in bounds.items():
        row[f"bound_{k}_ms"], row[f"bound_{k}_by"] = ms, by
        row[f"share_{k}"] = ms / row["ms"]
    return row


def kernel_breakdown(torch, fn, flush, calls=5):
    """Device time (us) per call of each CUDA kernel ``fn`` launches, by a
    short name, from torch.profiler over ``calls`` calls with the L2 flushed
    before each (the flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in device_kernels(prof):
        if "fill" in e.name.lower():  # the flush
            continue
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = re.split(r"[(<]", name)[0].split("::")[-1]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def tpu_test_L(torch, n):
    """The TPU kernel test's L (tests/test_fused_noise_tpu.py:24-27):
    tril(0.02 N(0,1)) from numpy's default_rng(0), unit diagonal, on the
    card."""
    import numpy as np

    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((n, n)).astype(np.float32) * 0.02)
    np.fill_diagonal(L, 1.0)
    return torch.from_numpy(L).cuda()


def _counted():
    """Every counted wrapper, by the name the script reads its count under."""
    from bndm_tpu_torch.ops.adaln import adaln_backward, adaln_forward
    from bndm_tpu_torch.ops.cuda_bluenoise import FusedBlueNoise, fused_bluenoise_flat, tri_matmul
    from bndm_tpu_torch.ops.stream_probes import dma_add_one, nhwc_add_one, stream_add_one

    return {"tri_matmul": tri_matmul, "fused_bluenoise": fused_bluenoise_flat,
            "fused_bluenoise_grad": FusedBlueNoise, "stream_add_one": stream_add_one,
            "dma_add_one": dma_add_one, "nhwc_add_one": nhwc_add_one,
            "adaln_forward": adaln_forward, "adaln_backward": adaln_backward}


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path is driven),
    K1's count by M too."""
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_m"):
            fn.launches_by_m.clear()


def read_launches():
    return {name: fn.launches for name, fn in _counted().items()}


def launch_times(torch, fn, iters, flush):
    """Device times (ms) of ``iters`` launches of ``fn``, each timed by its
    own CUDA events with the L2 cache flushed before it (a served request
    finds L cold: 250 UNet steps run between two draws)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_ms(torch, fn, iters, flush):
    """Median of :func:`launch_times`."""
    return median(launch_times(torch, fn, iters, flush))


def alternating(fns, turns, timer):
    """Median time of each of ``fns`` (name -> fn), timed in turns a, b, b,
    a (the dict's order, then reversed), ``turns`` times over, so that
    drift in the card's clock falls on all of them alike. ``timer(fn)``
    returns a list of times."""
    order = list(fns)
    times = {name: [] for name in order}
    for _ in range(turns):
        for name in order + order[::-1]:
            times[name] += timer(fns[name])
    return {name: median(ts) for name, ts in times.items()}


@contextlib.contextmanager
def watched_sampler(record):
    """Record the shape, finiteness and seconds (host clock, synchronised)
    of every sample the CLI draws (wraps the real sampler; restores it on
    exit)."""
    import torch

    from bndm_tpu_torch.samplers import iadb

    real = iadb.sample_iadb

    def watched(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, frames = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        record.append((tuple(x.shape), bool(torch.isfinite(x).all()), seconds))
        return x, frames

    iadb.sample_iadb = watched
    try:
        yield
    finally:
        iadb.sample_iadb = real


@contextlib.contextmanager
def watched_samplers(record, module=None,
                     names=("sample_iadb", "sample_iadb_cached", "sample_iadb_microbatched")):
    """Record (sampler name, shape, finiteness, seconds on the host clock,
    synchronised) of every call of the samplers ``names`` of ``module``
    (the IADB samplers by default) the CLI may route to, calibration's
    plain trajectories included (restores them on exit)."""
    import torch

    from bndm_tpu_torch.samplers import iadb

    module = module or iadb
    real = {n: getattr(module, n) for n in names}

    def watch(name):
        def watched(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            x = out[0] if isinstance(out, tuple) else out
            record.append((name, tuple(x.shape), bool(torch.isfinite(x).all()),
                           time.perf_counter() - t0))
            return out
        return watched

    for n in names:
        setattr(module, n, watch(n))
    try:
        yield
    finally:
        for n in names:
            setattr(module, n, real[n])


@contextlib.contextmanager
def watched_steps(record, module, factory, traced=None, trace_step=None, last=None):
    """Record the seconds (host clock, synchronised), the model's parameter
    count and the main thread's CPU seconds of every step of the train step
    that ``module.factory`` (``make_ddim_train_step``,
    ``make_latent_train_step``) builds while this is open. The step
    numbered ``trace_step`` (0 = the first of the run) runs under
    torch.profiler instead, its CUDA kernel events appended to ``traced``.
    ``last`` (a dict): its "again" repeats the last untraced step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    real = getattr(module, factory)

    def make(*args, **kwargs):
        step, init = real(*args, **kwargs)

        def watched(state, batch, key):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            if traced is not None and len(record) == trace_step:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    metrics = step(state, batch, key)
                    torch.cuda.synchronize()
                traced.extend(device_kernels(prof))
            else:
                metrics = step(state, batch, key)
                torch.cuda.synchronize()
                if last is not None:
                    last["again"] = lambda: step(state, batch, key)
            record.append((time.perf_counter() - t0,
                           sum(p.numel() for p in state.model.parameters()),
                           time.thread_time() - c0))
            return metrics
        return watched, init

    setattr(module, factory, make)
    try:
        yield
    finally:
        setattr(module, factory, real)


def device_kernels(prof):
    """The kernels a torch.profiler run saw on the card: CUDA events other
    than the GPU-side ranges of user annotations (such as the optimizer's
    step), which would count idle gaps as busy."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def watched_trainer(record, traced=None, last=None):
    """Record the seconds (host clock, synchronised), the model's parameter
    count and the main thread's CPU seconds of every train step the CLI
    takes. With ``traced`` (a list), each step runs under torch.profiler
    instead and its CUDA kernel events are appended there. ``last`` (a
    dict): its "again" repeats the last untraced step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bndm_tpu_torch.train import pixel

    real = pixel.PixelTrainer.step

    def watched(self, batch01, key):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        if traced is None:
            metrics = real(self, batch01, key)
            torch.cuda.synchronize()
            if last is not None:
                last["again"] = lambda: real(self, batch01, key)
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                metrics = real(self, batch01, key)
                torch.cuda.synchronize()
            traced.extend(device_kernels(prof))
        record.append((time.perf_counter() - t0,
                       sum(p.numel() for p in self.model.parameters()),
                       time.thread_time() - c0))
        return metrics

    pixel.PixelTrainer.step = watched
    try:
        yield
    finally:
        pixel.PixelTrainer.step = real


def write_ckpt(torch, cfg, path, seed):
    """Seeded random-init weights as a reference-style torch model.ckpt."""
    from bndm_tpu_torch.models.unet2d import UNet2D

    torch.manual_seed(seed)
    model = UNet2D(cfg, device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path)
    return n_params


def run_cli(argv, cli="iadb_bn"):
    """Run ``bndm_tpu_torch.cli.<cli>.main(argv)``; returns what it printed."""
    import importlib

    main = importlib.import_module(f"bndm_tpu_torch.cli.{cli}").main
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        main(argv)
    return tee.buf.getvalue()


# 12: super-res; 768: res-128 train; 1024: latent res-256 train (batch 256 x 4)
K1_SWEEP = (1, 7, 12, 16, 24, 32, 48, 64, 96, 192, 768, 1024, 1500)
K1_TIMED = (12, 48, 96, 768, 1024, 1500)  # 1500: a res-64 gallery batch of 500
STEP0_M = (192, 1500)  # where the 3xTF32 arithmetic was first held to fp64


def phase_k1(torch, L_blue, peak, flush):
    """K1 over the M sweep on the TPU test's L and on the blue-noise L:
    within TOL of fp64 and of its plain version, the same bits from a second
    call. On the blue L, each design's time at each M (the crossover), then
    K1 against torch.matmul in alternating turns at the main path's shapes
    and around the crossover."""
    from bndm_tpu_torch.ops import cuda_bluenoise as cb
    from bndm_tpu_torch.ops.cuda_bluenoise import SKINNY_MAX_M, _launch, tri_matmul, tri_matmul_plain

    skinny_limit = getattr(cb, "SKINNY_LIMIT_M", 64)  # the skinny kernel's own limit
    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(0)
    worst_plain = worst_fp64 = 0.0
    sweep, step0 = [], []
    for lname, L in (("tpu_test", tpu_test_L(torch, n)), ("blue", L_blue)):
        for m in K1_SWEEP:
            W = torch.randn(n, m, generator=g).cuda()
            out, again = tri_matmul(L, W), tri_matmul(L, W)
            torch.cuda.synchronize()
            same = torch.equal(out, again)
            ref = L.double() @ W.double()
            plain = tri_matmul_plain(L, W)
            e64 = (out.double() - ref).abs().max().item()
            ep = (out - plain).abs().max().item()
            ok = (torch.allclose(out.double(), ref, rtol=TOL, atol=TOL)
                  and torch.allclose(out, plain, rtol=TOL, atol=TOL))
            log(f"K1 L={lname} M={m}: max|err| vs fp64 {e64:.3e}, vs plain {ep:.3e} "
                f"(rtol=atol={TOL}) {'ok' if ok else 'FAIL'}; second call "
                f"{'the same bits' if same else 'OTHER BITS'}")
            check(ok, f"K1 disagrees at L={lname} M={m}")
            check(same, f"K1 is not deterministic at L={lname} M={m}")
            worst_plain, worst_fp64 = max(worst_plain, ep), max(worst_fp64, e64)
            if m in STEP0_M:
                step0.append((lname, m, e64))
            if lname == "blue":  # both designs, for the crossover
                row = {"m": m, "design": "skinny" if m <= SKINNY_MAX_M else "wide",
                       "max_abs_err": ep, "max_abs_err_fp64": e64}
                for design in ("skinny", "wide"):
                    if design == "wide" or m <= skinny_limit:
                        row[f"{design}_ms"] = time_ms(torch, lambda: _launch(L, W, design), 20,
                                                      flush)
                row["matmul_ms"] = time_ms(torch, lambda: torch.matmul(L, W), 20, flush)
                sweep.append(row)
                log(f"K1 M={m} designs (median, L2 flushed): skinny "
                    f"{row.get('skinny_ms', float('nan')):.4f} ms, wide {row['wide_ms']:.4f} "
                    f"ms, torch.matmul {row['matmul_ms']:.4f} ms; takes {row['design']}")
    log("K1 wide design, the 3xTF32 arithmetic against fp64 (rtol=atol 2e-5): " + "; ".join(
        f"L={lname} M={m} max|err| {e:.3e}" for lname, m, e in step0))

    rows = []
    for m in K1_TIMED:
        W = torch.randn(n, m, generator=g).cuda()
        iters = 10 if m < 100 else 5
        turns = alternating({"library": lambda: torch.matmul(L_blue, W),
                             "kernel": lambda: tri_matmul(L_blue, W)}, 5,
                            lambda fn: launch_times(torch, fn, iters, flush))
        plain_ms = time_ms(torch, lambda: tri_matmul_plain(L_blue, W), 10, flush)
        srow = next(r for r in sweep if r["m"] == m)
        row = shares({"m": m, "design": srow["design"], "ms": turns["kernel"],
                      "library_ms": turns["library"], "plain_ms": plain_ms,
                      "max_abs_err": srow["max_abs_err"],
                      "max_abs_err_fp64": srow["max_abs_err_fp64"]}, k1_bounds(n, m, peak),
                     "fp32" if srow["design"] == "skinny" else "3xtf32")
        if row["design"] == "wide":
            row["kernels_us"] = kernel_breakdown(torch, lambda: tri_matmul(L_blue, W), flush)
        rows.append(row)
        log(f"K1 M={m} times (median of 5 alternating turns, L2 flushed): kernel "
            f"{row['ms']:.4f} ms ({row['design']}), torch.matmul {row['library_ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms; bounds: fp32 FMAs {row['bound_fp32_ms']:.4f} ms "
            f"({row['bound_fp32_by']}, {100 * row['share_fp32']:.1f} %), 3xTF32 "
            f"{row['bound_3xtf32_ms']:.4f} ms ({row['bound_3xtf32_by']}, "
            f"{100 * row['share_3xtf32']:.1f} %)"
            + "".join(f"; {k} {v:.1f} us" for k, v in row.get("kernels_us", {}).items()))
    # what this timing charges any launch, and what one library call takes
    # to read the triangle's bytes
    one = torch.zeros(1, device="cuda")
    empty_ms = time_ms(torch, lambda: one.zero_(), 20, flush)
    tri = L_blue.view(-1)[: n * (n + 1) // 2]
    floor_ms = time_ms(torch, lambda: tri.sum(), 20, flush)
    log(f"K1 yardsticks (median, L2 flushed): a launch that writes 4 bytes {empty_ms:.4f} ms; "
        f"torch.sum over the triangle's {4 * tri.numel()} bytes (contiguous) {floor_ms:.4f} ms")
    extra = {"crossover_m": SKINNY_MAX_M, "stream_floor_ms": floor_ms, "empty_launch_ms": empty_ms,
             "step0_max_abs_err_fp64": [{"L": lname, "m": m, "err": e} for lname, m, e in step0]}
    return rows, sweep, extra, worst_plain, worst_fp64


K2_CHECKED = (7, 48, 96, 192, 768, 1500)
K2_TIMED = (192, 1500)  # the res-64 train step (batch 64 x 3 channels); a batch of 500


def phase_k2(torch, L_blue, peak, flush):
    """K2 against its plain version and fp64 on the TPU test's L (bn within
    the TPU kernel's 1e-5) and on the blue-noise L (within TOL), the exact
    mix, GBN, the moments, determinism and K3's gradient rule; then K2 and
    the unfused torch sequence in alternating turns at M = 192 and 1500."""
    from bndm_tpu_torch.ops.cuda_bluenoise import (FusedBlueNoise, fused_bluenoise,
                                                   fused_bluenoise_flat,
                                                   fused_bluenoise_flat_plain)

    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(10)
    worst = {"wn": 0.0, "bn_plain": 0.0, "bn_fp64": 0.0}
    step0 = []
    for lname, L, tol in (("tpu_test", tpu_test_L(torch, n), 1e-5), ("blue", L_blue, TOL)):
        for m in K2_CHECKED:
            gamma = torch.rand(m, generator=g).cuda()
            seeds = (1000 + m, 77)
            noise, bn, wn = fused_bluenoise_flat(L, gamma, seeds)
            torch.cuda.synchronize()
            _, p_bn, p_wn = fused_bluenoise_flat_plain(L, gamma, seeds)
            ref = L.double() @ wn.double()
            errs = {"wn": (wn - p_wn).abs().max().item(),
                    "bn_plain": (bn - p_bn).abs().max().item(),
                    "bn_fp64": (bn.double() - ref).abs().max().item()}
            if lname == "tpu_test":  # the TPU kernel's own contract: absolute
                fp64_ok = errs["bn_fp64"] < tol
            else:
                fp64_ok = torch.allclose(bn.double(), ref, rtol=tol, atol=tol)
            ok = (torch.allclose(wn, p_wn, rtol=1e-5, atol=1e-5)
                  and torch.allclose(bn, p_bn, rtol=TOL, atol=TOL) and fp64_ok)
            exact = torch.equal(noise, bn * (1.0 - gamma[None, :]) + wn * gamma[None, :])
            gbn = fused_bluenoise_flat(L, gamma, seeds, True)
            gbn_ok = all(torch.equal(a, b) for a, b in zip(gbn, (bn, bn, wn)))
            log(f"K2 L={lname} M={m}: max|err| wn vs plain {errs['wn']:.3e} (1e-5), bn vs "
                f"plain {errs['bn_plain']:.3e} ({TOL}), vs fp64 {errs['bn_fp64']:.3e} ({tol}); "
                f"mix {'exact' if exact else 'NOT exact'}; GBN {'ok' if gbn_ok else 'FAIL'}")
            check(ok, f"K2 disagrees at L={lname} M={m}")
            check(exact, f"K2's mix is not exact at L={lname} M={m}")
            check(gbn_ok, f"K2's GBN output is not bn at L={lname} M={m}")
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
            if m in STEP0_M:
                step0.append((lname, m, errs["bn_fp64"]))
            if m >= 192:  # 4096 * 7 values are too few for the 0.02 bound
                mean, var = wn.mean().item(), wn.var().item()
                log(f"K2 L={lname} M={m}: wn mean {mean:+.5f}, variance {var:.5f}")
                check(abs(mean) < 0.02 and abs(var - 1.0) < 0.02,
                      f"K2's white noise is not standard normal at M={m}")
    log("K2 bn, the 3xTF32 arithmetic against fp64 (1e-5 on the TPU test's L, 2e-5 on the "
        "blue L): " + "; ".join(f"L={lname} M={m} max|err| {e:.3e}" for lname, m, e in step0))

    gamma = torch.rand(192, generator=g).cuda()
    a, b = fused_bluenoise_flat(L_blue, gamma, (3, 4)), fused_bluenoise_flat(L_blue, gamma, (3, 4))
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    other = [fused_bluenoise_flat(L_blue, gamma, s)[2] for s in ((3, 5), (4, 4))]
    differ = not any(torch.equal(a[2], w) for w in other)
    log(f"K2 determinism: same seeds same bits {same}, other seeds other bits {differ}")
    check(same and differ, "K2 is not deterministic in its seeds")

    # K3 at the training shape: batch 64, 3 channels
    gamma = torch.rand(64, generator=g).cuda().requires_grad_()
    noise, bn, wn = fused_bluenoise((5, 6), 64, 3, L_blue, gamma)
    (grad,) = torch.autograd.grad((noise ** 2).sum(), gamma)
    want = (2.0 * noise * (wn - bn)).sum(dim=(1, 2, 3)).detach()
    grad_err = (grad - want).abs().max().item()
    grad_ok = torch.allclose(grad, want, rtol=1e-5, atol=1e-3)
    cols = gamma.detach().repeat_interleave(3).requires_grad_()
    out, obn, own = FusedBlueNoise.apply(L_blue, cols, (5, 6), False)
    tan_err = 0.0
    for row in (0, 2047, 4095):
        sel = torch.zeros_like(out)
        sel[row] = 1.0
        (tan,) = torch.autograd.grad(out, cols, sel, retain_graph=True)
        tan_err = max(tan_err, (tan - (own - obn)[row]).abs().max().item())
    log(f"K3: grad of sum(noise^2) vs 2*sum(noise*(wn-bn)) max|err| {grad_err:.3e} "
        f"(rtol 1e-5, atol 1e-3, |grad| up to {want.abs().max().item():.1f}); tangent vs wn-bn "
        f"max|err| {tan_err:.3e} (1e-6)")
    check(grad_ok and tan_err <= 1e-6, "K3's gamma gradient disagrees")

    rows = []
    for m in K2_TIMED:
        gamma = torch.rand(m, generator=g).cuda()
        iters = 10 if m < 1000 else 5

        def unfused():  # what the unfused engine runs on the card, in torch
            w = torch.randn(n, m, device="cuda")
            return torch.matmul(L_blue, w) * (1.0 - gamma) + w * gamma

        turns = alternating({"unfused": unfused,
                             "kernel": lambda: fused_bluenoise_flat(L_blue, gamma, (3, 4))}, 5,
                            lambda fn: launch_times(torch, fn, iters, flush))
        plain_ms = time_ms(torch, lambda: fused_bluenoise_flat_plain(L_blue, gamma, (3, 4)),
                           iters, flush)
        row = shares({"m": m, "ms": turns["kernel"], "plain_ms": plain_ms,
                      "unfused_torch_ms": turns["unfused"]}, k2_bounds(n, m, peak), "3xtf32")
        rows.append(row)
        log(f"K2 M={m} times (median of 5 alternating turns, L2 flushed): kernel "
            f"{row['ms']:.4f} ms, unfused torch.randn + torch.matmul + mix "
            f"{row['unfused_torch_ms']:.4f} ms ({row['unfused_torch_ms'] / row['ms']:.2f}x the "
            f"kernel's time), plain {plain_ms:.4f} ms; bounds: fp32 FMAs "
            f"{row['bound_fp32_ms']:.4f} ms ({row['bound_fp32_by']}, "
            f"{100 * row['share_fp32']:.1f} %), 3xTF32 {row['bound_3xtf32_ms']:.4f} ms "
            f"({row['bound_3xtf32_by']}, {100 * row['share_3xtf32']:.1f} %)")

        row["kernels_us"] = kernel_breakdown(
            torch, lambda: fused_bluenoise_flat(L_blue, gamma, (3, 4)), flush)
        log(f"K2 M={m} device time per call by kernel (torch.profiler, 5 calls, L2 flushed): "
            + ", ".join(f"{k} {v:.1f} us" for k, v in row["kernels_us"].items()))

    k3_rows = []
    for m in K2_TIMED:
        _, bn, wn = fused_bluenoise_flat(L_blue, torch.rand(m, generator=g).cuda(), (7, 8))
        grad = torch.randn(n, m, generator=g).cuda()

        def backward():  # FusedBlueNoise.backward: torch ops, its own plain version
            return (grad * (wn - bn)).sum(dim=0)

        ms = time_ms(torch, backward, 30, flush)
        plain_ms = time_ms(torch, backward, 30, flush)
        bound_ms, bound_by = k3_bound(n, m, peak[0], peak[1])
        k3_rows.append({"m": m, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
        log(f"K3 M={m} backward times (median, L2 flushed): {ms:.4f} ms (again: {plain_ms:.4f} "
            f"ms), bound {bound_ms:.4f} ms ({bound_by})")
    extra = {"step0_max_abs_err_fp64": [{"L": lname, "m": m, "err": e} for lname, m, e in step0]}
    return rows, worst, {"grad_max_abs_err": grad_err, "tangent_max_abs_err": tan_err}, k3_rows, extra


def _twin_gap(torch, got, want, terms):
    """(worst excess, max |difference|) of ``got`` over its plain twin's
    ``want``: the excess is the difference less one ulp of ``want``'s dtype
    and 1e-5 of ``terms`` (the sum of the absolute values that made each
    element), the card test's tolerance; at most 0 passes."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - mant)
    err = (got.float() - want.float()).abs()
    return float((err - ulp - 1e-5 * terms).max()), float(err.max())


def _adaln_twin_check(torch, t, residual, eps):
    """Phase 4b (a): one fused unit's forward and backward on ``t`` against
    the plain twins (the backward twin on the kernels' own forward outputs)
    and against a second call bit for bit. Returns the max |difference| of
    each output."""
    from bndm_tpu_torch.ops import adaln as A

    y, gate = (t["y"], t["gate"]) if residual else (None, None)
    got = A.adaln_forward(t["x"], t["shift"], t["scale"], eps, y, gate)
    xs, z, mean, rstd = got
    gotb = A.adaln_backward(t["dz"], t["dxs"], xs, mean, rstd, t["scale"], y, gate)
    want = A.adaln_forward_plain(t["x"], t["shift"], t["scale"], eps, y, gate)
    wantb = A.adaln_backward_plain(t["dz"], t["dxs"], xs, mean, rstd, t["scale"], y, gate)
    check(torch.allclose(mean, want[2], rtol=1e-5, atol=1e-6)
          and torch.allclose(rstd, want[3], rtol=1e-5, atol=1e-6),
          "adaln: the row statistics are not the plain twin's")
    scale1, dz = 1 + t["scale"].float(), t["dz"].float()
    xhat = (xs - mean[..., None]) * rstd[..., None]
    dxhat = (dz * scale1).abs()
    terms_dx = rstd[..., None] * (dxhat + xhat.abs() * (dxhat * xhat.abs()).mean(-1, True)
                                  + dxhat.mean(-1, True)) + t["dxs"].abs()
    outs = {"x'": (xs, want[0], t["x"].abs() + (t["gate"].float() * t["y"].float()).abs()
                   if residual else 0),
            "z": (z, want[1], xhat.abs() * scale1.abs() + t["shift"].float().abs()),
            "dx": (gotb[0], wantb[0], terms_dx),
            "dshift": (gotb[1], wantb[1], dz.abs().sum(1, keepdim=True)),
            "dscale": (gotb[2], wantb[2], (dz * xhat).abs().sum(1, keepdim=True))}
    if residual:
        outs["dy"] = (gotb[3], wantb[3], t["gate"].float().abs() * terms_dx)
        outs["dgate"] = (gotb[4], wantb[4],
                         (terms_dx * t["y"].float().abs()).sum(1, keepdim=True))
    errs = {}
    for name, (a, b, terms) in outs.items():
        excess, errs[name] = _twin_gap(torch, a, b, terms)
        check(excess <= 0, f"adaln: {name} is {excess:.3g} outside the plain twin's tolerance "
                           f"({'with' if residual else 'without'} the residual input)")
    again = A.adaln_forward(t["x"], t["shift"], t["scale"], eps, y, gate)
    againb = A.adaln_backward(t["dz"], t["dxs"], again[0], again[2], again[3], t["scale"], y,
                              gate)
    check(all((a is None and b is None) or torch.equal(a, b)
              for a, b in zip(got + gotb, again + againb)),
          "adaln: a second call does not give the same bits")
    return errs


def _dit_gaps(torch, D, model, x, t, ref, fused):
    """Relative distances of ``model``'s output and parameter gradients,
    through the fused units or the plain sequence, from ``ref``'s."""
    was = D.fuses_adaln
    D.fuses_adaln = lambda h: fused
    try:
        out, grads = _dit_run(torch, model, x, t)
    finally:
        D.fuses_adaln = was
    ref_out, ref_grads = ref
    num = torch.stack([(a - b).norm() for a, b in zip(grads, ref_grads)]).norm()
    den = torch.stack([b.norm() for b in ref_grads]).norm()
    return float((out - ref_out).norm() / ref_out.norm()), float(num / den)


def _dit_run(torch, model, x, t):
    out = model(x, t).float()
    return out.detach(), torch.autograd.grad(out.square().mean(), list(model.parameters()))


DIT_BATCH = 16


def phase_adaln(torch):
    """Phase 4b: the fused adaLN units (ops/adaln.py) against their plain
    twins at the DiT-XL/2 train cell's shape, with and without the residual
    input, bit for bit twice; each form timed against the plain twin and the
    unfused model sequence in alternating turns (bench_adaln's timers), beside
    perfbench/adaln.py's byte bound; then the DiT path: DiT-XL/2 (the cell's
    bf16 model, its zero-initialised weights drawn) forward and backward at
    batch DIT_BATCH, counted, and held, as the plain bf16 sequence is, to the
    float32 model through the plain sequence."""
    from bndm_tpu_torch.models import dit as D
    from bndm_tpu_torch.scripts import bench_adaln as BA
    from perfbench import adaln as PA
    from perfbench.yardstick import PEAK_HBM_BYTES_S

    t = BA.inputs()  # (128, 256, 1152): bf16 branch and modulation, float32 stream
    elems = t["x"].numel()
    rows = {}
    for kind, residual, nbytes in (("interior", True, PA.INTERIOR), ("first", False, PA.FIRST)):
        errs = _adaln_twin_check(torch, t, residual, BA.EPS)
        k, pl = BA.turns(lambda: BA.fused(t, residual), lambda: BA.plain(t, residual))
        k2, un = BA.turns(lambda: BA.fused(t, residual), lambda: BA.unfused(t, residual))
        rows[kind] = {"ms": k, "ms_again": k2, "plain_ms": pl, "unfused_torch_ms": un,
                      "bound_ms": nbytes * elems / PEAK_HBM_BYTES_S * 1e3, "max_abs_err": errs}
        log(f"adaln {kind}: fused {k:.3f} ms (again {k2:.3f}), plain twin {pl:.3f} ms, unfused "
            f"model sequence {un:.3f} ms, bound {rows[kind]['bound_ms']:.3f} ms; max |diff| "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    del t
    torch.cuda.empty_cache()

    cfg = D.dit_config("DiT-XL/2", input_size=32, in_channels=4, learn_sigma=True,
                       dtype="bfloat16")
    torch.manual_seed(0)
    model = D.DiT(cfg, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():  # adaLN-Zero: without gates the units would add nothing
                p.normal_(0.0, 0.02)
    m32 = D.DiT(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    m32.load_state_dict(model.state_dict())
    x = torch.randn(DIT_BATCH, 4, 32, 32, device="cuda")
    tt = torch.rand(DIT_BATCH, device="cuda")
    units = 2 * cfg.depth + 1
    steps = 2
    reset_launches()
    for _ in range(steps):
        _dit_run(torch, model, x, tt)
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"adaln: DiT-XL/2 path, {steps} forward and backward passes at batch {DIT_BATCH}: "
        f"launches {counts}")
    check(counts["adaln_forward"] == counts["adaln_backward"] == steps * units,
          f"adaln: the DiT path must launch each fused pass {units} times a step")
    check(sum(counts.values()) == 2 * steps * units, "adaln: another kernel ran on the DiT path")
    was = D.fuses_adaln
    D.fuses_adaln = lambda h: False
    try:
        ref = _dit_run(torch, m32, x, tt)
    finally:
        D.fuses_adaln = was
    del m32
    fused, plain = (_dit_gaps(torch, D, model, x, tt, ref, f) for f in (True, False))
    log(f"adaln: DiT-XL/2 bf16 against the float32 model, output and gradients: fused units "
        f"{fused[0]:.3g}, {fused[1]:.3g}; plain sequence {plain[0]:.3g}, {plain[1]:.3g}")
    check(fused[0] <= 1.1 * plain[0] and fused[1] <= 1.1 * plain[1],
          "adaln: the fused DiT is farther from the float32 model than the plain bf16 sequence")
    del model, ref
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": counts["adaln_forward"] // steps,
            "launches_backward": counts["adaln_backward"] // steps,
            "dit_gap_fused": fused, "dit_gap_plain": plain}


def adaln_kernels(ad):
    """The kernels line's row of the fused adaLN units (phase 4b)."""
    r = ad["rows"]["interior"]
    return [{
        "name": "adaln",
        "route": "triton",
        "source": "bndm_tpu_torch/ops/adaln.py",
        "replaces": None,  # no TPU kernel: the JAX package leaves the sub-layer to XLA
        "note": "bndm_adaln_fwd; bndm_adaln_bwd + bndm_adaln_colsum; launches a DiT-XL/2 "
                "step, forward and backward",
        "launches": ad["launches"],
        "launches_backward": ad["launches_backward"],
        "max_abs_err": max(max(row["max_abs_err"].values()) for row in ad["rows"].values()),
        "ms": r["ms"],
        "kernel_ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call does the update, LayerNorm and modulation
        "unfused_torch_ms": r["unfused_torch_ms"],
        "unfused_torch": "x + gate * y, F.layer_norm, cast, modulation; autograd's backward",
        "shape": "(128, 256, 1152), bf16 over a float32 stream, forward and backward",
        "first": ad["rows"]["first"],
        "dit_gap_fused": ad["dit_gap_fused"],
        "dit_gap_plain": ad["dit_gap_plain"],
    }]


def _edge_input(torch, shape, seed):
    """bf16 ``shape`` of N(0, 64^2) values on the card, with +-0, +-inf,
    values of 256 and more (where +1 rounds), values far below 2^-8 and
    bf16 subnormals at the start, the end and every 997th element."""
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 64.0
    edges = torch.tensor([0.0, -0.0, math.inf, -math.inf, 256.0, 257.0, 258.0, -256.0, 511.0,
                          1e4, -1e4, 3e38, -1.0, 2.0**-9, -2.0**-9, 1e-20, -1e-30, 1e-39,
                          -1e-39], device="cuda")
    flat = x.view(-1)
    k = min(len(edges), flat.numel())
    flat[:k], flat[-k:] = edges[:k], edges[-k:]
    idx = torch.arange(0, flat.numel(), 997, device="cuda")
    flat[idx] = edges.repeat(len(idx) // len(edges) + 1)[: len(idx)]
    return x.to(torch.bfloat16)


def _bitwise(torch, got, want):
    """(bits equal, max |difference| over the finite values)."""
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = (got.float() - want.float()).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    return same, err


PROBE_TURNS = 5


def p1_name(variant):
    rows, schedule = variant
    return f"{rows} rows {schedule}"


def p2_name(variant):
    chunk, stages = variant
    return f"{chunk // 1024} KiB x {stages} stages"


def p3_name(variant):
    kib, warps, streaming = variant
    return f"{kib} KiB x {warps} warps" + (", streaming" if streaming else "")


def phase_probes(torch, peak_bytes):
    """P1-P3 bitwise against add_one_plain at the full and ragged shapes;
    every variant's time (CUDA events over ``inner`` chained passes) and
    torch.add's in alternating turns, the default variant's beside the
    plain version's and the bytes bound; then the two bench entry points at
    their full shapes, the launch counts reset before."""
    from bndm_tpu_torch.ops.stream_probes import (P1_DEFAULT, P2_DEFAULT, P3_DEFAULT, P3_SWEEP,
                                                  add_one_plain, dma_add_one, nhwc_add_one,
                                                  p1_resident, stream_add_one)
    from bndm_tpu_torch.scripts import bench_elementwise, bench_stream
    from bndm_tpu_torch.utils.timing import pass_ms

    t_phase = time.time()
    inner = 20
    variants = {"P1": [(p1_name((rpb, sched)), lambda y, r=rpb, s=sched: stream_add_one(y, r, s))
                       for rpb in bench_stream.ROWS_PER_BLOCK for sched in bench_stream.SCHEDULES],
                "P2": [(p2_name(v), lambda y, v=v: dma_add_one(y, *v))
                       for v in bench_stream.DMA_SWEEP],
                "P3": [(p3_name(v), lambda y, v=v: nhwc_add_one(y, *v)) for v in P3_SWEEP]}
    default = {"P1": p1_name(P1_DEFAULT), "P2": p2_name(P2_DEFAULT), "P3": p3_name(P3_DEFAULT)}
    full = {"P1": (256000, 1024), "P2": (256000, 1024), "P3": (500, 64, 64, 128)}
    ragged = {"P1": [(257, 1024), (5, 1001)], "P2": [(257, 1024), (5, 1001), (3, 13)],
              "P3": [(3, 8, 8, 128), (3, 5, 7, 9)]}
    worst = {"P1": 0.0, "P2": 0.0, "P3": 0.0}
    rows = {}
    for p, vs in variants.items():
        for seed, shape in enumerate(ragged[p] + [full[p]]):
            x = _edge_input(torch, shape, seed)
            want = add_one_plain(x)
            for vname, fn in vs:
                same, err = _bitwise(torch, fn(x), want)
                check(same, f"{p} ({vname}) is not bitwise add_one_plain at {shape}")
                worst[p] = max(worst[p], err)
            log(f"{p} at {shape}: {len(vs)} variant(s) bitwise equal to add_one_plain")
        x = _edge_input(torch, full[p], 99)
        moved = 2 * x.numel() * x.element_size()
        bound_ms = moved / peak_bytes * 1e3
        plain_ms = pass_ms(add_one_plain, x, inner)
        # torch.add, then each variant, then back
        turns = alternating({"torch.add": lambda y: torch.add(y, 1), **dict(vs)}, PROBE_TURNS,
                            lambda fn: [pass_ms(fn, x, inner)])
        lib_ms = turns.pop("torch.add")
        by_variant = [{"variant": vname, "ms": ms} for vname, ms in turns.items()]
        main = next(r for r in by_variant if r["variant"] == default[p])
        for r in by_variant:
            log(f"{p} {r['variant']} at {full[p]}: {r['ms']:.4f} ms, "
                f"{moved / r['ms'] / 1e6:.1f} GB/s, {100 * bound_ms / r['ms']:.1f} % of the "
                f"bound, {r['ms'] / lib_ms:.3f}x torch.add")
        rows[p] = dict(main, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       gb_s=moved / main["ms"] / 1e6, max_abs_err=worst[p],
                       shape=str(full[p]), by_variant=by_variant)
        log(f"{p} times ({inner} chained passes, CUDA events; medians of {PROBE_TURNS} "
            f"alternating turns, the default variant): {main['ms']:.4f} ms "
            f"({main['variant']}), plain {plain_ms:.4f} ms, torch.add {lib_ms:.4f} ms "
            f"({main['ms'] / lib_ms:.4f}x), bound {bound_ms:.4f} ms (bytes), "
            f"{100 * bound_ms / main['ms']:.1f} % of the bound")
        del x
    log(f"P1 persistent grid: {p1_resident} programs per SM (by device)")

    reset_launches()
    stream_rows = bench_stream.main()
    elem_rows = bench_elementwise.main()
    counts = read_launches()
    for p, name in (("P1", "stream_add_one"), ("P2", "dma_add_one"), ("P3", "nhwc_add_one")):
        rows[p]["launches"] = counts[name]
        check(counts[name] > 0, f"{p} was not launched by the bench entry points")
    check(len(stream_rows) == len(bench_stream.cases(1024))
          and len(elem_rows) == 1 + len(bench_elementwise.cases(128, "cpu")),  # + the fp32 copy
          "a bench case is missing")
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in stream_rows + elem_rows),
          "a bench case has no time")
    log(f"probes: launches in the bench entry points P1 {counts['stream_add_one']}, P2 "
        f"{counts['dma_add_one']}, P3 {counts['nhwc_add_one']}; phase {time.time() - t_phase:.1f}s")
    return rows


def phase_noise(torch, L_blue):
    from bndm_tpu_torch.ops.noise import get_noise

    L_cpu = L_blue.cpu()
    g = torch.Generator().manual_seed(1)
    for res, b in ((32, 2), (64, 2), (128, 1)):
        x = torch.randn(b, 3, res, res, generator=g)
        gamma = torch.linspace(0.2, 0.8, b)
        kw = dict(noise_type="gaussianBN", train=False, inplace=True)
        got = get_noise(x.cuda(), L_blue, gamma.cuda(), **kw)
        want = get_noise(x, L_cpu, gamma, **kw)
        for name, gg, ww in zip(("noise", "noise_bn", "noise_wn"), got, want):
            err = (gg.cpu() - ww).abs().max().item()
            ok = torch.allclose(gg.cpu(), ww, rtol=TOL, atol=TOL)
            log(f"noise res {res}: {name} CUDA vs CPU max|err| {err:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"noise engine disagrees at res {res} ({name})")


def phase_unet(torch):
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res

    torch.manual_seed(2)
    cpu = UNet2D(unet_config_for_res(64, out_channels=6)).eval()
    gpu = UNet2D(unet_config_for_res(64, out_channels=6), device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 64, 64, generator=g)
    t = torch.tensor([0.3, 0.9])
    with torch.no_grad():
        want = cpu(x, t)
        got = gpu(x.cuda(), t.cuda()).cpu()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
    log(f"UNet res-64 fp32 forward, CUDA vs CPU: max|err| {err:.3e} "
        f"(rtol=atol=1e-3, output max|.| {want.abs().max().item():.3f}) {'ok' if ok else 'FAIL'}")
    check(ok, "full-width UNet forward disagrees between CUDA and the CPU")


def phase_superres(torch, work, bn_dir):
    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.unet2d import unet_config_for_res

    # scripts/sampling/iadb_church_superres_test.sh:5
    argv = ["--dataset=church_res128", "--res=128", "--batch_size=200", "--train_or_test=test",
            "--nb_steps=250", "--test_samples=100", "--is_conditional",
            "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=0.2",
            "--out_channel=6", "--conditional_type=superres",
            "--device=cuda", f"--data_root={work}/data", f"--bluenoise_dir={bn_dir}"]
    make_procedural_folder(os.path.join(work, "data", "church_res128_test"), n=4, res=128, seed=0)
    out_dir = os.path.join(work, output_folder_name(parse_args(argv)))
    n_params = write_ckpt(torch, unet_config_for_res(128, in_channels=6, out_channels=6),
                          os.path.join(out_dir, "model.ckpt"), seed=4)
    log(f"super-res: {n_params} parameters (res-128 conditional UNet)")
    record = []
    reset_launches()
    with watched_sampler(record):
        text = run_cli(argv)
    counts = read_launches()
    launches = counts["tri_matmul"]
    log(f"super-res: K1 launches {launches} for {len(record)} requests, K2 launches "
        f"{counts['fused_bluenoise']}")
    check(len(record) == 4, f"expected 4 super-res requests, sampled {len(record)}")
    check(launches == len(record), "K1 must launch once per super-res request")
    check(counts["fused_bluenoise"] == 0, "K2 is not on the serving path")
    check(all(f and s == (1, 3, 128, 128) for s, f, _ in record), f"bad samples: {record}")
    m = re.search(r"ssim: (\S+), psnr: (\S+), l2: (\S+), l1: (\S+)", text)
    check(m is not None and all(math.isfinite(float(v.rstrip(","))) for v in m.groups()),
          "super-res metrics missing or not finite")
    check(n_params == 116_323_846, "super-res UNet is not the published 116.3M config")
    return {"launches": launches, "samples_per_s": [s[0] / sec for s, _, sec in record],
            "params": n_params}


def phase_uncond(torch, work, bn_dir):
    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.models.unet2d import unet_config_for_res

    # scripts/sampling/cat_res64_test.sh:5, at 2 batches of 16 (all saved)
    argv = ["--dataset=cat_res64", "--res=64", "--batch_size=16", "--train_or_test=test",
            "--nb_steps=250", "--test_samples=32", "--noise_type=gaussianBN",
            "--scheduler_gamma=sigmoid", "--scheduler_param=1000", "--out_channel=6",
            "--save_all_samples", "--device=cuda", f"--bluenoise_dir={bn_dir}"]
    trace_dir = os.path.join(work, "uncond_trace")
    out_dir = os.path.join(work, output_folder_name(parse_args(argv)))
    n_params = write_ckpt(torch, unet_config_for_res(64, out_channels=6),
                          os.path.join(out_dir, "model.ckpt"), seed=5)
    log(f"unconditional: {n_params} parameters (res-64 two-head UNet)")
    record = []
    reset_launches()
    with watched_sampler(record):
        text = run_cli(argv + [f"--profile_dir={trace_dir}"])
    counts = read_launches()
    log(f"unconditional: K1 launches {counts['tri_matmul']}, K2 launches "
        f"{counts['fused_bluenoise']} (the branch draws plain white x0)")
    traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    check(len(traces) == 1, f"--profile_dir wrote {traces}, not one trace file")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    log(f"unconditional: --profile_dir trace {traces[0]}, "
        f"{os.path.getsize(os.path.join(trace_dir, traces[0])) / 2**20:.1f} MiB, "
        f"{len(events)} events, {len(kernels)} distinct CUDA kernels")
    check(kernels, "the --profile_dir trace names no CUDA kernel")
    check(len(record) == 2 and all(f and s == (16, 3, 64, 64) for s, f, _ in record),
          f"bad samples: {record}")
    m = re.search(r"gallery: (\d+) images written", text)
    check(m is not None and int(m.group(1)) == 32, "expected 32 images written")
    check(n_params == 113_676_678, "unconditional UNet is not the published 113.7M config")
    return {"launches": counts["tri_matmul"],
            "samples_per_s": [s[0] / sec for s, _, sec in record], "params": n_params}


CAT64 = ["--dataset=cat_res64", "--res=64", "--train_or_test=test", "--nb_steps=250",
         "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=1000",
         "--out_channel=6"]  # scripts/sampling/cat_res64_test.sh:5


def _tier_run(torch, argv, want_batches, bs):
    """One CLI run through the serving tiers: every served batch finite and
    of batch ``bs``; returns samples/s per served batch, the calibration's
    seconds and the K1 launches."""
    record = []
    reset_launches()
    with watched_samplers(record):
        text = run_cli(argv)
    k1 = read_launches()["tri_matmul"]
    # every tier run here is cached: the plain sampler runs only to calibrate
    served = [r for r in record if r[0] != "sample_iadb"]
    cal = [r for r in record if r[0] == "sample_iadb"]
    check(len(served) == want_batches and all(f and shape[0] == bs for _, shape, f, _ in served),
          f"bad served samples: {served}")
    check(("serving calibration:" in text) == bool(cal), "calibration ran unannounced")
    return {"samples_per_s": [shape[0] / sec for _, shape, _, sec in served],
            "sampler": sorted({r[0] for r in served}), "calibration_s": sum(r[3] for r in cal),
            "k1": k1, "text": text}


def phase_serving_tiers(torch, work, bn_dir):
    """The serving tiers at full width (random seeded weights, 250 steps):

    (a) cache_interval=1 gives the plain chain's bits (cuDNN deterministic);
    (b) the shallow forward on the deep feature of the same (x, t) within
        1e-5 of the full forward at every depth, fp32, TF32 off;
    (c) the int8 product's int32 sums on the card equal the CPU's exactly
        at 128 ch x 64^2 (batch 16) and 512 ch x 4^2 (batch 1, 16 rows);
        the int8-static site timed beside the bf16 cuDNN conv;
    (d) the cat_res64 CLI with --conv_int8 --attn_softmax_dtype=bfloat16
        --cache_interval 8 on one batch of 16, again with --gn_carry, again
        with --microbatch 8; the same flags without --conv_int8 run first
        and last, so that int8's share of the stack's rate is measured;
    (e) the church super-res CLI with --conv_int8 --cache_interval 8 on 2
        images: K1 once per request;
    (f) make_validated_serving_sampler at probe_batch 4: each tier's SSIM,
        PSNR and gate; the chosen tier passed or is the plain path;
    (g) one full and one shallow forward of (d)'s served model, traced.
    """
    import dataclasses

    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.ops.int8 import int8_conv_accum, int8_conv_static
    from bndm_tpu_torch.samplers.iadb import sample_iadb, sample_iadb_cached
    from bndm_tpu_torch.serving import build_model, make_validated_serving_sampler

    out = {}
    sched = dict(scheduler_gamma="sigmoid", gamma_params=(1000.0, 0.0, 3.0), two_head=True)
    torch.manual_seed(8)
    cfg = unet_config_for_res(64, out_channels=6, dtype="bfloat16")
    sd = UNet2D(cfg, device="cpu").state_dict()
    g = torch.Generator().manual_seed(9)

    # (a)
    model = build_model(cfg, sd, "cuda")
    x0 = torch.randn(4, 3, 64, 64, generator=g).cuda()
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain, _ = sample_iadb(model, x0, nb_steps=25, **sched)
        cached = sample_iadb_cached(lambda x, t: model(x, t, return_deep=True),
                                    lambda x, t, deep: model(x, t, deep_feature=deep), x0,
                                    nb_steps=25, cache_interval=1, **sched)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
    same = torch.equal(plain, cached)
    log(f"tiers (a): cache_interval=1 against the plain chain, bf16 UNet, batch 4, 25 steps: "
        f"{'the same bits' if same else 'DIFFERENT'}")
    check(same and bool(torch.isfinite(plain).all()), "cache_interval=1 is not the plain chain")
    del model

    # (b)
    fp32 = build_model(dataclasses.replace(cfg, dtype="float32"), sd, "cuda")
    x = torch.randn(2, 3, 64, 64, generator=g).cuda()
    t = torch.tensor([0.3, 0.9], device="cuda")
    errs = []
    with torch.no_grad():
        for depth in range(1, len(cfg.block_out_channels)):
            fp32.cfg = dataclasses.replace(fp32.cfg, cache_depth=depth)  # read at call time
            full, deep = fp32(x, t, return_deep=True)
            errs.append((fp32(x, t, deep_feature=deep) - full).abs().max().item())
    log(f"tiers (b): shallow vs full forward, fp32, depths 1-{len(errs)}: max|err| "
        f"{[f'{e:.2e}' for e in errs]} (limit 1e-5)")
    check(max(errs) <= 1e-5, "the shallow forward disagrees with the full forward")
    del fp32

    # (c)
    out["int8_sites"] = []
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    for c, hw, b in ((128, 64, 16), (512, 4, 1)):
        xq = torch.randint(-127, 128, (b, c, hw, hw), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (c, c, 3, 3), generator=g, dtype=torch.int8)
        got = int8_conv_accum(xq.cuda(), wq.cuda()).cpu()
        equal = torch.equal(got, int8_conv_accum(xq, wq))
        xf = torch.randn(b, c, hw, hw, generator=g).cuda().to(torch.bfloat16)
        w = torch.randn(c, c, 3, 3, generator=g).cuda() * 0.02
        wb, bias = w.to(torch.bfloat16), torch.zeros(c, device="cuda", dtype=torch.bfloat16)
        scale = xf.float().abs().amax() / 127.0
        times = alternating({
            "int8": lambda: int8_conv_static(xf, w, scale),
            "bf16": lambda: torch.nn.functional.conv2d(xf, wb, bias, 1, 1)},
            5, lambda fn: [time_ms(torch, fn, 10, flush)])
        row = {"shape": f"{b}x{c}x{hw}x{hw}", "int32_equal": equal,
               "max_abs_sum": int(got.abs().max()), "int8_static_ms": times["int8"],
               "bf16_cudnn_ms": times["bf16"]}
        out["int8_sites"].append(row)
        log(f"tiers (c): int8 site {row['shape']}: int32 sums CUDA vs CPU "
            f"{'equal' if equal else 'DIFFER'} (max |sum| {row['max_abs_sum']}); int8-static "
            f"site {times['int8']:.4f} ms vs bf16 cuDNN conv {times['bf16']:.4f} ms")
        check(equal, f"the int8 product's sums differ between the card and the CPU at {row}")
    del flush

    # (d)
    argv = CAT64 + ["--batch_size=16", "--test_samples=16", "--save_all_samples",
                    "--device=cuda", f"--bluenoise_dir={bn_dir}", "--conv_int8",
                    "--attn_softmax_dtype=bfloat16", "--cache_interval=8"]
    run = os.path.join(work, "tiers_uncond")
    os.makedirs(run)
    with contextlib.chdir(run):
        write_ckpt(torch, unet_config_for_res(64, out_channels=6),
                   os.path.join(output_folder_name(parse_args(argv)), "model.ckpt"), seed=5)
        no_int8 = [a for a in argv if a != "--conv_int8"]
        for name, flags in (("bf16sm+cached(i=8)", no_int8),
                            ("int8+bf16sm+cached(i=8)", argv),
                            ("int8+gncarry+bf16sm+cached(i=8)", argv + ["--gn_carry"]),
                            ("int8+bf16sm+cached(i=8)+microbatch(8)", argv + ["--microbatch=8"]),
                            ("bf16sm+cached(i=8), again", no_int8)):
            r = _tier_run(torch, flags, 1, 16)
            check(r["k1"] == 0, "K1 is not on the unconditional path")
            check(re.search(r"gallery: 16 images written", r["text"]) is not None,
                  "expected 16 images written")
            out[name] = r
            log(f"tiers (d): {name}: {r['samples_per_s'][0]:.2f} samples/s (batch 16, "
                f"{r['sampler'][0]}); calibration {r['calibration_s']:.2f} s")

    # (e)
    argv = ["--dataset=church_res128", "--res=128", "--batch_size=200", "--train_or_test=test",
            "--nb_steps=250", "--test_samples=100", "--is_conditional",
            "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=0.2",
            "--out_channel=6", "--conditional_type=superres", "--device=cuda",
            f"--data_root={work}/data_tiers", f"--bluenoise_dir={bn_dir}", "--conv_int8",
            "--cache_interval=8"]  # scripts/sampling/iadb_church_superres_test.sh:5 + tiers
    make_procedural_folder(os.path.join(work, "data_tiers", "church_res128_test"), n=2, res=128,
                           seed=1)
    ckpt = os.path.join(work, output_folder_name(parse_args(argv)), "model.ckpt")
    if not os.path.exists(ckpt):  # phase 8 writes the same one
        write_ckpt(torch, unet_config_for_res(128, in_channels=6, out_channels=6), ckpt, seed=4)
    r = _tier_run(torch, argv, 2, 1)
    m = re.search(r"ssim: (\S+), psnr: (\S+), l2: (\S+), l1: (\S+)", r["text"])
    check(m is not None and all(math.isfinite(float(v.rstrip(","))) for v in m.groups()),
          "super-res metrics missing or not finite")
    check(r["k1"] == 2, f"K1 must launch once per super-res request, launched {r['k1']}")
    out["superres int8+cached(i=8)"] = r
    log(f"tiers (e): super-res int8+cached(i=8): samples/s per request "
        f"{[round(v, 3) for v in r['samples_per_s']]}; K1 launches {r['k1']} for 2 requests; "
        f"calibration {r['calibration_s']:.2f} s")

    # (f)
    t0 = time.perf_counter()
    sample, report = make_validated_serving_sampler(
        unet_config_for_res(64, out_channels=6, dtype="bfloat16"), sd, 250, 64,
        device="cuda", probe_batch=4, **sched)
    chosen = report[-1]["chosen"]
    passed = {r["tier"] for r in report if r.get("gate") == "pass"}
    log(f"tiers (f): validated ladder in {time.perf_counter() - t0:.1f} s: {report}")
    check(chosen in passed or chosen == "bf16 parity path", f"the ladder chose {chosen}")
    out["ladder"] = report
    del sample

    # (g)
    out["trace"] = trace_cached_step(torch, sd)
    return out


def trace_cached_step(torch, sd):
    """One full forward (returning the trunk) and one shallow forward of the
    served int8-static + bf16-softmax res-64 model at batch 16 (cache_depth
    1): host-clock time without the profiler, device busy time from
    torch.profiler."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from bndm_tpu_torch.models.unet2d import unet_config_for_res
    from bndm_tpu_torch.ops.int8 import calibrate_sampling
    from bndm_tpu_torch.serving import build_model

    base = unet_config_for_res(64, out_channels=6, dtype="bfloat16", conv_int8=True)
    cal = build_model(dataclasses.replace(base, int8_mode="calibrate"), sd, "cuda")
    served = build_model(dataclasses.replace(base, int8_mode="static",
                                             attn_softmax_dtype="bfloat16"), sd, "cuda")
    g = torch.Generator(device="cuda").manual_seed(10)
    served.load_quant(calibrate_sampling(
        cal, torch.randn(4, 3, 64, 64, generator=g, device="cuda"), 10,
        scheduler_gamma="sigmoid", gamma_params=(1000.0, 0.0, 3.0), two_head=True))
    del cal
    x = torch.randn(16, 3, 64, 64, generator=g, device="cuda")
    t = torch.full((16,), 0.5, device="cuda")
    out, n = {}, 5
    with torch.no_grad():
        _, deep = served(x, t, return_deep=True)
        for name, fn in (("full", lambda: served(x, t, return_deep=True)),
                         ("shallow", lambda: served(x, t, deep_feature=deep))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            kern = device_kernels(prof)
            busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / n / 1e3 \
                if kern else None
            out[name] = {"host_ms": wall_ms, "busy_ms": busy, "kernels": len(kern) / n}
            log(f"tiers (g): {name} forward, int8-static + bf16 softmax, bs 16: {wall_ms:.2f} ms "
                f"(host clock), device busy "
                f"{'not measured' if busy is None else f'{busy:.2f} ms ({100 * busy / wall_ms:.1f} %)'}"
                f", {len(kern) / n:.0f} kernels")
            if kern:
                _log_top(kern, 3)
    return out


# scripts/training/iadb_bn_cat_res64.sh:7 (gaussianBN, the two-head 113.7M UNet)
TRAIN64 = ["--dataset=cat_res64", "--res=64", "--epochs=1", "--train_or_test=train",
           "--lr=0.0001", "--grad_clip=1.0", "--noise_type=gaussianBN",
           "--scheduler_gamma=sigmoid", "--scheduler_param=1000", "--out_channel=6",
           "--device=cuda"]


def phase_train(torch, work, bn_dir):
    """The training CLI at full width: 8 steps at batch 64, then a resumed
    ninth step, traced. Returns K2's launches and the step times."""
    import numpy as np

    from bndm_tpu_torch import native
    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder

    bs, steps = 64, 8
    # one epoch of 512 images
    argv = TRAIN64 + [f"--batch_size={bs}", f"--data_root={work}/data",
                      f"--bluenoise_dir={bn_dir}"]
    make_procedural_folder(os.path.join(work, "data", "cat_res64"), n=bs * steps, res=64, seed=7)
    os.makedirs(os.path.join(work, "train"))
    with contextlib.chdir(os.path.join(work, "train")):
        run = os.path.abspath(output_folder_name(parse_args(argv)))
        record, last = [], {}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        native.reset_counts()
        with watched_trainer(record, last=last):
            text = run_cli(argv + [f"--max_steps={steps}"])
        counts = read_launches()
        decoded = dict(native.PATH_COUNTS)
        steady = _steady(torch, last, bs, "train")
        counts_k3 = counts["fused_bluenoise_grad"]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
        sched = np.loadtxt(os.path.join(run, "scheduler_params.txt"))
        log(f"train: {len(record)} steps of batch {bs}, {record[0][1] if record else 0} "
            f"parameters; K2 launches {counts['fused_bluenoise']}, K1 launches "
            f"{counts['tri_matmul']}; losses {losses.tolist()}; scheduler params "
            f"{sched.tolist()}; peak device memory {peak_gib:.2f} GiB")
        check(len(record) == steps and all(p == 113_676_678 for _, p, _ in record),
              f"expected {steps} steps of the 113.7M UNet, got {record}")
        check(counts["fused_bluenoise"] == steps, "K2 must launch once per train step")
        check(counts["fused_bluenoise_grad"] == steps, "K3 must run once per train step")
        check(counts["tri_matmul"] == 0, "K1 is not on the res-64 training path")
        log(f"train: images decoded by path {decoded}")
        check(decoded["native"] > 0, "the loader decoded no image through the native transform")
        check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
              "losses.txt must hold one finite loss per step")
        check(np.allclose(sched, [1000.0, 0.0, 3.0], rtol=0, atol=1e-6),
              "the published run's scheduler params must stay (1000, 0, 3)")
        check(re.search(r"^epoch 0: mean loss ", text, re.M) is not None, "no epoch line")
        for f in ("model.npz", f"checkpoints/{steps}/state.pt", "losses.png",
                  "scheduler_params.png", "logs/metrics.jsonl"):
            check(os.path.exists(os.path.join(run, f)), f"the run folder lacks {f}")

        # resume from the full-state checkpoint and take one more step, traced
        resumed, kern = [], []
        reset_launches()
        with watched_trainer(resumed, traced=kern):
            text = run_cli(argv + [f"--max_steps={steps + 1}", "--resume_training"])
        counts = read_launches()
        after = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
        log(f"train resume: K2 launches {counts['fused_bluenoise']}, losses {after.tolist()}")
        check(f"resumed full state at step {steps}" in text, "the resume did not restart at step 8")
        check(len(resumed) == 1 and counts["fused_bluenoise"] == 1 and after.shape == (1,)
              and bool(np.isfinite(after).all()), "the resumed run must take one finite step")
        check(os.path.exists(os.path.join(run, f"checkpoints/{steps + 1}/state.pt")),
              "the resumed run saved no checkpoint")

    secs = [s for s, *_ in record]
    rate = bs * (steps - 1) / sum(secs[1:])
    log(f"train: first step {secs[0]:.3f} s; steps 2-{steps}: {rate:.2f} images/s "
        f"(host clock, synchronised; per step {[round(s, 4) for s in secs[1:]]}; main-thread "
        f"CPU per step {[round(c, 4) for *_, c in record[1:]]})")
    if kern:
        busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
        mean_ms = 1e3 * sum(secs[1:]) / (steps - 1)
        k2_us = sum(e.time_range.elapsed_us() for e in kern if "fused_bluenoise" in e.name)
        log(f"trace train step (bs {bs}, resumed step): device busy {busy_ms:.2f} ms, "
            f"{100 * busy_ms / mean_ms:.1f} % of the untraced mean step {mean_ms:.2f} ms, "
            f"{100 * busy_ms / steady[1]:.1f} % of the steady median step {steady[1]:.2f} ms; "
            f"{len(kern)} kernels; K2 {k2_us / 1e3:.4f} ms")
        _log_top(kern)
    else:
        log("trace train step: device time not measured (the profiler saw no CUDA kernels)")
    return {"launches": steps, "k3_launches": counts_k3, "first_step_s": secs[0],
            "images_per_s": rate, "steady_images_per_s": steady[0],
            "step_s": secs, "peak_gib": peak_gib}


# scripts/sampling/cat_res64_test.sh:7 (the DDIM baseline: res 64, the 3 -> 3
# UNet, 1000 train T, 250 leading steps, clip_sample); the dataset's name
# keeps the reference's replicability filter (cat_res64: batch 4 only) out
DDIM64 = ["--dataset_name=procedural_cat_res64", "--resolution=64", "--random_flip",
          "--output_dir=ddim_cat_res64", "--gradient_accumulation_steps=1",
          "--learning_rate=1e-4", "--lr_warmup_steps=0", "--use_ema", "--device=cuda"]
# scripts/training/latent_iadb_celeba_res256.sh:3 and latent_iadb_cat_res512.sh:6
LATENT = ["--random_flip", "--gradient_accumulation_steps=1", "--learning_rate=1e-4",
          "--lr_warmup_steps=0", "--out_channels=4", "--noise_type=gaussianBN", "--device=cuda"]
LATENT256 = LATENT + ["--dataset_name=celeba_res256", "--resolution=256",
                      "--output_dir=latent_iadb_celeba_res256"]
LATENT512 = LATENT + ["--dataset_name=cat_res512", "--resolution=512",
                      "--output_dir=latent_iadb_cat_res512"]


def _check_files(run, files):
    for f in files:
        check(os.path.exists(os.path.join(run, f)), f"the run folder lacks {f}")


def _step_rates(record, bs):
    """(first step's seconds, images/s over the steps after it)."""
    secs = [s for s, *_ in record]
    return secs[0], (bs * (len(secs) - 1) / sum(secs[1:]) if len(secs) > 1 else None)


STEADY_STEPS = 12


def _steady(torch, last, bs, label):
    """``STEADY_STEPS`` more calls of a CLI run's last train step (its last
    batch, after the CLI returned: no loader thread decodes beside them).
    Logs and returns (images/s, median step ms, median main-thread CPU ms
    a step) on the host clock, synchronised."""
    import statistics

    again = last.pop("again")
    wall, cpu = [], []
    for _ in range(STEADY_STEPS):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        again()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        cpu.append(time.thread_time() - c0)
    rate = bs * len(wall) / sum(wall)
    med, med_cpu = 1e3 * statistics.median(wall), 1e3 * statistics.median(cpu)
    log(f"{label}: {STEADY_STEPS} steady steps (the last batch again, no loader thread): "
        f"{rate:.2f} images/s, median step {med:.2f} ms, main-thread CPU {med_cpu:.2f} ms a "
        f"step; per step {[round(w, 4) for w in wall]}")
    return rate, med, med_cpu


def _traced(kern, mean_ms, label):
    """Log the traced step's device busy time and share and its top
    kernels; returns (busy ms, busy share)."""
    if not kern:
        log(f"trace {label}: device time not measured (the profiler saw no CUDA kernels)")
        return None, None
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
    log(f"trace {label}: device busy {busy_ms:.2f} ms, {100 * busy_ms / mean_ms:.1f} % of "
        f"the untraced mean step {mean_ms:.2f} ms; {len(kern)} kernels")
    _log_top(kern)
    return busy_ms, busy_ms / mean_ms


def phase_ddim(torch, work):
    """The DDIM baseline at full width (random seeded weights):

    (a) train: the CLI for 8 steps at batch 64 with --use_ema on 512
        procedural images, 12 steady steps (the last batch again), then
        one resumed step (--resume_from_checkpoint latest), traced; no
        hand kernel on the path;
    (b) test: 2 batches of 16, plain, 250 steps, with frames; then
        --conv_int8 (static) --cache_interval 8 on the same weights, one
        batch of 16, its calibration seconds beside;
    (c) one fp32 DDIM step (UNet + scheduler, TF32 off) on the card against
        the CPU at 1e-3, and the same bits from a second call.
    """
    import numpy as np

    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.samplers import ddim as sddim
    from bndm_tpu_torch.train import ddim as tddim

    out = {}
    bs, steps = 64, 8
    data = os.path.join(work, "data_ddim")
    make_procedural_folder(os.path.join(data, "procedural_cat_res64"), n=bs * steps, res=64,
                           seed=11)
    argv = DDIM64 + [f"--data_root={data}"]
    train = argv + ["--train_or_test=train", f"--train_batch_size={bs}", "--num_epochs=1"]
    run = os.path.join(work, "results_gaussianBN", "ddim_cat_res64_ema")

    # (a)
    record, last = [], {}
    reset_launches()
    with watched_steps(record, tddim, "make_ddim_train_step", last=last):
        run_cli(train + [f"--max_steps={steps}"], "ddim")
    counts = read_launches()
    steady = _steady(torch, last, bs, "ddim train")
    losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
    log(f"ddim train: {len(record)} steps of batch {bs}, {record[0][1] if record else 0} "
        f"parameters; launches {counts}; losses {losses.tolist()}")
    check(len(record) == steps and all(p == 113_673_219 for _, p, _ in record),
          f"expected {steps} steps of the 113.7M 3->3 UNet, got {record}")
    check(not any(counts.values()), "no hand kernel is on the DDIM path")
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          "losses.txt must hold one finite loss per step")
    _check_files(run, ("unet/model.npz", "unet_ema/model.npz", "unet/config.json",
                       "unet/diffusion_pytorch_model.safetensors",
                       "scheduler/scheduler_config.json", "model_index.json",
                       f"checkpoints/{steps}/state.pt"))
    resumed, kern = [], []
    with watched_steps(resumed, tddim, "make_ddim_train_step", traced=kern, trace_step=0):
        text = run_cli(train + [f"--max_steps={steps + 1}", "--resume_from_checkpoint=latest"],
                       "ddim")
    check(f"Resuming from checkpoint step {steps}" in text, "the resume did not restart at step 8")
    check(len(resumed) == 1, "the resumed run must take one step")
    _check_files(run, (f"checkpoints/{steps + 1}/state.pt",))
    first, rate = _step_rates(record, bs)
    log(f"ddim train: first step {first:.3f} s; steps 2-{steps}: {rate:.2f} images/s (host "
        f"clock, synchronised; main-thread CPU per step {[round(c, 4) for *_, c in record[1:]]})")
    busy, share = _traced(kern, 1e3 * bs / rate, f"ddim train step (bs {bs}, resumed)")
    if busy:
        log(f"trace ddim train step: {100 * busy / steady[1]:.1f} % of the steady median step "
            f"{steady[1]:.2f} ms")
    out["train"] = {"images_per_s": rate, "first_step_s": first, "busy_ms": busy,
                    "busy_share": share, "steady_images_per_s": steady[0],
                    "steady_busy_share": busy / steady[1] if busy else None}

    # (b)
    test = argv + ["--train_or_test=test", "--eval_batch_size=16"]
    rec = []
    reset_launches()
    with watched_samplers(rec, sddim, ("sample_ddim", "sample_ddim_cached")):
        text = run_cli(test + ["--test_samples=32"], "ddim")
    check(not any(read_launches().values()), "no hand kernel is on the DDIM path")
    check(len(rec) == 2 and all(n == "sample_ddim" and f and s == (16, 3, 64, 64)
                                for n, s, f, _ in rec), f"bad samples: {rec}")
    n_img = len(os.listdir(os.path.join(run, "images")))
    n_seq = len(os.listdir(os.path.join(run, "seqs")))
    check(n_img == 32 and n_seq == 22, f"expected 32 images and 22 frames, got {n_img}, {n_seq}")
    out["plain"] = [16 / sec for *_, sec in rec]
    rec = []
    with watched_samplers(rec, sddim, ("sample_ddim", "sample_ddim_cached")):
        text = run_cli(test + ["--test_samples=16", "--conv_int8", "--cache_interval=8"], "ddim")
    served = [r for r in rec if r[0] == "sample_ddim_cached"]
    cal = [r for r in rec if r[0] == "sample_ddim"]
    check(len(served) == 1 and served[0][2] and served[0][1] == (16, 3, 64, 64)
          and len(cal) == 1 and "serving calibration:" in text, f"bad tier run: {rec}")
    out["tier"] = {"samples_per_s": 16 / served[0][3], "calibration_s": cal[0][3]}
    log(f"ddim test: samples/s (sampler only, synchronised) plain {out['plain']}; "
        f"int8-static + cached(i=8) {out['tier']['samples_per_s']:.2f}, calibration "
        f"{cal[0][3]:.2f} s (8 samples)")

    # (c)
    torch.manual_seed(12)
    cfg = unet_config_for_res(64)
    cpu = UNet2D(cfg).eval()
    gpu = UNet2D(cfg, device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(13))
    sc, sg = sddim.DDIMScheduler(), sddim.DDIMScheduler().to("cuda")
    sc.set_timesteps(250)
    sg.set_timesteps(250)
    i = 125  # t = 496, mid-trajectory
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with torch.no_grad():
            want = sc.step(cpu(x, sc.timesteps[i].float().expand(2)), sc.timesteps[i], x)
            xg = x.cuda()
            got = [sg.step(gpu(xg, sg.timesteps[i].float().expand(2)), sg.timesteps[i], xg)
                   for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
    err = (got[0].cpu() - want).abs().max().item()
    ok = torch.allclose(got[0].cpu(), want, rtol=1e-3, atol=1e-3)
    same = torch.equal(got[0], got[1])
    log(f"ddim fp32 step (t = {int(sc.timesteps[i])}), CUDA vs CPU: max|err| {err:.3e} "
        f"(rtol=atol=1e-3) {'ok' if ok else 'FAIL'}; second call "
        f"{'the same bits' if same else 'OTHER BITS'}")
    check(ok and same and bool(torch.isfinite(got[0]).all()), "the DDIM step disagrees")
    out["step_max_abs_err"] = err
    return out


def _latent_train(torch, argv, run, bs, steps, kernel, params, trace):
    """The latent CLI's train mode for ``steps`` steps (the last traced
    under ``trace``): the named hand kernel launched once a step, the other
    not at all."""
    import numpy as np

    from bndm_tpu_torch.train import latent as tlatent

    record, kern = [], []
    reset_launches()
    with watched_steps(record, tlatent, "make_latent_train_step", traced=kern if trace else None,
                       trace_step=steps - 1):
        text = run_cli(argv + ["--train_or_test=train", f"--train_batch_size={bs}",
                               f"--num_epochs={steps}", f"--max_steps={steps}"], "latent_iadb")
    counts = read_launches()
    losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
    log(f"latent train ({run.rsplit('/', 1)[-1]}): {len(record)} steps of batch {bs}, "
        f"{record[0][1] if record else 0} parameters; launches {counts}; losses "
        f"{losses.tolist()}")
    other = "fused_bluenoise" if kernel == "tri_matmul" else "tri_matmul"
    check(len(record) == steps and all(p == params for _, p, _ in record),
          f"expected {steps} steps of the {params}-parameter UNet, got {record}")
    check(counts[kernel] == steps, f"{kernel} must launch once per latent train step")
    check(counts[other] == 0, f"{other} is not on this latent training path")
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          "losses.txt must hold one finite loss per step")
    check("latent cache built:" in text, "no latent cache was built")
    _check_files(run, ("unet/model.npz", "unet/config.json", "model_index.json",
                       f"checkpoints/{steps}/state.pt"))
    first, rate = _step_rates(record[:-1] if trace else record, bs)
    n_rate = steps - 1 - bool(trace)
    log(f"latent train: first step {first:.3f} s, then {rate:.2f} images/s over steps 2-"
        f"{n_rate + 1} (host clock, synchronised, untraced; per step "
        f"{[round(s, 4) for s, *_ in record[1:]]}, main-thread CPU "
        f"{[round(c, 4) for *_, c in record[1:]]})")
    busy = share = None
    if trace:
        busy, share = _traced(kern, 1e3 * bs / rate,
                              f"latent train step {steps} (bs {bs}; mean of {n_rate})")
    return {"launches": counts[kernel], "images_per_s": rate, "first_step_s": first,
            "busy_ms": busy, "busy_share": share, "rate_steps": n_rate}


def phase_latent(torch, work, bn_dir):
    """The latent pipeline at full width: the celeba_res256 config (latent32
    UNet, out 4 x 2 two-head, gaussianBN, lr 1e-4) with the default SD-VAE
    config (random init):

    (a) the cache from 128 procedural 256^2 images (256 latents), then 10
        train steps at batch 256, one an epoch (the last traced, the rate
        over steps 2-9): K1 once per step, K2 never;
    (b) test: one batch of 16, 250 steps, --decode_microbatch 16;
    (c) the VAE's fp32 decode of 2 latents on the card against the CPU at
        1e-3.
    """
    import re

    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from bndm_tpu_torch.samplers import iadb

    data = os.path.join(work, "data_latent")
    make_procedural_folder(os.path.join(data, "celeba_res256"), n=128, res=256, seed=14)
    argv = LATENT256 + [f"--data_root={data}", f"--bluenoise_dir={bn_dir}"]
    run = os.path.join(work, "results_gaussianBN", "latent_iadb_celeba_res256_gaussianBN")
    out = {"train": _latent_train(torch, argv, run, 256, 10, "tri_matmul", 25_845_512, True)}

    rec = []
    reset_launches()
    with watched_samplers(rec, iadb, ("sample_iadb",)):
        text = run_cli(argv + ["--train_or_test=test", "--eval_batch_size=16",
                               "--test_samples=16", "--decode_microbatch=16"], "latent_iadb")
    check(not any(read_launches().values()), "no hand kernel is on the latent sampling path")
    check(len(rec) == 1 and rec[0][2] and rec[0][1] == (16, 4, 32, 32), f"bad samples: {rec}")
    m = re.search(r"batch 0: 16 samples in \S+s \((\S+) samples/s\)", text)
    n_img = len(os.listdir(os.path.join(run, "images")))
    check(m is not None and n_img == 16, f"expected 16 decoded images, got {n_img}")
    out["test"] = {"sampler_samples_per_s": 16 / rec[0][3],
                   "with_decode_samples_per_s": float(m.group(1))}
    log(f"latent test: 16 samples, sampler {out['test']['sampler_samples_per_s']:.2f} "
        f"samples/s, sampler + decode {out['test']['with_decode_samples_per_s']:.2f} samples/s "
        "(host clock, synchronised)")

    torch.manual_seed(0)
    cpu = AutoencoderKL(VAEConfig()).eval()
    n_params = sum(p.numel() for p in cpu.parameters())
    gpu = AutoencoderKL(VAEConfig(), device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    z = torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(15))
    with torch.no_grad():
        want = cpu.decode(z)
        got = gpu.decode(z.cuda()).cpu()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
    log(f"VAE fp32 decode of 2 latents (SD config, {n_params} parameters), CUDA vs CPU: "
        f"max|err| {err:.3e} (rtol=atol=1e-3, output max|.| {want.abs().max().item():.3f}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok and n_params == 83_653_863 and got.shape == (2, 3, 256, 256),
          "the VAE decode disagrees between CUDA and the CPU")
    out["vae_max_abs_err"] = err
    return out


def phase_latent512(torch, work, bn_dir):
    """The cat_res512 latent config, reduced: 6 train steps at batch 64
    (published: 256) on 32 procedural 512^2 images (64 latents, one batch
    an epoch; the last traced, the rate over steps 2-5): K2 once per step,
    K1 never."""
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder

    data = os.path.join(work, "data_latent512")
    make_procedural_folder(os.path.join(data, "cat_res512"), n=32, res=512, seed=16)
    argv = LATENT512 + [f"--data_root={data}", f"--bluenoise_dir={bn_dir}"]
    run = os.path.join(work, "results_gaussianBN", "latent_iadb_cat_res512_gaussianBN")
    return _latent_train(torch, argv, run, 64, 6, "fused_bluenoise", 113_680_136, True)


def _log_top(kern, k=5):
    """The ``k`` kernels that take the most device time, with their share."""
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]:
        log(f"  {100 * us / total:5.1f} %  {kname[:110]}")


def _busy_us(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _trace_forward(torch, name, fn, shape_note, n=5):
    """Host-clock time per call of ``fn`` without the profiler (which slows
    dispatch), then the device's busy time and top kernels from
    torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    kern = device_kernels(prof)
    if not kern:
        log(f"trace {name}: {wall_ms:.2f} ms (host clock); device time not measured (the "
            "profiler saw no CUDA kernels)")
        return
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / n / 1e3
    log(f"trace {name} ({shape_note}): {wall_ms:.2f} ms (host clock), device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), {len(kern) / n:.0f} kernels "
        "per call")
    _log_top(kern)


def phase_trace(torch):
    """Where a served step's time goes: one UNet forward of each branch at
    its served shape, in bf16 as the CLI serves it (the pixel branches, the
    DDIM baseline, the latent res-256 sampler), and one VAE decode of a
    batch of 16 latents in bf16 (the latent test's microbatch)."""
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    for name, layout, in_ch, out_ch, bs, res in (
            ("super-res", 128, 6, 6, 1, 128), ("unconditional", 64, 3, 6, 16, 64),
            ("ddim", 64, 3, 3, 16, 64), ("latent res-256", "latent32", 4, 8, 16, 32)):
        torch.manual_seed(6)
        cfg = unet_config_for_res(layout, in_channels=in_ch, out_channels=out_ch,
                                  dtype="bfloat16")
        model = UNet2D(cfg, device="cuda").cast_params_().eval()
        x = torch.randn(bs, in_ch, res, res, device="cuda")
        t = torch.full((bs,), 0.5, device="cuda")
        _trace_forward(torch, name, lambda: model(x, t), f"bs {bs}, res {res}, bf16, forward")
        del model
    vae = AutoencoderKL(VAEConfig(dtype="bfloat16"), device="cuda").eval()
    z = torch.randn(16, 4, 32, 32, device="cuda")
    _trace_forward(torch, "VAE decode", lambda: vae.decode(z), "16 latents of 32^2 -> 256^2, bf16",
                   n=3)
    del vae


def _allreduce_ms(torch, numel, reps=5):
    """Median time (CUDA events) of one all-reduce of ``numel`` fp32 values
    on the card over the joined process group: a step's gradient."""
    import torch.distributed as dist

    buf = torch.zeros(numel, device="cuda")
    times = []
    for _ in range(reps + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        dist.all_reduce(buf)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return median(times[1:])


def phase_parallel(torch, work, bn_dir):
    """15. Data parallelism at full width. (a) The pixel CLI's train mode
    (TRAIN64, batch 64, 3 steps) as one NCCL rank through the launch flags,
    against the same run without a process group: the same losses and
    weights bit for bit (cuDNN held to deterministic algorithms in both).
    (b) Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device), 32 rows each of one global batch, one step of the fp32 UNet
    (K2 at the global M on each rank; the schedule at (0.2, 0, 3), whose
    gradient is not zero, dryrun.py::grads_config), against this process
    on the same batch, t and noise: the summed UNet and (tau, s, e)
    gradients within 1e-5 x their norms of the same two 32-row blocks
    stepped in turn (dryrun.py::split_grads); against one 64-row pass, the
    UNet's within 1e-5 x its norm and the (tau, s, e) within rtol 1e-3, the
    fp32 rounding of another partition, which the loss weight dgamma/dalpha
    (dalpha = 1/T) scales: whole against split is read at T = 100, 1000 and
    10000. The all-reduce of a step's gradient timed for both."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from bndm_tpu_torch.cli.common import load_L_for, output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import ImageFolderDataset, make_procedural_folder
    from bndm_tpu_torch.dryrun import free_port, grads_config, run_ranks, split_grads
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.parallel import shutdown
    from bndm_tpu_torch.train import pixel

    bs, steps = 64, 3
    data = os.path.join(work, "data_par")
    make_procedural_folder(os.path.join(data, "cat_res64"), n=bs * steps, res=64, seed=9)
    argv = TRAIN64 + [f"--batch_size={bs}", f"--max_steps={steps}", f"--data_root={data}",
                      f"--bluenoise_dir={bn_dir}"]
    runs, wrapped, out = {}, [], {}
    real_wrap = pixel.wrap_ddp

    def watched_wrap(model, mesh):
        ddp = real_wrap(model, mesh)
        wrapped.append(type(ddp).__name__)
        return ddp

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pixel.wrap_ddp = watched_wrap
    try:
        for name, extra in (("alone", []),
                            ("nccl1", [f"--coordinator_address=127.0.0.1:{free_port()}",
                                       "--num_processes=1", "--process_id=0"])):
            d = os.path.join(work, f"par_{name}")
            os.makedirs(d)
            with contextlib.chdir(d):
                reset_launches()
                run_cli(argv + extra)
                counts = read_launches()
                run = os.path.abspath(output_folder_name(parse_args(argv)))
            with np.load(os.path.join(run, "model.npz")) as z:
                weights = {k: z[k] for k in z.files}
            runs[name] = (np.loadtxt(os.path.join(run, "losses.txt")), weights, counts)
            if name == "nccl1":
                check(dist.is_initialized() and dist.get_backend() == "nccl"
                      and dist.get_world_size() == 1, "the launch flags joined no NCCL group")
                numel = sum(v.size for v in weights.values())
                out["nccl1_allreduce_ms"] = _allreduce_ms(torch, numel)
                out["grad_mb"] = 4 * numel / 1e6
                shutdown()
    finally:
        pixel.wrap_ddp = real_wrap
        torch.backends.cudnn.deterministic = was
        shutdown()
    (la, wa, ca), (lb, wb, cb) = runs["alone"], runs["nccl1"]
    log(f"parallel (a): losses alone {la.tolist()}, one NCCL rank {lb.tolist()}; the step's "
        f"module {wrapped}; K2 launches {ca['fused_bluenoise']} and {cb['fused_bluenoise']}")
    check(wrapped == ["UNet2D", "DistributedDataParallel"],
          f"the one-rank run must train through DDP, the other without: {wrapped}")
    check(ca["fused_bluenoise"] == cb["fused_bluenoise"] == steps,
          "K2 must launch once per step in both runs")
    check(np.array_equal(la, lb), "one NCCL rank's losses are not the run's bit for bit")
    check(sorted(wa) == sorted(wb) and all(np.array_equal(wa[k], wb[k]) for k in wa),
          "one NCCL rank's weights are not the run's bit for bit")
    log(f"parallel (a): losses and all {len(wa)} weight arrays bit for bit; all-reduce of the "
        f"step's gradient ({out['grad_mb']:.1f} MB fp32) on one NCCL rank "
        f"{out['nccl1_allreduce_ms']:.4f} ms (median of 5, CUDA events)")

    # (b) two gloo ranks on the card against one rank, one step of 64 rows
    ds = ImageFolderDataset(os.path.join(data, "cat_res64"), 64, random_flip=False)
    x1 = np.stack([ds.get(i) for i in range(bs)]) * 2.0 - 1.0
    L = load_L_for("gaussianBN", bn_dir)
    inputs, grads = os.path.join(work, "par_in.npz"), os.path.join(work, "par_out.npz")
    np.savez(inputs, L=L, seed=3, x1=x1, key=np.array([0, 5]))
    cfg, L_cuda = grads_config(True), torch.from_numpy(L).cuda()
    torch.manual_seed(3)
    model = UNet2D(unet_config_for_res(64, 3, 6), device="cuda").train()
    step, init = pixel.make_train_step(cfg, L_cuda)
    state = init(model, torch.Generator().manual_seed(0))
    x1_cuda = torch.from_numpy(x1).cuda()
    sp = state.sched_params

    def grads_of(fn):
        model.zero_grad(set_to_none=True)
        sp.grad = None
        fn()
        return ({k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()},
                sp.grad.detach().cpu().numpy())

    def rel(a, b):
        return float(np.abs(a - b).max() / np.linalg.norm(b))

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the ranks' algorithms (dryrun.py::_grads)
    try:
        reset_launches()
        t, noise = step.draw(x1_cuda, (0, 5))
        loss1 = float(step.compute_grads(state, x1_cuda, t, noise))
        counts = read_launches()
        g1 = {k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()}
        s1 = sp.grad.detach().cpu().numpy()
        gs, ss = grads_of(lambda: split_grads(cfg, L_cuda, model, sp, x1_cuda, t, noise, 2))
        by_T = {1000: rel(s1, ss)}
        for T in (100, 10000):  # the same draw key at another T: whole against split
            cfg_T = dataclasses.replace(cfg, nb_steps=T)
            step_T, _ = pixel.make_train_step(cfg_T, L_cuda)
            t_T, noise_T = step_T.draw(x1_cuda, (0, 5))
            _, sw_T = grads_of(lambda: step_T.loss_fn(model, sp, x1_cuda, t_T, noise_T)
                               .backward())
            _, ss_T = grads_of(lambda: split_grads(cfg_T, L_cuda, model, sp, x1_cuda, t_T,
                                                   noise_T, 2))
            by_T[T] = rel(sw_T, ss_T)
    finally:
        torch.backends.cudnn.deterministic = was
    del model, state, step, x1_cuda, t, noise, sp
    torch.cuda.empty_cache()
    t0 = time.time()
    run_ranks(2, ["--job", "grads", "--full_width", "--inputs", inputs, "--out", grads],
              device="cuda", backend="gloo", timeout=300)
    got = np.load(grads)
    norm = math.sqrt(sum(float(np.sum(np.square(v.astype(np.float64)))) for v in g1.values()))
    err = max(float(np.abs(got[f"g/{k}"] - v).max()) for k, v in g1.items())
    err_split = max(float(np.abs(got[f"g/{k}"] - v).max()) for k, v in gs.items())
    s_norm = float(np.linalg.norm(s1))
    s_err = float(np.abs(got["sched"] - s1).max())
    s_err_split = float(np.abs(got["sched"] - ss).max())
    loss2 = float(got["loss"])
    log(f"parallel (b): 2 gloo ranks on the card ({time.time() - t0:.1f}s with their start): "
        f"loss {loss2:.6g} vs one rank {loss1:.6g}; UNet grads max|diff| {err:.3e} "
        f"(bound 1e-5 x norm {norm:.4g} = {1e-5 * norm:.3e}); (tau, s, e) grads "
        f"{got['sched'].tolist()} vs {s1.tolist()}, max|diff| {s_err:.3e} "
        f"({s_err / s_norm:.2e} x its norm; rtol 1e-3); K2/K3 launches on rank 0 "
        f"{got['launches'].tolist()}, one rank "
        f"{[counts['fused_bluenoise'], counts['fused_bluenoise_grad']]}; all-reduce of the "
        f"gradient over gloo {float(got['allreduce_ms']):.2f} ms (median of 3, host clock)")
    log(f"parallel (b): against the same two 32-row blocks stepped in turn in this process: "
        f"UNet grads max|diff| {err_split:.3e} ({err_split / norm:.2e} x norm), (tau, s, e) "
        f"{ss.tolist()}, max|diff| {s_err_split:.3e} ({s_err_split / s_norm:.2e} x its norm; "
        f"both bound 1e-5 x norm); one 64-row pass against the split, (tau, s, e) max|diff| x "
        f"norm by T: {by_T}")
    check(counts["fused_bluenoise"] == 1 and counts["fused_bluenoise_grad"] == 1,
          "the one-rank step must launch K2 and K3 once")
    check(err_split <= 1e-5 * norm and s_err_split <= 1e-5 * float(np.linalg.norm(ss)),
          "the two ranks' summed gradients are not their blocks' summed in one process")
    check(got["launches"].tolist() == [1, 1], "each rank's step must launch K2 and K3 once")
    check(err <= 1e-5 * norm, "the two ranks' summed UNet gradient is not the one-rank step's")
    # (tau, s, e) against one 64-row pass: the split's fp32 rounding, which
    # by_T shows growing with T (the loss weight dgamma/dalpha); held to the
    # JAX multi-process test's bound (tests/mp_gradparity_worker.py)
    check(np.allclose(got["sched"], s1, rtol=1e-3, atol=1e-5),
          "the two ranks' (tau, s, e) gradient is not one rank's (rtol 1e-3)")
    check(abs(loss2 - loss1) <= 1e-5 * abs(loss1), "the two ranks' loss is not one rank's")
    out.update(gloo2_allreduce_ms=float(got["allreduce_ms"]), grad_err=err, grad_norm=norm,
               sched_err=s_err, sched_err_split=s_err_split, whole_vs_split_by_T=by_T)
    return out


def phase_dryrun(torch):
    """16. The port's dry run on 2 ranks sharing the card (gloo): the seven
    legs."""
    from bndm_tpu_torch.dryrun import dryrun_multichip

    t0 = time.time()
    text = dryrun_multichip(2, device="cuda", timeout=300)
    legs = re.findall(r"^dryrun_multichip\(2\): (.+) OK", text, re.M)
    log(f"dryrun: {len(legs)} legs in {time.time() - t0:.1f}s")
    check(len(legs) == 7, f"the dry run must pass seven legs, passed {legs}")


FIGS_M = {3: 4, 1200: 2}  # K1's launches on the figure path, by M


def phase_figs(torch, work, bn_dir, L_blue, peak, flush):
    """17. The figure CLI at its default 100 realisations: the files, K1
    launched 4 times at M = 3 and twice at M = 1200, the written M = 1200
    spectra within TOL of the plain version's (on the CPU) on the same
    white noise; K1 at M = 3 and 1200 against its plain version, and timed
    against torch.matmul in alternating turns, L2 flushed."""
    import numpy as np

    from bndm_tpu_torch.cli import figs
    from bndm_tpu_torch.cli.common import load_L_for
    from bndm_tpu_torch.ops import cuda_bluenoise as cb

    out_dir = os.path.join(work, "figs")
    reset_launches()
    t0 = time.time()
    spectra = figs.main(["--output_dir", out_dir, "--bluenoise_dir", bn_dir,
                         "--device", "cuda"])
    seconds = time.time() - t0
    launches = read_launches()["tri_matmul"]
    by_m = dict(cb.tri_matmul.launches_by_m)  # counted where the wrapper launches
    log(f"figs: {seconds:.1f}s; K1 launches {launches}, by M {by_m}")
    check(by_m == FIGS_M and launches == sum(FIGS_M.values()),
          f"K1 must launch {FIGS_M} (by M) on the figure path, launched {by_m}")
    for f in ("gaussianBN_res64_0.png", "gaussianBN_res64_500.png", "gaussianBN_res64_999.png",
              "gaussianBN_res64_spectrum_0.png", "gaussianRN_res64_0.png", "inset.png",
              "gaussianBN_res128_repetitive_True_noise.png",
              "gaussianBN_res128_repetitive_False_noise.png",
              "gaussianBN_res128_repetitive_True_spectrum.png"):
        check(os.path.exists(os.path.join(out_dir, f)), f"figs wrote no {f}")
    rep, ind = spectra[True], spectra[False]
    check((rep < 1e-3).mean() > (ind < 1e-3).mean(),
          "the repetitive tiles' spectrum lacks its grid of harmonics")
    L_cpu = torch.from_numpy(load_L_for("gaussianBN", bn_dir))
    spec_err = 0.0
    for repetitive in (True, False):
        white = figs._white((100, 3, 128, 128), "cuda", 0, 3, int(repetitive)).cpu()
        avg, _ = figs.supp_spectrum(L_cpu, white, repetitive)  # the plain product
        plain = avg[0].numpy()
        spec_err = max(spec_err, float(np.abs(plain / plain.max() - spectra[repetitive]).max()))
    log(f"figs: the M = 1200 spectra against the plain version's on the same white noise: "
        f"max|diff| {spec_err:.3e} (normalized to 1; bound {TOL})")
    check(spec_err <= TOL, "the figure's spectrum disagrees with the plain version's")

    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(12)
    rows = []
    real = cb.tri_matmul
    for m in FIGS_M:
        W = torch.randn(n, m, generator=g).cuda()
        got, plain = real(L_blue, W), cb.tri_matmul_plain(L_blue, W)
        err = (got - plain).abs().max().item()
        e64 = (got.double() - L_blue.double() @ W.double()).abs().max().item()
        check(torch.allclose(got, plain, rtol=TOL, atol=TOL), f"K1 disagrees at M={m}")
        iters = 10 if m < 100 else 5
        turns = alternating({"library": lambda: torch.matmul(L_blue, W),
                             "kernel": lambda: real(L_blue, W)}, 5,
                            lambda fn: launch_times(torch, fn, iters, flush))
        plain_ms = time_ms(torch, lambda: cb.tri_matmul_plain(L_blue, W), 10, flush)
        design = "skinny" if m <= cb.SKINNY_MAX_M else "wide"
        row = shares({"m": m, "design": design, "ms": turns["kernel"],
                      "library_ms": turns["library"], "plain_ms": plain_ms,
                      "max_abs_err": err, "max_abs_err_fp64": e64,
                      "launches": by_m.get(m, 0)}, k1_bounds(n, m, peak),
                     "fp32" if design == "skinny" else "3xtf32")
        rows.append(row)
        log(f"figs K1 M={m}: max|err| vs plain {err:.3e}, vs fp64 {e64:.3e}; kernel "
            f"{row['ms']:.4f} ms ({design}), torch.matmul {row['library_ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{'fp32 FMAs' if design == 'skinny' else '3xTF32'}) (median of 5 alternating "
            "turns, L2 flushed)")
    return {"seconds": seconds, "rows": rows, "spectrum_err": spec_err, "launches": launches,
            "by_m": by_m}


def phase_parity(torch, work):
    """18. parity_check on a full-width res-64 two-head UNet from seeded
    weights, written as .safetensors (export_reference_unet) and as a
    model.ckpt (export_torch_ckpt): the probe statistics on the card within
    1e-3 of the CPU's, then the 250-step sample."""
    from bndm_tpu_torch.cli.parity_check import main, probe_stats
    from bndm_tpu_torch.models.convert import export_reference_unet, export_torch_ckpt
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res

    d = os.path.join(work, "parity")
    os.makedirs(d)
    torch.manual_seed(21)
    model = UNet2D(unet_config_for_res(64, 3, 6), device="cpu").eval()
    paths = (os.path.join(d, "model.safetensors"), os.path.join(d, "model.ckpt"))
    export_reference_unet(model, paths[0])
    export_torch_ckpt(model, paths[1])
    with torch.no_grad():
        probe = torch.linspace(-1, 1, 3 * 64 * 64).reshape(1, 3, 64, 64)
        cpu = probe_stats(model(probe, torch.tensor([0.5])))
    del model
    out = {}
    for path in paths:
        t0 = time.time()
        res = main(["--ckpt", path, "--device", "cuda",
                    "--output", os.path.join(d, os.path.basename(path) + ".png")])
        seconds = time.time() - t0
        err = max(abs(a - b) for a, b in zip(res["probe"], cpu))
        sample = res["sample"]
        log(f"parity_check {os.path.basename(path)}: probe on the card {res['probe']}, on the "
            f"CPU {cpu}, max|diff| {err:.3e} (bound 1e-3); 250-step sample "
            f"{tuple(sample.shape)} in {seconds:.1f}s with the load")
        check(err <= 1e-3, f"the probe on the card disagrees with the CPU's ({path})")
        check(tuple(sample.shape) == (1, 3, 64, 64) and bool(torch.isfinite(sample).all()),
              "parity_check's sample is not finite")
        check(os.path.exists(os.path.join(d, os.path.basename(path) + "_0.png")),
              "parity_check wrote no sample image")
        out[os.path.basename(path)] = {"probe_err": err, "seconds": seconds}
    return out


def phase_demo(torch, work):
    """19. The demo: the three full-width res-64 UNets from random init, 50
    steps each; the http server on an ephemeral port, GET the page and a
    frame, POST /api/generate; the static panel."""
    import json as _json
    import threading
    import urllib.request

    import numpy as np

    import bndm_tpu_torch.cli.demo as demo

    d = os.path.join(work, "demo")
    os.makedirs(d)
    opt = demo.parse_args(["--res=64", "--nb_steps=50", "--port=0", "--device=cuda",
                           f"--output={d}/panel.png"])
    with contextlib.chdir(d):
        loaded = demo.load_all(opt, torch.device("cuda"))
    params = {k: sum(p.numel() for p in m.parameters()) for k, m in loaded.items()}
    t0 = time.time()
    results = demo.generate_all(opt, loaded)
    seconds = time.time() - t0
    log(f"demo: parameters {params}; three 50-step samplers {seconds:.2f}s; frames "
        f"{ {k: v.shape for k, v in results.items()} }")
    check(params["BNDM"] == 113_676_678, "the BNDM model is not the full-width two-head UNet")
    check(all(np.isfinite(v).all() and v.shape[1:] == (3, 64, 64) for v in results.values()),
          "the demo's frames are not finite")
    demo.save_panel(results, opt.output)
    srv = demo.make_http_server(opt, results, loaded)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        page = opener.open(base + "/", timeout=60).read().decode()
        png = opener.open(base + "/frame/BNDM/0.png", timeout=60).read()
        t0 = time.time()
        ok = _json.loads(opener.open(urllib.request.Request(base + "/api/generate?seed=1",
                                                            method="POST"), timeout=300).read())
        post_s = time.time() - t0
        again = opener.open(base + "/frame/BNDM/999.png", timeout=60).read()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    log(f"demo http: page {len(page)} bytes, frame {len(png)} bytes, POST /api/generate "
        f"{ok} in {post_s:.2f}s")
    check(all(m in page for m in ("DDIM", "IADB", "BNDM")), "the demo page lacks a method")
    check(png[:8] == again[:8] == b"\x89PNG\r\n\x1a\n", "the demo served no PNG frame")
    check(ok == {"ok": True}, "POST /api/generate failed")
    check(os.path.exists(opt.output), "the demo wrote no panel")
    return {"seconds": seconds, "post_s": post_s}


def main(argv):
    if argv not in ([], ["--kernels"], ["--adaln"], ["--probes"], ["--tiers"], ["--pipelines"],
                    ["--train"], ["--parallel"], ["--surfaces"]):
        log(f"FAIL: unknown arguments {argv} (the options are --kernels, --adaln, --probes, "
            "--tiers, --pipelines, --train, --parallel and --surfaces)")
        return 2
    only = argv[0] if argv else None
    if not os.path.isdir(os.path.join(HERE, "bndm_tpu_torch")):
        log("FAIL: bndm_tpu_torch/ is not beside chip_smoke.py (run it from the repository)")
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("FAIL: CUDA is not available; this smoke run needs an NVIDIA GPU")
        return 1
    torch.backends.cudnn.allow_tf32 = False  # full fp32 convs and matmuls, as
    torch.backends.cuda.matmul.allow_tf32 = False  # the port's CLI sets them

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    peak_key, peak = peaks_for(kind)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), device {kind}, peaks of "
        f"{peak_key}: {peak[0] / 1e12:.2f} TB/s, {peak[1] / 1e12:.0f} TFLOP/s fp32, "
        f"{peak[2] / 1e12:.1f} TFLOP/s TF32")
    t_start = time.time()

    # 2. build
    from bndm_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f}s")
    if only == "--probes":  # phase 5 alone
        return finish(torch, kind, probe_kernels(phase_probes(torch, peak[0])), t_start)
    if only == "--adaln":  # phase 4b alone
        return finish(torch, kind, adaln_kernels(phase_adaln(torch)), t_start)

    with tempfile.TemporaryDirectory(prefix="bndm_chip_smoke_") as work, \
            contextlib.chdir(work):  # the CLI writes its run folders under the cwd
        from bndm_tpu_torch.cli.common import load_L_for

        bn_dir = os.path.join(work, "bluenoise")
        t0 = time.time()
        L_blue = torch.from_numpy(load_L_for("gaussianBN", bn_dir)).cuda()
        log(f"blue-noise L generated and cached in {time.time() - t0:.1f}s")
        if only == "--tiers":  # phase 9b alone: no kernel is timed
            phase_serving_tiers(torch, work, bn_dir)
            return finish(torch, kind, [], t_start)
        if only == "--train":  # phase 10 alone: no kernel is timed
            tr = phase_train(torch, work, bn_dir)
            log(f"train: {tr['images_per_s']:.2f} images/s over steps 2-8, steady "
                f"{tr['steady_images_per_s']:.2f}")
            return finish(torch, kind, [], t_start)
        if only == "--pipelines":  # phases 12-14 alone: no kernel is timed
            phase_ddim(torch, work)
            phase_latent(torch, work, bn_dir)
            phase_latent512(torch, work, bn_dir)
            return finish(torch, kind, [], t_start)
        if only == "--parallel":  # phases 15-16 alone
            phase_parallel(torch, work, bn_dir)
            phase_dryrun(torch)
            return finish(torch, kind, [], t_start)
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
        if only == "--surfaces":  # phases 17-19 alone
            phase_figs(torch, work, bn_dir, L_blue, peak, flush)
            phase_parity(torch, work)
            phase_demo(torch, work)
            return finish(torch, kind, [], t_start)

        # 3-4. K1, K2 and K3
        k1 = phase_k1(torch, L_blue, peak, flush)
        k2 = phase_k2(torch, L_blue, peak, flush)
        if only == "--kernels":  # phases 3-4 alone: no path driven, no launches counted
            return finish(torch, kind, k_kernels(k1, k2, None), t_start)
        # 4b. the fused adaLN units and the DiT path
        ad = phase_adaln(torch)
        torch.cuda.empty_cache()
        # 5. the streaming probes and their bench entry points
        probes = phase_probes(torch, peak[0])
        torch.cuda.empty_cache()
        # 6-7. noise engine and UNet, CUDA vs CPU
        phase_noise(torch, L_blue)
        phase_unet(torch)
        # 8-9. the served paths
        sr = phase_superres(torch, work, bn_dir)
        log(f"super-res: samples/s per request (sampler only, synchronised) "
            f"{sr['samples_per_s']}")
        un = phase_uncond(torch, work, bn_dir)
        log(f"unconditional: samples/s per batch (sampler only, synchronised) "
            f"{un['samples_per_s']}")
        torch.cuda.empty_cache()
        # 9b. the serving tiers
        t0 = time.time()
        tiers = phase_serving_tiers(torch, work, bn_dir)
        log(f"serving tiers: {time.time() - t0:.1f}s; samples/s (sampler only, synchronised): "
            f"bf16 plain {un['samples_per_s'][-1]:.2f} (phase 9's second batch of 16), "
            + ", ".join(f"{k} {v['samples_per_s']}" for k, v in tiers.items()
                        if isinstance(v, dict) and "samples_per_s" in v))
        torch.cuda.empty_cache()
        # 10. the training path
        tr = phase_train(torch, work, bn_dir)
        torch.cuda.empty_cache()
        # 11. where a served step's time goes
        phase_trace(torch)
        torch.cuda.empty_cache()
        # 12-14. the HF-style pipelines: DDIM, latent res-256, latent res-512
        t0 = time.time()
        dd = phase_ddim(torch, work)
        torch.cuda.empty_cache()
        la = phase_latent(torch, work, bn_dir)
        torch.cuda.empty_cache()
        la512 = phase_latent512(torch, work, bn_dir)
        log(f"pipelines: {time.time() - t0:.1f}s; DDIM train {dd['train']['images_per_s']:.2f} "
            f"images/s (steady {dd['train']['steady_images_per_s']:.2f}), plain {dd['plain']} samples/s, int8 + cached(i=8) "
            f"{dd['tier']['samples_per_s']:.2f}; latent res-256 train "
            f"{la['train']['images_per_s']:.2f} images/s, test "
            f"{la['test']['with_decode_samples_per_s']:.2f} samples/s with the decode; latent "
            f"res-512 train {la512['images_per_s']:.2f} images/s (batch 64)")
        torch.cuda.empty_cache()
        # 15-16. data parallelism: one NCCL rank, two gloo ranks, the dry run
        t0 = time.time()
        par = phase_parallel(torch, work, bn_dir)
        torch.cuda.empty_cache()
        phase_dryrun(torch)
        log(f"parallel: {time.time() - t0:.1f}s; all-reduce of a step's gradient: one NCCL "
            f"rank {par['nccl1_allreduce_ms']:.4f} ms, two gloo ranks on the card "
            f"{par['gloo2_allreduce_ms']:.2f} ms")
        # 17-19. the remaining surfaces: figs (K1 at M = 3 and 1200), parity_check, demo
        t0 = time.time()
        fg = phase_figs(torch, work, bn_dir, L_blue, peak, flush)
        torch.cuda.empty_cache()
        phase_parity(torch, work)
        phase_demo(torch, work)
        log(f"surfaces: {time.time() - t0:.1f}s")
        del flush

    kernels = k_kernels(k1, k2, (sr["launches"], tr["launches"], tr["k3_launches"]))
    kernels[0]["launches_serving_tiers"] = tiers["superres int8+cached(i=8)"]["k1"]
    kernels[0]["launches_latent256_train"] = la["train"]["launches"]
    kernels[0]["latent256_train_shape"] = next(r for r in k1[0] if r["m"] == 1024)
    kernels[1]["launches_latent512_train"] = la512["launches"]
    kernels[0]["launches_figs"] = {f"M={m}": n for m, n in sorted(fg["by_m"].items())}
    kernels[0]["launches_figs_total"] = fg["launches"]
    kernels[0]["figs"] = fg["rows"]
    kernels[0]["figs_spectrum_max_abs_err"] = fg["spectrum_err"]
    kernels += adaln_kernels(ad) + probe_kernels(probes)
    log(f"train: {tr['images_per_s']:.2f} images/s over steps 2-8, steady "
        f"{tr['steady_images_per_s']:.2f}, first step {tr['first_step_s']:.3f} s (batch 64)")
    return finish(torch, kind, kernels, t_start)


def k_kernels(k1, k2, launches):
    """The kernels line's rows of K1-K3 from phases 3 and 4; ``launches``
    (K1 in super-res serving, K2 and K3 in training) or None where no path
    was driven."""
    rows, k1_sweep, k1_extra, err_plain, err_fp64 = k1
    k2_rows, k2_err, k3_err, k3_rows, k2_extra = k2
    k1_n, k2_n, k3_n = launches or (None, None, None)
    main_row = next(r for r in rows if r["m"] == 12)  # the super-res request's shape
    k2_row = next(r for r in k2_rows if r["m"] == 192)  # the train step's shape
    return [{
        "name": "tri_matmul",
        "route": "cuda",
        "source": "bndm_tpu_torch/csrc/tri_matmul.cu",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:74",
        "launches": k1_n,
        "max_abs_err": err_plain,
        "max_abs_err_fp64": err_fp64,
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": "torch.matmul(L, W)",
        "shape": "L (4096, 4096) @ W (4096, 12)",
        "design": main_row["design"],
        **k1_extra,
        "stream_floor": "torch.sum over the triangle's 33.6 MB, contiguous",
        "by_m": rows,
        "sweep": k1_sweep,
    }, {
        "name": "fused_bluenoise",
        "route": "cuda",
        "source": "bndm_tpu_torch/csrc/fused_bluenoise.cu",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:205",
        "launches": k2_n,
        "max_abs_err": max(k2_err["wn"], k2_err["bn_plain"]),
        "max_abs_err_wn": k2_err["wn"],
        "max_abs_err_fp64": k2_err["bn_fp64"],
        "ms": k2_row["ms"],
        "kernel_ms": k2_row["ms"],
        "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"],
        "bound_by": k2_row["bound_by"],
        "library_ms": None,  # no single PyTorch call draws, correlates and mixes
        "unfused_torch_ms": k2_row["unfused_torch_ms"],
        "unfused_torch": "torch.randn + torch.matmul + the mix, three calls",
        "shape": "L (4096, 4096), gamma (192,) -> noise, bn, wn (4096, 192)",
        **k2_extra,
        "by_m": k2_rows,
    }, {
        "name": "fused_bluenoise_grad",
        "route": "cuda",
        "source": "bndm_tpu_torch/ops/cuda_bluenoise.py",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:244",
        "note": "FusedBlueNoise.backward: torch ops on the card, no kernel of its own (the "
                "JAX JVP is jnp); its plain version is itself, timed twice",
        "launches": k3_n,
        "max_abs_err": k3_err["grad_max_abs_err"],
        "tangent_max_abs_err": k3_err["tangent_max_abs_err"],
        "ms": k3_rows[0]["ms"],
        "plain_ms": k3_rows[0]["plain_ms"],
        "bound_ms": k3_rows[0]["bound_ms"],
        "bound_by": k3_rows[0]["bound_by"],
        "library_ms": None,  # no single PyTorch call: a multiply and a column sum
        "shape": "grad, wn, bn (4096, 192) -> (192,)",
        "by_m": k3_rows,
    }]


def probe_kernels(probes):
    """The kernels line's rows of P1-P3 (the default variant's times)."""
    out = []
    for p, name, route, source, replaces in (
            ("P1", "stream_add_one", "triton", "bndm_tpu_torch/ops/stream_probes.py",
             "scripts/bench_pallas_stream.py:35"),
            ("P2", "dma_add_one", "cuda", "bndm_tpu_torch/csrc/stream_dma.cu",
             "scripts/bench_pallas_stream.py:55"),
            ("P3", "nhwc_add_one", "triton", "bndm_tpu_torch/ops/stream_probes.py",
             "scripts/bench_elementwise_tpu.py:69")):
        r = probes[p]
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "variant": r["variant"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": "bytes",
                    "library_ms": r["library_ms"], "library": "torch.add(y, 1)",
                    "gb_s": r["gb_s"], "shape": r["shape"], "by_variant": r["by_variant"]})
    return out


def finish(torch, kind, kernels, t_start):
    log(f"wall {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # every phase failure ends the run non-zero, no result line
        traceback.print_exc()
        print("FAIL: a phase failed (traceback above)", flush=True)
        code = 1
    sys.exit(code)
