#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bndm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --kernels   # phases 1-4 alone (K1-K3 timed)
    python3 chip_smoke.py --adaln     # phases 1, 2 and 4b alone (the fused adaLN units)
    python3 chip_smoke.py --probes    # phases 1, 2 and 5 alone (the probes)
    python3 chip_smoke.py --tiers     # phases 1, 2 and 9b alone (the serving tiers)
    python3 chip_smoke.py --pipelines # phases 1, 2 and 12-14 alone (DDIM, latent)
    python3 chip_smoke.py --train     # phases 1, 2 and 10 alone (pixel training)
    python3 chip_smoke.py --parallel  # phases 1, 2, 15 and 16 alone (data parallelism)
    python3 chip_smoke.py --surfaces  # phases 1, 2 and 17-19 alone (figs, parity, demo)

Two jobs, neither done elsewhere: the timings behind PERF.md §6's kernel
table (each hand kernel against its library or plain call, with bounds from
perfbench/yardstick.py), and full-width runs of the CLIs and surfaces on the
card with random seeded weights. Each timed kernel is first held to its plain
version on the inputs it is timed on; the kernels' other checks on the card
are tests/test_torch_port_gpu.py's; end-to-end rates are the benchmark's
(perfbench/run.py), never this script's.

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under bndm_tpu_torch/csrc, one nvcc each, at once;
  3. K1 (tri_matmul) on the generated blue-noise L: both designs timed at
     each M of the sweep 1-1500 (the crossover); then at M = 3 and 1200
     (the figure CLI), 12 (a super-res request), 48, 96, 768, 1024 (the
     latent res-256 train step) and 1500, K1 within TOL of its plain
     version and timed against torch.matmul in alternating turns, beside
     the plain version's time and its bounds: 3xTF32 on the tensor cores,
     fp32 FMAs, bytes;
  4. K2 (fused_bluenoise_flat) at M = 192 and 1500: held to its plain
     version (wn to 1e-5, bn within TOL, the mix exact), then timed against
     the unfused torch sequence in alternating turns, beside the plain
     version's time and the bounds; K3's backward (torch ops) beside its
     bound;
 4b. the fused adaLN units (ops/adaln.py) at the DiT-XL/2 train cell's
     shape (128, 256, 1152), with and without the residual input: forward
     and backward held to the plain twins (one ulp plus 1e-5 of the summed
     magnitudes, the card test's tolerance), then timed against the plain
     twin and the unfused model sequence in alternating turns
     (bench_adaln's timer), beside perfbench/adaln.py's byte bound; then
     DiT-XL/2's forward and backward at batch 16: 57 launches of each pass
     a step;
  5. the streaming probes P1-P3 (y + 1 in bf16): each default variant bit
     for bit add_one_plain at its full shape; each probe's variants and
     torch.add timed in alternating turns, the named default variant
     (P1_DEFAULT, P2_DEFAULT, P3_DEFAULT) beside the plain version and the
     bound; then both bench entry points (bndm_tpu_torch.scripts.
     bench_stream and bench_elementwise) at their full shapes, counted;
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
     CPU's; the cat_res64 CLI with --attn_softmax_dtype=bfloat16
     --cache_interval 8, then with --conv_int8 (plain, --gn_carry,
     --microbatch 8), and the super-res CLI with --conv_int8
     --cache_interval 8 (K1 once per request); the validated ladder at
     probe batch 4;
 10. training: the CLI with the flags of
     scripts/training/iadb_bn_cat_res64.sh (gaussianBN, two-head 113.7M
     UNet, batch 64) for 8 steps on 512 procedural images, then a resumed
     ninth step; K2 and K3 must run once per CLI step and K1 not at all,
     and the loader must decode through the native C++ transform;
 12. the DDIM baseline (phase_ddim), the flags of
     scripts/sampling/cat_res64_test.sh:7 (res 64, the 113.7M 3->3 UNet,
     1000 train T, 250 leading steps, clip_sample): the CLI trains 8 steps
     at batch 64 with --use_ema on 512 procedural images and one resumed
     step, samples 2 batches of 16 with frames, then --conv_int8
     --cache_interval 8; one fp32 DDIM step on the card against the CPU;
     no hand kernel on the path;
 13. the latent pipeline at res 256 (phase_latent), the flags of
     scripts/training/latent_iadb_celeba_res256.sh:3 (latent32 UNet, out
     4 x 2 two-head, batch 256) with the SD-VAE config at random init: the
     cache from 128 procedural images, 10 train steps, K1 once per step at
     M = 1024; one batch of 16 sampled and decoded with --decode_microbatch
     16; the fp32 VAE decode on the card against the CPU;
 14. the latent pipeline at res 512, reduced (phase_latent512,
     scripts/training/latent_iadb_cat_res512.sh:6 at batch 64, not 256): 6
     train steps on 32 procedural images, K2 once per step;
 15. data parallelism at full width (phase_parallel): (a) the training CLI
     (phase 10's flags, batch 64, 3 steps) as one NCCL rank through
     --coordinator_address/--num_processes/--process_id, its losses and
     weights the run without a process group's bit for bit; (b) two gloo
     ranks sharing the card (NCCL refuses two ranks on one device), 32 rows
     each, one fp32 step: the summed UNet gradient within 1e-5 x its norm of
     one rank's step on the same batch, t and noise, (tau, s, e) within rtol
     1e-3, K2 and K3 once on each rank;
 16. the port's dry run (bndm_tpu_torch/dryrun.py) on 2 gloo ranks on the
     card: the seven legs;
 17. the figure CLI at 100 realisations: its files, K1 four times at M = 3
     and twice at M = 1200, the written spectra within TOL of the plain
     version's on the same white noise;
 18. parity_check on a full-width res-64 UNet from seeded weights written
     as .safetensors and as model.ckpt: the probe on the card within 1e-3
     of the CPU's, then the 250-step sample;
 19. the demo: the three full-width res-64 UNets from random init, 50
     steps; its http server on an ephemeral port (GET the page and a frame,
     POST /api/generate) and the static panel;
 20. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after; launches made to time a kernel do not count.

Any failed phase ends the run with exit code 1 and no result line. It needs
CUDA and the rest of the repository beside it; it works in a temporary
directory and writes nothing into the repository except the kernels' build
(bndm_tpu_torch/_build/, ignored by git).
"""

from __future__ import annotations

import contextlib
import gc
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

TOL = 2e-5  # rtol = atol: the bound tests/test_noise.py holds the JAX engine to
# fp32 FMAs on the CUDA cores, where K1's skinny design and K3 run: the H100
# SXM data sheet's dense rate (perfbench/yardstick.py takes none of fp32's)
PEAK_FP32_FLOP_S = 67e12


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


def kernel_bounds(nbytes, flops):
    """(least ms, what bounds it) of a triangular product that moves
    ``nbytes`` once and runs ``flops``, by route: in 3xTF32 (three TF32
    products each) on the tensor cores, in fp32 FMAs on the CUDA cores, and
    its bytes alone."""
    from perfbench.yardstick import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S, roofline

    out = {"3xtf32": roofline(nbytes, 3 * flops, PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S),
           "fp32": roofline(nbytes, flops, PEAK_HBM_BYTES_S, PEAK_FP32_FLOP_S),
           "bytes": (nbytes / PEAK_HBM_BYTES_S, "bytes")}
    return {route: (s * 1e3, by) for route, (s, by) in out.items()}


def shares(row, bounds, route):
    """Add to ``row`` the bound of ``route`` (the arithmetic the kernel
    runs), and the columns PERF.md §6 prints: every bound given, and the
    kernel's share of each arithmetic's."""
    row["bound_ms"], row["bound_by"] = bounds[route]
    row["share"] = row["bound_ms"] / row["ms"]
    for k, (ms, _) in bounds.items():
        row[f"bound_{k}_ms"] = ms
        if k != "bytes":
            row[f"share_{k}"] = ms / row["ms"]
    return row


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
def watched_samplers(record, module=None,
                     names=("sample_iadb", "sample_iadb_cached", "sample_iadb_microbatched")):
    """Record (sampler name, shape, finiteness) of every call of the
    samplers ``names`` of ``module`` (the IADB samplers by default) the CLI
    may route to, calibration's plain trajectories included (restores them
    on exit)."""
    import torch

    from bndm_tpu_torch.samplers import iadb

    module = module or iadb
    real = {n: getattr(module, n) for n in names}

    def watch(name):
        def watched(*args, **kwargs):
            out = real[name](*args, **kwargs)
            x = out[0] if isinstance(out, tuple) else out
            record.append((name, tuple(x.shape), bool(torch.isfinite(x).all())))
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
def watched_steps(record, module, factory):
    """Record the model's parameter count at every step of the train step
    that ``module.factory`` (``make_ddim_train_step``,
    ``make_latent_train_step``) builds while this is open."""
    real = getattr(module, factory)

    def make(*args, **kwargs):
        step, init = real(*args, **kwargs)

        def watched(state, batch, key):
            record.append(sum(p.numel() for p in state.model.parameters()))
            return step(state, batch, key)
        return watched, init

    setattr(module, factory, make)
    try:
        yield
    finally:
        setattr(module, factory, real)


@contextlib.contextmanager
def watched_trainer(record):
    """Record the model's parameter count at every train step the pixel
    CLI takes."""
    from bndm_tpu_torch.train import pixel

    real = pixel.PixelTrainer.step

    def watched(self, batch01, key):
        record.append(sum(p.numel() for p in self.model.parameters()))
        return real(self, batch01, key)

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
# 3 and 1200: the figure CLI; 1500: a res-64 gallery batch of 500
K1_TIMED = (3, 12, 48, 96, 768, 1024, 1200, 1500)


def phase_k1(torch, L_blue, flush):
    """Phase 3, on the blue-noise L: each design's time at each M of the
    sweep (the crossover), then, at the main path's shapes, K1 held to its
    plain version within TOL and timed against torch.matmul in alternating
    turns, beside the plain version's time and its bounds."""
    from bndm_tpu_torch.ops.cuda_bluenoise import (SKINNY_LIMIT_M, SKINNY_MAX_M, _launch,
                                                   tri_matmul, tri_matmul_plain)
    from perfbench.yardstick import k1_bytes, tri_product_flops

    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(0)
    sweep = []
    for m in K1_SWEEP:
        W = torch.randn(n, m, generator=g).cuda()
        row = {"m": m, "design": "skinny" if m <= SKINNY_MAX_M else "wide"}
        for design in ("skinny", "wide"):
            if design == "wide" or m <= SKINNY_LIMIT_M:
                row[f"{design}_ms"] = time_ms(torch, lambda: _launch(L_blue, W, design), 20,
                                              flush)
        row["matmul_ms"] = time_ms(torch, lambda: torch.matmul(L_blue, W), 20, flush)
        sweep.append(row)
        log(f"K1 M={m} designs (median, L2 flushed): skinny "
            f"{row.get('skinny_ms', float('nan')):.4f} ms, wide {row['wide_ms']:.4f} "
            f"ms, torch.matmul {row['matmul_ms']:.4f} ms; takes {row['design']}")

    rows = []
    for m in K1_TIMED:
        W = torch.randn(n, m, generator=g).cuda()
        check(torch.allclose(tri_matmul(L_blue, W), tri_matmul_plain(L_blue, W), rtol=TOL,
                             atol=TOL), f"K1 disagrees with its plain version at M={m}")
        iters = 10 if m < 100 else 5
        turns = alternating({"library": lambda: torch.matmul(L_blue, W),
                             "kernel": lambda: tri_matmul(L_blue, W)}, 5,
                            lambda fn: launch_times(torch, fn, iters, flush))
        plain_ms = time_ms(torch, lambda: tri_matmul_plain(L_blue, W), 10, flush)
        design = "skinny" if m <= SKINNY_MAX_M else "wide"
        row = shares({"m": m, "design": design, "ms": turns["kernel"],
                      "library_ms": turns["library"], "plain_ms": plain_ms},
                     kernel_bounds(k1_bytes(n, m), tri_product_flops(n, m)),
                     "fp32" if design == "skinny" else "3xtf32")
        rows.append(row)
        log(f"K1 M={m} times (median of 5 alternating turns, L2 flushed): kernel "
            f"{row['ms']:.4f} ms ({design}), torch.matmul {row['library_ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms; bounds: 3xTF32 {row['bound_3xtf32_ms']:.4f} ms "
            f"({100 * row['share_3xtf32']:.1f} %), fp32 FMAs {row['bound_fp32_ms']:.4f} ms "
            f"({100 * row['share_fp32']:.1f} %), bytes {row['bound_bytes_ms']:.4f} ms; takes "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['share']:.1f} %)")
    return rows, sweep


K2_TIMED = (192, 1500)  # the res-64 train step (batch 64 x 3 channels); a batch of 500


def phase_k2(torch, L_blue, flush):
    """Phase 4: at M = 192 and 1500, K2 held to its plain version (wn to
    1e-5, bn within TOL, the mix exact) and timed against the unfused torch
    sequence in alternating turns, beside the plain version's time and its
    bounds; then K3's backward beside its bound."""
    from bndm_tpu_torch.ops.cuda_bluenoise import fused_bluenoise_flat, fused_bluenoise_flat_plain
    from perfbench.yardstick import PEAK_HBM_BYTES_S, k2_bytes, roofline, tri_product_flops

    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(10)
    rows = []
    for m in K2_TIMED:
        gamma = torch.rand(m, generator=g).cuda()
        noise, bn, wn = fused_bluenoise_flat(L_blue, gamma, (3, 4))
        _, p_bn, p_wn = fused_bluenoise_flat_plain(L_blue, gamma, (3, 4))
        check(torch.allclose(wn, p_wn, rtol=1e-5, atol=1e-5)
              and torch.allclose(bn, p_bn, rtol=TOL, atol=TOL)
              and torch.equal(noise, bn * (1.0 - gamma[None, :]) + wn * gamma[None, :]),
              f"K2 disagrees with its plain version at M={m}")
        del noise, bn, wn, p_bn, p_wn
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
                      "unfused_torch_ms": turns["unfused"]},
                     {k: v for k, v in kernel_bounds(k2_bytes(n, m), tri_product_flops(n, m))
                      .items() if k != "bytes"}, "3xtf32")
        rows.append(row)
        log(f"K2 M={m} times (median of 5 alternating turns, L2 flushed): kernel "
            f"{row['ms']:.4f} ms, unfused torch.randn + torch.matmul + mix "
            f"{row['unfused_torch_ms']:.4f} ms ({row['unfused_torch_ms'] / row['ms']:.2f}x the "
            f"kernel's time), plain {plain_ms:.4f} ms; bounds: 3xTF32 "
            f"{row['bound_3xtf32_ms']:.4f} ms ({row['bound_by']}, "
            f"{100 * row['share_3xtf32']:.1f} %), fp32 FMAs {row['bound_fp32_ms']:.4f} ms "
            f"({100 * row['share_fp32']:.1f} %)")

    k3_rows = []
    for m in K2_TIMED:
        _, bn, wn = fused_bluenoise_flat(L_blue, torch.rand(m, generator=g).cuda(), (7, 8))
        grad = torch.randn(n, m, generator=g).cuda()

        def backward():  # FusedBlueNoise.backward: torch ops, its own plain version
            return (grad * (wn - bn)).sum(dim=0)

        ms = time_ms(torch, backward, 30, flush)
        # grad, wn and bn read once, the (M,) gradient written once; a
        # subtract, a multiply and an add an element
        bound_s, bound_by = roofline(4 * (3 * n * m + m), 3 * n * m, PEAK_HBM_BYTES_S,
                                     PEAK_FP32_FLOP_S)
        k3_rows.append({"m": m, "ms": ms, "plain_ms": None,  # the torch ops are its plain form
                        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                        "share": bound_s * 1e3 / ms})
        log(f"K3 M={m} backward time (median, L2 flushed): {ms:.4f} ms, bound "
            f"{bound_s * 1e3:.4f} ms ({bound_by})")
    return rows, k3_rows


def _adaln_twin_check(torch, t, residual, eps):
    """One fused unit's forward and backward on ``t`` against the plain
    twins (the backward twin on the kernels' own forward outputs): each
    output within one ulp of its dtype plus 1e-5 of the summed magnitudes
    that made it, the card test's tolerance; the row statistics to 1e-5."""
    from bndm_tpu_torch.ops import adaln as A

    y, gate = (t["y"], t["gate"]) if residual else (None, None)
    xs, z, mean, rstd = A.adaln_forward(t["x"], t["shift"], t["scale"], eps, y, gate)
    got = A.adaln_backward(t["dz"], t["dxs"], xs, mean, rstd, t["scale"], y, gate)
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
            "dx": (got[0], wantb[0], terms_dx),
            "dshift": (got[1], wantb[1], dz.abs().sum(1, keepdim=True)),
            "dscale": (got[2], wantb[2], (dz * xhat).abs().sum(1, keepdim=True))}
    if residual:
        outs["dy"] = (got[3], wantb[3], t["gate"].float().abs() * terms_dx)
        outs["dgate"] = (got[4], wantb[4], (terms_dx * t["y"].float().abs()).sum(1, keepdim=True))
    for name, (a, b, terms) in outs.items():
        mant = 7 if b.dtype == torch.bfloat16 else 23
        ulp = torch.exp2(torch.floor(torch.log2(b.float().abs().clamp_min(2.0 ** -126))) - mant)
        excess = float(((a.float() - b.float()).abs() - ulp - 1e-5 * terms).max())
        check(excess <= 0, f"adaln: {name} is {excess:.3g} outside the plain twin's tolerance "
                           f"({'with' if residual else 'without'} the residual input)")


DIT_BATCH = 16


def phase_adaln(torch):
    """Phase 4b: the fused adaLN units (ops/adaln.py) at the DiT-XL/2 train
    cell's shape, with and without the residual input, held to the plain
    twins and timed against them and the unfused model sequence in
    alternating turns (bench_adaln's timer), beside perfbench/adaln.py's
    byte bound; then the DiT path: DiT-XL/2 (the cell's bf16 model) forward
    and backward at batch DIT_BATCH, its launches counted."""
    from bndm_tpu_torch.models import dit as D
    from bndm_tpu_torch.scripts import bench_adaln as BA
    from perfbench import adaln as PA
    from perfbench.yardstick import PEAK_HBM_BYTES_S

    t = BA.inputs()  # (128, 256, 1152): bf16 branch and modulation, float32 stream
    elems = t["x"].numel()
    rows = {}
    for kind, residual, nbytes in (("interior", True, PA.INTERIOR), ("first", False, PA.FIRST)):
        _adaln_twin_check(torch, t, residual, BA.EPS)
        ts = alternating({"fused": lambda: BA.fused(t, residual),
                          "plain": lambda: BA.plain(t, residual),
                          "unfused": lambda: BA.unfused(t, residual)}, 5,
                         lambda fn: [BA.loop_ms(fn)])
        k = ts["fused"]
        bound_ms = nbytes * elems / PEAK_HBM_BYTES_S * 1e3
        rows[kind] = {"ms": k, "plain_ms": ts["plain"], "unfused_torch_ms": ts["unfused"],
                      "bound_ms": bound_ms, "bound_by": "bytes", "share": bound_ms / k}
        log(f"adaln {kind}: within the plain twin's tolerance; fused {k:.3f} ms, plain twin "
            f"{ts['plain']:.3f} ms, unfused model sequence {ts['unfused']:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / k:.1f} %)")
    del t
    torch.cuda.empty_cache()

    cfg = D.dit_config("DiT-XL/2", input_size=32, in_channels=4, learn_sigma=True,
                       dtype="bfloat16")
    torch.manual_seed(0)
    model = D.DiT(cfg, device="cuda")
    x = torch.randn(DIT_BATCH, 4, 32, 32, device="cuda")
    tt = torch.rand(DIT_BATCH, device="cuda")
    units = 2 * cfg.depth + 1
    steps = 2
    reset_launches()
    for _ in range(steps):
        out = model(x, tt).float()
        torch.autograd.grad(out.square().mean(), list(model.parameters()))
    torch.cuda.synchronize()
    counts = read_launches()
    log(f"adaln: DiT-XL/2 path, {steps} forward and backward passes at batch {DIT_BATCH}: "
        f"launches {counts}")
    check(counts["adaln_forward"] == counts["adaln_backward"] == steps * units,
          f"adaln: the DiT path must launch each fused pass {units} times a step")
    check(sum(counts.values()) == 2 * steps * units, "adaln: another kernel ran on the DiT path")
    del model
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": counts["adaln_forward"] // steps,
            "launches_backward": counts["adaln_backward"] // steps}


def adaln_kernels(ad):
    """The kernels line's row of the fused adaLN units (phase 4b)."""
    r = ad["rows"]["interior"]
    return [{
        "name": "adaln",
        "route": "triton",
        "source": "bndm_tpu_torch/ops/adaln.py",
        "replaces": None,  # no TPU kernel: the JAX package leaves the sub-layer to XLA
        "shape": "(128, 256, 1152), bf16 over a float32 stream, forward and backward",
        "launches": ad["launches"],
        "launches_backward": ad["launches_backward"],
        **r,
        "library_ms": None,  # no single PyTorch call does the update, LayerNorm and modulation
        "first": ad["rows"]["first"],
    }]


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


def phase_probes(torch):
    """Phase 5: each probe's default variant bit for bit add_one_plain at
    its full shape; every variant's time (CUDA events over ``inner`` chained
    passes) and torch.add's in alternating turns, the default variant's
    beside the plain version's and the bytes bound; then the two bench
    entry points at their full shapes, the launch counts reset before."""
    from bndm_tpu_torch.ops.stream_probes import (P1_DEFAULT, P2_DEFAULT, P3_DEFAULT, P3_SWEEP,
                                                  add_one_plain, dma_add_one, nhwc_add_one,
                                                  stream_add_one)
    from bndm_tpu_torch.scripts import bench_elementwise, bench_stream
    from bndm_tpu_torch.utils.timing import pass_ms
    from perfbench.yardstick import PEAK_HBM_BYTES_S

    inner = 20
    variants = {"P1": [(p1_name((rpb, sched)), lambda y, r=rpb, s=sched: stream_add_one(y, r, s))
                       for rpb in bench_stream.ROWS_PER_BLOCK for sched in bench_stream.SCHEDULES],
                "P2": [(p2_name(v), lambda y, v=v: dma_add_one(y, *v))
                       for v in bench_stream.DMA_SWEEP],
                "P3": [(p3_name(v), lambda y, v=v: nhwc_add_one(y, *v)) for v in P3_SWEEP]}
    default = {"P1": p1_name(P1_DEFAULT), "P2": p2_name(P2_DEFAULT), "P3": p3_name(P3_DEFAULT)}
    full = {"P1": (256000, 1024), "P2": (256000, 1024), "P3": (500, 64, 64, 128)}
    rows = {}
    for p, vs in variants.items():
        x = torch.randn(full[p], device="cuda").to(torch.bfloat16)
        check(torch.equal(dict(vs)[default[p]](x), add_one_plain(x)),
              f"{p} ({default[p]}) is not bitwise add_one_plain at {full[p]}")
        moved = 2 * x.numel() * x.element_size()
        bound_ms = moved / PEAK_HBM_BYTES_S * 1e3
        plain_ms = pass_ms(add_one_plain, x, inner)
        # torch.add, then each variant, then back
        turns = alternating({"torch.add": lambda y: torch.add(y, 1), **dict(vs)}, PROBE_TURNS,
                            lambda fn: [pass_ms(fn, x, inner)])
        lib_ms = turns.pop("torch.add")
        by_variant = [{"variant": vname, "ms": ms} for vname, ms in turns.items()]
        main = next(r for r in by_variant if r["variant"] == default[p])
        for r in by_variant:
            log(f"{p} {r['variant']} at {full[p]}: {r['ms']:.4f} ms, "
                f"{100 * bound_ms / r['ms']:.1f} % of the bound, {r['ms'] / lib_ms:.3f}x "
                "torch.add")
        rows[p] = dict(main, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       share=bound_ms / main["ms"], shape=str(full[p]), by_variant=by_variant)
        log(f"{p} times ({inner} chained passes, CUDA events; medians of {PROBE_TURNS} "
            f"alternating turns, the default variant): {main['ms']:.4f} ms "
            f"({main['variant']}), plain {plain_ms:.4f} ms, torch.add {lib_ms:.4f} ms "
            f"({main['ms'] / lib_ms:.4f}x), bound {bound_ms:.4f} ms (bytes), "
            f"{100 * bound_ms / main['ms']:.1f} % of the bound")
        del x

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
        f"{counts['dma_add_one']}, P3 {counts['nhwc_add_one']}")
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
    with watched_samplers(record, names=("sample_iadb",)):
        text = run_cli(argv)
    counts = read_launches()
    launches = counts["tri_matmul"]
    log(f"super-res: K1 launches {launches} for {len(record)} requests, K2 launches "
        f"{counts['fused_bluenoise']}")
    check(len(record) == 4, f"expected 4 super-res requests, sampled {len(record)}")
    check(launches == len(record), "K1 must launch once per super-res request")
    check(counts["fused_bluenoise"] == 0, "K2 is not on the serving path")
    check(all(f and s == (1, 3, 128, 128) for _, s, f in record), f"bad samples: {record}")
    m = re.search(r"ssim: (\S+), psnr: (\S+), l2: (\S+), l1: (\S+)", text)
    check(m is not None and all(math.isfinite(float(v.rstrip(","))) for v in m.groups()),
          "super-res metrics missing or not finite")
    check(n_params == 116_323_846, "super-res UNet is not the published 116.3M config")
    return launches


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
    with watched_samplers(record, names=("sample_iadb",)):
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
    check(len(record) == 2 and all(f and s == (16, 3, 64, 64) for _, s, f in record),
          f"bad samples: {record}")
    m = re.search(r"gallery: (\d+) images written", text)
    check(m is not None and int(m.group(1)) == 32, "expected 32 images written")
    check(n_params == 113_676_678, "unconditional UNet is not the published 113.7M config")


CAT64 = ["--dataset=cat_res64", "--res=64", "--train_or_test=test", "--nb_steps=250",
         "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=1000",
         "--out_channel=6"]  # scripts/sampling/cat_res64_test.sh:5


def _tier_run(argv, want_batches, bs):
    """One CLI run through the serving tiers: every served batch finite and
    of batch ``bs``; returns the samplers served through, the K1 launches
    and what the CLI printed."""
    record = []
    reset_launches()
    with watched_samplers(record):
        text = run_cli(argv)
    k1 = read_launches()["tri_matmul"]
    # every tier run here is cached: the plain sampler runs only to calibrate
    served = [r for r in record if r[0] != "sample_iadb"]
    cal = [r for r in record if r[0] == "sample_iadb"]
    check(len(served) == want_batches and all(f and shape[0] == bs for _, shape, f in served),
          f"bad served samples: {served}")
    check(("serving calibration:" in text) == bool(cal), "calibration ran unannounced")
    return {"sampler": sorted({r[0] for r in served}), "k1": k1, "text": text}


def phase_serving_tiers(torch, work, bn_dir):
    """The serving tiers at full width (random seeded weights, 250 steps):

    (a) cache_interval=1 gives the plain chain's bits (cuDNN deterministic);
    (b) the shallow forward on the deep feature of the same (x, t) within
        1e-5 of the full forward at every depth, fp32, TF32 off;
    (c) the int8 product's int32 sums on the card equal the CPU's exactly
        at 128 ch x 64^2 (batch 16) and 512 ch x 4^2 (batch 1, 16 rows);
    (d) the cat_res64 CLI with --attn_softmax_dtype=bfloat16
        --cache_interval 8 on one batch of 16, then with --conv_int8, with
        --conv_int8 --gn_carry and with --conv_int8 --microbatch 8;
    (e) the church super-res CLI with --conv_int8 --cache_interval 8 on 2
        images: K1 once per request;
    (f) make_validated_serving_sampler at probe_batch 4: each tier's SSIM,
        PSNR and gate; the chosen tier passed or is the plain path.

    Returns K1's launches in (e).
    """
    import dataclasses

    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.ops.int8 import int8_conv_accum
    from bndm_tpu_torch.samplers.iadb import sample_iadb, sample_iadb_cached
    from bndm_tpu_torch.serving import build_model, make_validated_serving_sampler

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
    for c, hw, b in ((128, 64, 16), (512, 4, 1)):
        xq = torch.randint(-127, 128, (b, c, hw, hw), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (c, c, 3, 3), generator=g, dtype=torch.int8)
        got = int8_conv_accum(xq.cuda(), wq.cuda()).cpu()
        equal = torch.equal(got, int8_conv_accum(xq, wq))
        log(f"tiers (c): int8 site {b}x{c}x{hw}x{hw}: int32 sums CUDA vs CPU "
            f"{'equal' if equal else 'DIFFER'} (max |sum| {int(got.abs().max())})")
        check(equal, f"the int8 product's sums differ between the card and the CPU at "
                     f"{b}x{c}x{hw}x{hw}")

    # (d)
    argv = CAT64 + ["--batch_size=16", "--test_samples=16", "--save_all_samples",
                    "--device=cuda", f"--bluenoise_dir={bn_dir}", "--conv_int8",
                    "--attn_softmax_dtype=bfloat16", "--cache_interval=8"]
    run = os.path.join(work, "tiers_uncond")
    os.makedirs(run)
    with contextlib.chdir(run):
        write_ckpt(torch, unet_config_for_res(64, out_channels=6),
                   os.path.join(output_folder_name(parse_args(argv)), "model.ckpt"), seed=5)
        for name, flags in (("bf16sm+cached(i=8)", [a for a in argv if a != "--conv_int8"]),
                            ("int8+bf16sm+cached(i=8)", argv),
                            ("int8+gncarry+bf16sm+cached(i=8)", argv + ["--gn_carry"]),
                            ("int8+bf16sm+cached(i=8)+microbatch(8)", argv + ["--microbatch=8"])):
            r = _tier_run(flags, 1, 16)
            check(r["k1"] == 0, "K1 is not on the unconditional path")
            check(re.search(r"gallery: 16 images written", r["text"]) is not None,
                  "expected 16 images written")
            log(f"tiers (d): {name}: one batch of 16 through {r['sampler'][0]}")

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
    r = _tier_run(argv, 2, 1)
    k1 = r["k1"]
    m = re.search(r"ssim: (\S+), psnr: (\S+), l2: (\S+), l1: (\S+)", r["text"])
    check(m is not None and all(math.isfinite(float(v.rstrip(","))) for v in m.groups()),
          "super-res metrics missing or not finite")
    check(k1 == 2, f"K1 must launch once per super-res request, launched {k1}")
    log(f"tiers (e): super-res int8+cached(i=8): K1 launches {k1} for 2 requests")

    # (f)
    sample, report = make_validated_serving_sampler(
        unet_config_for_res(64, out_channels=6, dtype="bfloat16"), sd, 250, 64,
        device="cuda", probe_batch=4, **sched)
    chosen = report[-1]["chosen"]
    passed = {r["tier"] for r in report if r.get("gate") == "pass"}
    log(f"tiers (f): validated ladder: {report}")
    check(chosen in passed or chosen == "bf16 parity path", f"the ladder chose {chosen}")
    del sample
    return k1


# scripts/training/iadb_bn_cat_res64.sh:7 (gaussianBN, the two-head 113.7M UNet)
TRAIN64 = ["--dataset=cat_res64", "--res=64", "--epochs=1", "--train_or_test=train",
           "--lr=0.0001", "--grad_clip=1.0", "--noise_type=gaussianBN",
           "--scheduler_gamma=sigmoid", "--scheduler_param=1000", "--out_channel=6",
           "--device=cuda"]


def phase_train(torch, work, bn_dir):
    """The training CLI at full width: 8 steps at batch 64, then a resumed
    ninth step. Returns K2's and K3's launches in the 8 steps."""
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
        record = []
        reset_launches()
        native.reset_counts()
        with watched_trainer(record):
            text = run_cli(argv + [f"--max_steps={steps}"])
        counts = read_launches()
        decoded = dict(native.PATH_COUNTS)
        losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
        sched = np.loadtxt(os.path.join(run, "scheduler_params.txt"))
        log(f"train: {len(record)} steps of batch {bs}, {record[0] if record else 0} "
            f"parameters; K2 launches {counts['fused_bluenoise']}, K1 launches "
            f"{counts['tri_matmul']}; losses {losses.tolist()}; scheduler params "
            f"{sched.tolist()}")
        check(len(record) == steps and all(p == 113_676_678 for p in record),
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
        _check_files(run, ("model.npz", f"checkpoints/{steps}/state.pt", "losses.png",
                           "scheduler_params.png", "logs/metrics.jsonl"))

        # resume from the full-state checkpoint and take one more step
        resumed = []
        reset_launches()
        with watched_trainer(resumed):
            text = run_cli(argv + [f"--max_steps={steps + 1}", "--resume_training"])
        resumed_k2 = read_launches()["fused_bluenoise"]
        after = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
        log(f"train resume: K2 launches {resumed_k2}, losses {after.tolist()}")
        check(f"resumed full state at step {steps}" in text, "the resume did not restart at step 8")
        check(len(resumed) == 1 and resumed_k2 == 1 and after.shape == (1,)
              and bool(np.isfinite(after).all()), "the resumed run must take one finite step")
        check(os.path.exists(os.path.join(run, f"checkpoints/{steps + 1}/state.pt")),
              "the resumed run saved no checkpoint")
    return counts["fused_bluenoise"], counts["fused_bluenoise_grad"]


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


def phase_ddim(torch, work):
    """The DDIM baseline at full width (random seeded weights):

    (a) train: the CLI for 8 steps at batch 64 with --use_ema on 512
        procedural images, then one resumed step (--resume_from_checkpoint
        latest); no hand kernel on the path;
    (b) test: 2 batches of 16, plain, 250 steps, with frames; then
        --conv_int8 (static) --cache_interval 8 on the same weights, one
        batch of 16, calibrated first;
    (c) one fp32 DDIM step (UNet + scheduler, TF32 off) on the card against
        the CPU at 1e-3, and the same bits from a second call.
    """
    import numpy as np

    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res
    from bndm_tpu_torch.samplers import ddim as sddim
    from bndm_tpu_torch.train import ddim as tddim

    bs, steps = 64, 8
    data = os.path.join(work, "data_ddim")
    make_procedural_folder(os.path.join(data, "procedural_cat_res64"), n=bs * steps, res=64,
                           seed=11)
    argv = DDIM64 + [f"--data_root={data}"]
    train = argv + ["--train_or_test=train", f"--train_batch_size={bs}", "--num_epochs=1"]
    run = os.path.join(work, "results_gaussianBN", "ddim_cat_res64_ema")

    # (a)
    record = []
    reset_launches()
    with watched_steps(record, tddim, "make_ddim_train_step"):
        run_cli(train + [f"--max_steps={steps}"], "ddim")
    counts = read_launches()
    losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
    log(f"ddim train: {len(record)} steps of batch {bs}, {record[0] if record else 0} "
        f"parameters; launches {counts}; losses {losses.tolist()}")
    check(len(record) == steps and all(p == 113_673_219 for p in record),
          f"expected {steps} steps of the 113.7M 3->3 UNet, got {record}")
    check(not any(counts.values()), "no hand kernel is on the DDIM path")
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          "losses.txt must hold one finite loss per step")
    _check_files(run, ("unet/model.npz", "unet_ema/model.npz", "unet/config.json",
                       "unet/diffusion_pytorch_model.safetensors",
                       "scheduler/scheduler_config.json", "model_index.json",
                       f"checkpoints/{steps}/state.pt"))
    resumed = []
    with watched_steps(resumed, tddim, "make_ddim_train_step"):
        text = run_cli(train + [f"--max_steps={steps + 1}", "--resume_from_checkpoint=latest"],
                       "ddim")
    check(f"Resuming from checkpoint step {steps}" in text, "the resume did not restart at step 8")
    check(len(resumed) == 1, "the resumed run must take one step")
    _check_files(run, (f"checkpoints/{steps + 1}/state.pt",))

    # (b)
    test = argv + ["--train_or_test=test", "--eval_batch_size=16"]
    rec = []
    reset_launches()
    with watched_samplers(rec, sddim, ("sample_ddim", "sample_ddim_cached")):
        run_cli(test + ["--test_samples=32"], "ddim")
    check(not any(read_launches().values()), "no hand kernel is on the DDIM path")
    check(len(rec) == 2 and all(n == "sample_ddim" and f and s == (16, 3, 64, 64)
                                for n, s, f in rec), f"bad samples: {rec}")
    n_img = len(os.listdir(os.path.join(run, "images")))
    n_seq = len(os.listdir(os.path.join(run, "seqs")))
    check(n_img == 32 and n_seq == 22, f"expected 32 images and 22 frames, got {n_img}, {n_seq}")
    rec = []
    with watched_samplers(rec, sddim, ("sample_ddim", "sample_ddim_cached")):
        text = run_cli(test + ["--test_samples=16", "--conv_int8", "--cache_interval=8"], "ddim")
    served = [r for r in rec if r[0] == "sample_ddim_cached"]
    cal = [r for r in rec if r[0] == "sample_ddim"]
    check(len(served) == 1 and served[0][2] and served[0][1] == (16, 3, 64, 64)
          and len(cal) == 1 and "serving calibration:" in text, f"bad tier run: {rec}")
    log(f"ddim test: 32 images and {n_seq} frames plain; one batch of 16 int8-static + "
        "cached(i=8) after its calibration")

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


def _latent_train(argv, run, bs, steps, kernel, params):
    """The latent CLI's train mode for ``steps`` steps: the named hand
    kernel launched once a step, the other not at all. Returns its
    launches."""
    import numpy as np

    from bndm_tpu_torch.train import latent as tlatent

    record = []
    reset_launches()
    with watched_steps(record, tlatent, "make_latent_train_step"):
        text = run_cli(argv + ["--train_or_test=train", f"--train_batch_size={bs}",
                               f"--num_epochs={steps}", f"--max_steps={steps}"], "latent_iadb")
    counts = read_launches()
    losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
    log(f"latent train ({run.rsplit('/', 1)[-1]}): {len(record)} steps of batch {bs}, "
        f"{record[0] if record else 0} parameters; launches {counts}; losses "
        f"{losses.tolist()}")
    other = "fused_bluenoise" if kernel == "tri_matmul" else "tri_matmul"
    check(len(record) == steps and all(p == params for p in record),
          f"expected {steps} steps of the {params}-parameter UNet, got {record}")
    check(counts[kernel] == steps, f"{kernel} must launch once per latent train step")
    check(counts[other] == 0, f"{other} is not on this latent training path")
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          "losses.txt must hold one finite loss per step")
    check("latent cache built:" in text, "no latent cache was built")
    _check_files(run, ("unet/model.npz", "unet/config.json", "model_index.json",
                       f"checkpoints/{steps}/state.pt"))
    return counts[kernel]


def phase_latent(torch, work, bn_dir):
    """The latent pipeline at full width: the celeba_res256 config (latent32
    UNet, out 4 x 2 two-head, gaussianBN, lr 1e-4) with the default SD-VAE
    config (random init):

    (a) the cache from 128 procedural 256^2 images (256 latents), then 10
        train steps at batch 256, one an epoch: K1 once per step, K2 never;
    (b) test: one batch of 16, 250 steps, --decode_microbatch 16;
    (c) the VAE's fp32 decode of 2 latents on the card against the CPU at
        1e-3.

    Returns K1's launches in (a).
    """
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder
    from bndm_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from bndm_tpu_torch.samplers import iadb

    data = os.path.join(work, "data_latent")
    make_procedural_folder(os.path.join(data, "celeba_res256"), n=128, res=256, seed=14)
    argv = LATENT256 + [f"--data_root={data}", f"--bluenoise_dir={bn_dir}"]
    run = os.path.join(work, "results_gaussianBN", "latent_iadb_celeba_res256_gaussianBN")
    launches = _latent_train(argv, run, 256, 10, "tri_matmul", 25_845_512)

    rec = []
    reset_launches()
    with watched_samplers(rec, iadb, ("sample_iadb",)):
        text = run_cli(argv + ["--train_or_test=test", "--eval_batch_size=16",
                               "--test_samples=16", "--decode_microbatch=16"], "latent_iadb")
    check(not any(read_launches().values()), "no hand kernel is on the latent sampling path")
    check(len(rec) == 1 and rec[0][2] and rec[0][1] == (16, 4, 32, 32), f"bad samples: {rec}")
    n_img = len(os.listdir(os.path.join(run, "images")))
    check(re.search(r"batch 0: 16 samples", text) is not None and n_img == 16,
          f"expected 16 decoded images, got {n_img}")
    log("latent test: 16 samples decoded and written")

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
    return launches


def phase_latent512(work, bn_dir):
    """The cat_res512 latent config, reduced: 6 train steps at batch 64
    (published: 256) on 32 procedural 512^2 images (64 latents, one batch
    an epoch): K2 once per step, K1 never. Returns K2's launches."""
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder

    data = os.path.join(work, "data_latent512")
    make_procedural_folder(os.path.join(data, "cat_res512"), n=32, res=512, seed=16)
    argv = LATENT512 + [f"--data_root={data}", f"--bluenoise_dir={bn_dir}"]
    run = os.path.join(work, "results_gaussianBN", "latent_iadb_cat_res512_gaussianBN")
    return _latent_train(argv, run, 64, 6, "fused_bluenoise", 113_680_136)


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
    10000."""
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
    runs, wrapped = {}, []
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
    log(f"parallel (a): losses and all {len(wa)} weight arrays bit for bit")

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
    # reference cycles still hold tensors of the steps above: short of memory, the ranks'
    # cuDNN picks other algorithms (other bits than the split's) or runs out
    gc.collect()
    torch.cuda.empty_cache()
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
    log(f"parallel (b): 2 gloo ranks on the card: loss {loss2:.6g} vs one rank {loss1:.6g}; "
        f"UNet grads max|diff| {err:.3e} (bound 1e-5 x norm {norm:.4g} = {1e-5 * norm:.3e}); "
        f"(tau, s, e) grads {got['sched'].tolist()} vs {s1.tolist()}, max|diff| {s_err:.3e} "
        f"({s_err / s_norm:.2e} x its norm; rtol 1e-3); K2/K3 launches on rank 0 "
        f"{got['launches'].tolist()}, one rank "
        f"{[counts['fused_bluenoise'], counts['fused_bluenoise_grad']]}")
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


def phase_dryrun(torch):
    """16. The port's dry run on 2 ranks sharing the card (gloo): the seven
    legs."""
    from bndm_tpu_torch.dryrun import dryrun_multichip

    gc.collect()  # the ranks share the card: free what reference cycles still hold
    torch.cuda.empty_cache()
    t0 = time.time()
    text = dryrun_multichip(2, device="cuda", timeout=300)
    legs = re.findall(r"^dryrun_multichip\(2\): (.+) OK", text, re.M)
    log(f"dryrun: {len(legs)} legs in {time.time() - t0:.1f}s")
    check(len(legs) == 7, f"the dry run must pass seven legs, passed {legs}")


FIGS_M = {3: 4, 1200: 2}  # K1's launches on the figure path, by M


def phase_figs(torch, work, bn_dir):
    """17. The figure CLI at its default 100 realisations: the files, K1
    launched 4 times at M = 3 and twice at M = 1200, the written M = 1200
    spectra within TOL of the plain version's (on the CPU) on the same
    white noise. Returns K1's launches by M."""
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
    return by_m


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


def phase_demo(torch, work):
    """19. The demo: the three full-width res-64 UNets from random init, 50
    steps each; the http server on an ephemeral port, GET the page and a
    frame, POST /api/generate; the static panel."""
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
        ok = json.loads(opener.open(urllib.request.Request(base + "/api/generate?seed=1",
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


OPTIONS = ("--kernels", "--adaln", "--probes", "--tiers", "--pipelines", "--train", "--parallel",
           "--surfaces")


def main(argv):
    if not (argv == [] or (len(argv) == 1 and argv[0] in OPTIONS)):
        log(f"FAIL: unknown arguments {argv} (the options are {', '.join(OPTIONS)})")
        return 2
    only = argv[0] if argv else None
    if not os.path.isdir(os.path.join(HERE, "bndm_tpu_torch")):
        log("FAIL: bndm_tpu_torch/ is not beside chip_smoke.py (run it from the repository)")
        return 1
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("FAIL: CUDA is not available; this smoke run needs an NVIDIA GPU")
        return 1
    torch.backends.cudnn.allow_tf32 = False  # full fp32 convs and matmuls, as
    torch.backends.cuda.matmul.allow_tf32 = False  # the port's CLI sets them

    # 1. device
    from perfbench.yardstick import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), device {kind}; bounds at the "
        f"H100 SXM's {PEAK_HBM_BYTES_S / 1e12:.2f} TB/s, {PEAK_FP32_FLOP_S / 1e12:.0f} TFLOP/s "
        f"fp32, {PEAK_TF32_FLOP_S / 1e12:.1f} TFLOP/s TF32")
    t_start = time.time()

    # 2. build
    from bndm_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f}s")
    if only == "--probes":  # phase 5 alone
        return finish(torch, kind, probe_kernels(phase_probes(torch)), t_start)
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
            phase_train(torch, work, bn_dir)
            return finish(torch, kind, [], t_start)
        if only == "--pipelines":  # phases 12-14 alone: no kernel is timed
            phase_ddim(torch, work)
            phase_latent(torch, work, bn_dir)
            phase_latent512(work, bn_dir)
            return finish(torch, kind, [], t_start)
        if only == "--parallel":  # phases 15-16 alone
            phase_parallel(torch, work, bn_dir)
            phase_dryrun(torch)
            return finish(torch, kind, [], t_start)
        if only == "--surfaces":  # phases 17-19 alone
            phase_figs(torch, work, bn_dir)
            phase_parity(torch, work)
            phase_demo(torch, work)
            return finish(torch, kind, [], t_start)

        # 3-4. K1, K2 and K3
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
        k1 = phase_k1(torch, L_blue, flush)
        k2 = phase_k2(torch, L_blue, flush)
        del flush
        if only == "--kernels":  # phases 3-4 alone: no path driven, no launches counted
            return finish(torch, kind, k_kernels(k1, k2, {}), t_start)
        # 4b. the fused adaLN units and the DiT path
        ad = phase_adaln(torch)
        torch.cuda.empty_cache()
        # 5. the streaming probes and their bench entry points
        probes = phase_probes(torch)
        torch.cuda.empty_cache()
        # 6-7. noise engine and UNet, CUDA vs CPU
        phase_noise(torch, L_blue)
        phase_unet(torch)
        # 8-9. the served paths
        launches = {"superres": phase_superres(torch, work, bn_dir)}
        phase_uncond(torch, work, bn_dir)
        torch.cuda.empty_cache()
        # 9b. the serving tiers
        launches["serving_tiers"] = phase_serving_tiers(torch, work, bn_dir)
        torch.cuda.empty_cache()
        # 10. the training path
        launches["train"], launches["train_k3"] = phase_train(torch, work, bn_dir)
        torch.cuda.empty_cache()
        # 12-14. the HF-style pipelines: DDIM, latent res-256, latent res-512
        phase_ddim(torch, work)
        torch.cuda.empty_cache()
        launches["latent256_train"] = phase_latent(torch, work, bn_dir)
        torch.cuda.empty_cache()
        launches["latent512_train"] = phase_latent512(work, bn_dir)
        torch.cuda.empty_cache()
        # 15-16. data parallelism: one NCCL rank, two gloo ranks, the dry run
        phase_parallel(torch, work, bn_dir)
        torch.cuda.empty_cache()
        phase_dryrun(torch)
        # 17-19. the remaining surfaces: figs (K1 at M = 3 and 1200), parity_check, demo
        launches["figs"] = phase_figs(torch, work, bn_dir)
        torch.cuda.empty_cache()
        phase_parity(torch, work)
        phase_demo(torch, work)

    kernels = k_kernels(k1, k2, launches) + adaln_kernels(ad) + probe_kernels(probes)
    return finish(torch, kind, kernels, t_start)


def k_kernels(k1, k2, launches):
    """The kernels line's rows of K1-K3 from phases 3 and 4, with the
    launches of the paths the run drove (none with --kernels)."""
    rows, k1_sweep = k1
    k2_rows, k3_rows = k2
    main_row = next(r for r in rows if r["m"] == 12)  # the super-res request's shape
    k2_row = next(r for r in k2_rows if r["m"] == 192)  # the train step's shape
    figs = launches.get("figs", {})
    return [{
        "name": "tri_matmul",
        "route": "cuda",
        "source": "bndm_tpu_torch/csrc/tri_matmul.cu",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:74",
        "shape": "L (4096, 4096) @ W (4096, 12)",
        "library": "torch.matmul(L, W)",
        **main_row,
        "launches": launches.get("superres"),
        "launches_serving_tiers": launches.get("serving_tiers"),
        "launches_latent256_train": launches.get("latent256_train"),
        "launches_figs": {f"M={m}": n for m, n in sorted(figs.items())} or None,
        "by_m": rows,
        "sweep": k1_sweep,
    }, {
        "name": "fused_bluenoise",
        "route": "cuda",
        "source": "bndm_tpu_torch/csrc/fused_bluenoise.cu",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:205",
        "shape": "L (4096, 4096), gamma (192,) -> noise, bn, wn (4096, 192)",
        **k2_row,
        "library_ms": None,  # no single PyTorch call draws, correlates and mixes
        "launches": launches.get("train"),
        "launches_latent512_train": launches.get("latent512_train"),
        "by_m": k2_rows,
    }, {
        "name": "fused_bluenoise_grad",
        "route": "cuda",
        "source": "bndm_tpu_torch/ops/cuda_bluenoise.py",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:244",
        "shape": "grad, wn, bn (4096, 192) -> (192,)",
        **k3_rows[0],
        "library_ms": None,  # no single PyTorch call: a multiply and a column sum
        "launches": launches.get("train_k3"),
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
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "library": "torch.add(y, 1)", "bound_by": "bytes", **probes[p]})
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
