#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bndm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --kernels   # phases 1-4 alone (K1-K3)
    python3 chip_smoke.py --probes    # phases 1, 2 and 5 alone (the probes)

Drives the port's serving and training paths at full width with random
seeded weights and holds every hand-written kernel against its plain
PyTorch version:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under bndm_tpu_torch/csrc, one nvcc each, at once;
  3. K1 (tri_matmul) against fp64 and its plain version over the M sweep
     1-1500 on the TPU kernel test's L (tril(0.02 N(0,1)), unit diagonal)
     and on the generated blue-noise L, the same bits from a second call;
     both of its designs timed at each M (the crossover); then K1 against
     torch.matmul in alternating turns at M = 12, 48, 96, 768 and 1500,
     beside its plain version and the bound, its share of the fp32 FMA
     bound and of the 3xTF32 tensor-core bound;
  4. K2 (fused_bluenoise_flat) against its plain version and fp64 at
     M = 7, 48, 96, 192, 768, 1500 on both L, the exact mix, GBN, the white
     noise's moments, determinism, and K3's gamma gradient; K2 and the
     unfused torch sequence timed in alternating turns at M = 192 and 1500,
     beside the plain version and both bounds; K3's backward (torch ops)
     timed beside its bound;
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
 10. training: the CLI with the flags of
     scripts/training/iadb_bn_cat_res64.sh (gaussianBN, two-head 113.7M
     UNet, batch 64) for 8 steps on 512 procedural images, then a resumed
     ninth step; K2 and K3 must run once per step and K1 not at all; one
     step traced (torch.profiler);
 11. trace: one bf16 UNet forward of each served branch at its shape, its
     host-clock time beside the device's busy time and top kernels;
 12. one JSON line {"kernels": [...]}, then the last line
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
    from bndm_tpu_torch.ops.cuda_bluenoise import FusedBlueNoise, fused_bluenoise_flat, tri_matmul
    from bndm_tpu_torch.ops.stream_probes import dma_add_one, nhwc_add_one, stream_add_one

    return {"tri_matmul": tri_matmul, "fused_bluenoise": fused_bluenoise_flat,
            "fused_bluenoise_grad": FusedBlueNoise, "stream_add_one": stream_add_one,
            "dma_add_one": dma_add_one, "nhwc_add_one": nhwc_add_one}


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    for fn in _counted().values():
        fn.launches = 0


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


def device_kernels(prof):
    """The kernels a torch.profiler run saw on the card: CUDA events other
    than the GPU-side ranges of user annotations (such as the optimizer's
    step), which would count idle gaps as busy."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def watched_trainer(record, traced=None):
    """Record the seconds (host clock, synchronised) and the model's
    parameter count of every train step the CLI takes. With ``traced`` (a
    list), each step runs under torch.profiler instead and its CUDA kernel
    events are appended there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bndm_tpu_torch.train import pixel

    real = pixel.PixelTrainer.step

    def watched(self, batch01, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced is None:
            metrics = real(self, batch01, key)
            torch.cuda.synchronize()
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                metrics = real(self, batch01, key)
                torch.cuda.synchronize()
            traced.extend(device_kernels(prof))
        record.append((time.perf_counter() - t0,
                       sum(p.numel() for p in self.model.parameters())))
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


def run_cli(argv):
    from bndm_tpu_torch.cli.iadb_bn import main

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        main(argv)
    return tee.buf.getvalue()


K1_SWEEP = (1, 7, 12, 16, 24, 32, 48, 64, 96, 192, 768, 1500)  # 12: super-res; 768: res-128 train
K1_TIMED = (12, 48, 96, 768, 1500)  # 1500: a res-64 gallery batch of 500
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


def phase_train(torch, work, bn_dir):
    """The training CLI at full width: 8 steps at batch 64, then a resumed
    ninth step, traced. Returns K2's launches and the step times."""
    import numpy as np

    from bndm_tpu_torch.cli.common import output_folder_name
    from bndm_tpu_torch.cli.iadb_bn import parse_args
    from bndm_tpu_torch.data.imagefolder import make_procedural_folder

    bs, steps = 64, 8
    # scripts/training/iadb_bn_cat_res64.sh:7, one epoch of 512 images
    argv = ["--dataset=cat_res64", "--res=64", f"--batch_size={bs}", "--epochs=1",
            "--train_or_test=train", "--lr=0.0001", "--grad_clip=1.0",
            "--noise_type=gaussianBN", "--scheduler_gamma=sigmoid", "--scheduler_param=1000",
            "--out_channel=6", "--device=cuda", f"--data_root={work}/data",
            f"--bluenoise_dir={bn_dir}"]
    make_procedural_folder(os.path.join(work, "data", "cat_res64"), n=bs * steps, res=64, seed=7)
    os.makedirs(os.path.join(work, "train"))
    with contextlib.chdir(os.path.join(work, "train")):
        run = os.path.abspath(output_folder_name(parse_args(argv)))
        record = []
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with watched_trainer(record):
            text = run_cli(argv + [f"--max_steps={steps}"])
        counts = read_launches()
        counts_k3 = counts["fused_bluenoise_grad"]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = np.atleast_1d(np.loadtxt(os.path.join(run, "losses.txt")))
        sched = np.loadtxt(os.path.join(run, "scheduler_params.txt"))
        log(f"train: {len(record)} steps of batch {bs}, {record[0][1] if record else 0} "
            f"parameters; K2 launches {counts['fused_bluenoise']}, K1 launches "
            f"{counts['tri_matmul']}; losses {losses.tolist()}; scheduler params "
            f"{sched.tolist()}; peak device memory {peak_gib:.2f} GiB")
        check(len(record) == steps and all(p == 113_676_678 for _, p in record),
              f"expected {steps} steps of the 113.7M UNet, got {record}")
        check(counts["fused_bluenoise"] == steps, "K2 must launch once per train step")
        check(counts["fused_bluenoise_grad"] == steps, "K3 must run once per train step")
        check(counts["tri_matmul"] == 0, "K1 is not on the res-64 training path")
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

    secs = [s for s, _ in record]
    steady = bs * (steps - 1) / sum(secs[1:])
    log(f"train: first step {secs[0]:.3f} s; steps 2-{steps}: {steady:.2f} images/s "
        f"(host clock, synchronised; per step {[round(s, 4) for s in secs[1:]]})")
    if kern:
        busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / 1e3
        mean_ms = 1e3 * sum(secs[1:]) / (steps - 1)
        k2_us = sum(e.time_range.elapsed_us() for e in kern if "fused_bluenoise" in e.name)
        log(f"trace train step (bs {bs}, resumed step): device busy {busy_ms:.2f} ms, "
            f"{100 * busy_ms / mean_ms:.1f} % of the untraced mean step {mean_ms:.2f} ms; "
            f"{len(kern)} kernels; K2 {k2_us / 1e3:.4f} ms")
        _log_top(kern)
    else:
        log("trace train step: device time not measured (the profiler saw no CUDA kernels)")
    return {"launches": steps, "k3_launches": counts_k3, "first_step_s": secs[0],
            "images_per_s": steady,
            "step_s": secs, "peak_gib": peak_gib}


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


def phase_trace(torch):
    """Where a served step's time goes: one UNet forward of each branch at
    its served shape, in bf16 as the CLI serves it. The host-clock time per
    forward is taken without the profiler (which slows dispatch); the
    device's busy time and the kernels come from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from bndm_tpu_torch.models.unet2d import UNet2D, unet_config_for_res

    n = 5
    for name, res, in_ch, bs in (("super-res", 128, 6, 1), ("unconditional", 64, 3, 16)):
        torch.manual_seed(6)
        cfg = unet_config_for_res(res, in_channels=in_ch, out_channels=6, dtype="bfloat16")
        model = UNet2D(cfg, device="cuda").cast_params_().eval()
        x = torch.randn(bs, in_ch, res, res, device="cuda")
        t = torch.full((bs,), 0.5, device="cuda")
        with torch.no_grad():
            for _ in range(3):
                model(x, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                model(x, t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    model(x, t)
                torch.cuda.synchronize()
        kern = device_kernels(prof)
        if not kern:
            log(f"trace {name}: forward {wall_ms:.2f} ms (host clock); device time not "
                "measured (the profiler saw no CUDA kernels)")
            continue
        busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / n / 1e3
        log(f"trace {name} (bs {bs}, res {res}, bf16): forward {wall_ms:.2f} ms (host clock), "
            f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
            f"{len(kern) / n:.0f} kernels per forward")
        _log_top(kern)
        del model


def main(argv):
    if argv not in ([], ["--kernels"], ["--probes"]):
        log(f"FAIL: unknown arguments {argv} (the options are --kernels and --probes)")
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

    with tempfile.TemporaryDirectory(prefix="bndm_chip_smoke_") as work, \
            contextlib.chdir(work):  # the CLI writes its run folders under the cwd
        from bndm_tpu_torch.cli.common import load_L_for

        bn_dir = os.path.join(work, "bluenoise")
        t0 = time.time()
        L_blue = torch.from_numpy(load_L_for("gaussianBN", bn_dir)).cuda()
        log(f"blue-noise L generated and cached in {time.time() - t0:.1f}s")
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2

        # 3-4. K1, K2 and K3
        k1 = phase_k1(torch, L_blue, peak, flush)
        k2 = phase_k2(torch, L_blue, peak, flush)
        del flush
        if only == "--kernels":  # phases 3-4 alone: no path driven, no launches counted
            return finish(torch, kind, k_kernels(k1, k2, None), t_start)
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
        # 10. the training path
        tr = phase_train(torch, work, bn_dir)
        torch.cuda.empty_cache()
        # 11. where a served step's time goes
        phase_trace(torch)

    kernels = k_kernels(k1, k2, (sr["launches"], tr["launches"], tr["k3_launches"]))
    kernels += probe_kernels(probes)
    log(f"train: {tr['images_per_s']:.2f} images/s over steps 2-8, first step "
        f"{tr['first_step_s']:.3f} s (batch 64)")
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
