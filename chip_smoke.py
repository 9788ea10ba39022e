#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bndm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at full width with random seeded weights and
holds every hand-written kernel against its plain PyTorch version:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under bndm_tpu_torch/csrc, one nvcc each, at once;
  3. K1 (tri_matmul) against fp64 and its plain version at M = 12, 7, 1500,
     on a random lower-triangular L and on the generated blue-noise L, with
     its time beside the plain version's, torch.matmul's and the bound;
  4. the noise engine (gaussianBN, inplace) at res 32, 64, 128 on CUDA and
     on the CPU, all three outputs compared;
  5. one full-width res-64 UNet forward in fp32 (TF32 off), CUDA vs CPU;
  6. super-res serving: the CLI with the flags of
     scripts/sampling/iadb_church_superres_test.sh (res 128, 116.3M UNet,
     250 steps) on 4 procedural images; K1 must launch once per request;
  7. unconditional serving: the CLI with the flags of
     scripts/sampling/cat_res64_test.sh (res 64, two-head 113.7M UNet, 250
     steps) on 2 batches of 16;
  8. trace: one bf16 UNet forward of each branch at its served shape, its
     host-clock time beside the device's busy time and top kernels
     (torch.profiler);
  9. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

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

# NVIDIA data-sheet peaks (dense): HBM bytes/s and fp32 FLOP/s on CUDA cores
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM5 (H100 80GB HBM3)
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


def k1_bound(n, m, peak_bytes, peak_flops):
    """Least time for L @ W with L lower-triangular: the triangle of L, W
    and the output each move once; n(n+1)/2 * m multiply-adds."""
    nbytes = 4 * (n * (n + 1) // 2 + 2 * n * m)
    flops = n * (n + 1) * m
    t_b, t_o = nbytes / peak_bytes, flops / peak_flops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def time_ms(torch, fn, iters, flush):
    """Median device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events with the L2 cache flushed before it (a served
    request finds L cold: 250 UNet steps run between two draws)."""
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
    ts = sorted(s.elapsed_time(e) for s, e in pairs)
    return ts[len(ts) // 2]


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


def phase_k1(torch, L_blue, peak, flush):
    from bndm_tpu_torch.ops.cuda_bluenoise import tri_matmul, tri_matmul_plain

    n = L_blue.shape[0]
    g = torch.Generator().manual_seed(0)
    L_rand = torch.tril(torch.randn(n, n, generator=g) * 0.02)  # tests/conftest.py small_L
    L_rand.fill_diagonal_(1.0)
    rows = []
    worst_plain = worst_fp64 = 0.0
    for lname, L in (("random", L_rand.cuda()), ("blue", L_blue)):
        for m in (12, 7, 1500):
            W = torch.randn(n, m, generator=g).cuda()
            out = tri_matmul(L, W)
            torch.cuda.synchronize()
            ref = L.double() @ W.double()
            plain = tri_matmul_plain(L, W)
            e64 = (out.double() - ref).abs().max().item()
            ep = (out - plain).abs().max().item()
            ok64 = torch.allclose(out.double(), ref, rtol=TOL, atol=TOL)
            okp = torch.allclose(out, plain, rtol=TOL, atol=TOL)
            log(f"K1 L={lname} M={m}: max|err| vs fp64 {e64:.3e}, vs plain {ep:.3e} "
                f"(rtol=atol={TOL}) {'ok' if ok64 and okp else 'FAIL'}")
            check(ok64 and okp, f"K1 disagrees at L={lname} M={m}")
            worst_plain, worst_fp64 = max(worst_plain, ep), max(worst_fp64, e64)
            if lname != "blue":
                continue
            iters = 50 if m < 100 else 20
            ms = time_ms(torch, lambda: tri_matmul(L, W), iters, flush)
            plain_ms = time_ms(torch, lambda: tri_matmul_plain(L, W), iters, flush)
            lib_ms = time_ms(torch, lambda: torch.matmul(L, W), iters, flush)
            bound_ms, bound_by = k1_bound(n, m, *peak)
            rows.append({"m": m, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": ep, "max_abs_err_fp64": e64})
            log(f"K1 M={m} times (median, L2 flushed): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
    return rows, worst_plain, worst_fp64


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
    from bndm_tpu_torch.ops.cuda_bluenoise import tri_matmul

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
    tri_matmul.launches = 0
    with watched_sampler(record):
        text = run_cli(argv)
    launches = tri_matmul.launches
    log(f"super-res: K1 launches {launches} for {len(record)} requests")
    check(len(record) == 4, f"expected 4 super-res requests, sampled {len(record)}")
    check(launches == len(record), "K1 must launch once per super-res request")
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
    from bndm_tpu_torch.ops.cuda_bluenoise import tri_matmul

    # scripts/sampling/cat_res64_test.sh:5, at 2 batches of 16 (all saved)
    argv = ["--dataset=cat_res64", "--res=64", "--batch_size=16", "--train_or_test=test",
            "--nb_steps=250", "--test_samples=32", "--noise_type=gaussianBN",
            "--scheduler_gamma=sigmoid", "--scheduler_param=1000", "--out_channel=6",
            "--save_all_samples", "--device=cuda", f"--bluenoise_dir={bn_dir}"]
    out_dir = os.path.join(work, output_folder_name(parse_args(argv)))
    n_params = write_ckpt(torch, unet_config_for_res(64, out_channels=6),
                          os.path.join(out_dir, "model.ckpt"), seed=5)
    log(f"unconditional: {n_params} parameters (res-64 two-head UNet)")
    record = []
    tri_matmul.launches = 0
    with watched_sampler(record):
        text = run_cli(argv)
    log(f"unconditional: K1 launches {tri_matmul.launches} (the branch draws plain white x0)")
    check(len(record) == 2 and all(f and s == (16, 3, 64, 64) for s, f, _ in record),
          f"bad samples: {record}")
    m = re.search(r"gallery: (\d+) images written", text)
    check(m is not None and int(m.group(1)) == 32, "expected 32 images written")
    check(n_params == 113_676_678, "unconditional UNet is not the published 113.7M config")
    return {"launches": tri_matmul.launches, "samples_per_s": [s[0] / sec for s, _, sec in record],
            "params": n_params}


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
    from torch.autograd import DeviceType
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
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kern:
            log(f"trace {name}: forward {wall_ms:.2f} ms (host clock); device time not "
                "measured (the profiler saw no CUDA kernels)")
            continue
        busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kern]) / n / 1e3
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        total = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"trace {name} (bs {bs}, res {res}, bf16): forward {wall_ms:.2f} ms (host clock), "
            f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
            f"{len(kern) / n:.0f} kernels per forward")
        for kname, us in top:
            log(f"  {100 * us / total:5.1f} %  {kname[:110]}")
        del model


def main():
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
        f"{peak_key}: {peak[0] / 1e12:.2f} TB/s, {peak[1] / 1e12:.0f} TFLOP/s fp32")
    t_start = time.time()

    # 2. build
    from bndm_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f}s")

    with tempfile.TemporaryDirectory(prefix="bndm_chip_smoke_") as work, \
            contextlib.chdir(work):  # the CLI writes its run folders under the cwd
        from bndm_tpu_torch.cli.common import load_L_for

        bn_dir = os.path.join(work, "bluenoise")
        t0 = time.time()
        L_blue = torch.from_numpy(load_L_for("gaussianBN", bn_dir)).cuda()
        log(f"blue-noise L generated and cached in {time.time() - t0:.1f}s")
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2

        # 3. K1
        rows, err_plain, err_fp64 = phase_k1(torch, L_blue, peak, flush)
        del flush
        # 4-5. noise engine and UNet, CUDA vs CPU
        phase_noise(torch, L_blue)
        phase_unet(torch)
        # 6-7. the served paths
        sr = phase_superres(torch, work, bn_dir)
        log(f"super-res: samples/s per request (sampler only, synchronised) "
            f"{sr['samples_per_s']}")
        un = phase_uncond(torch, work, bn_dir)
        log(f"unconditional: samples/s per batch (sampler only, synchronised) "
            f"{un['samples_per_s']}")
        # 8. where a served step's time goes
        phase_trace(torch)

    main_row = next(r for r in rows if r["m"] == 12)  # the super-res request's shape
    kernels = [{
        "name": "tri_matmul",
        "route": "cuda",
        "source": "bndm_tpu_torch/csrc/tri_matmul.cu",
        "replaces": "bndm_tpu/ops/pallas_bluenoise.py:74",
        "launches": sr["launches"],
        "max_abs_err": err_plain,
        "max_abs_err_fp64": err_fp64,
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "L (4096, 4096) @ W (4096, 12)",
        "by_m": rows,
    }]
    log(f"wall {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # every phase failure ends the run non-zero, no result line
        traceback.print_exc()
        print("FAIL: a phase failed (traceback above)", flush=True)
        code = 1
    sys.exit(code)
