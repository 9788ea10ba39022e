"""The fused adaLN unit (``ops/adaln.py``) on the card at the DiT-XL/2 train
cell's shapes: batch 128, 256 tokens, width 1152, bf16 branch and modulation
over the float32 residual stream.

Three ways of the same unit, forward and backward: the fused kernels, their
plain twin in torch ops, and the torch sequence the model ran before the
kernels (``x + gate * y``, ``F.layer_norm``, the cast, the modulation, with
autograd's backward). An interior unit (with the residual update) and block
0's first unit (without) are timed; the kernels and each other way take turns
(a, b, b, a, five times; medians of CUDA-event-timed loops of ``inner``
passes, queued behind a device sleep so that the host's launch time is hidden
as it is in a train step that keeps the device busy). Each line gives ms, the
least bytes (``perfbench/adaln.py``'s count) and their time at the H100 SXM
data sheet's 3.35 TB/s.

    python -m bndm_tpu_torch.scripts.bench_adaln

It runs on CUDA only: the kernels have no CPU mode.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from bndm_tpu_torch.ops import adaln as A

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPE = (128, 256, 1152)
EPS = 1e-6
# bytes an element of (B, N, D): forward, backward (perfbench/adaln.py)
BYTES = {"interior": (12, 18), "first": (6, 14)}
INNER = 20  # passes a timed loop


def inputs(shape=SHAPE, dtype=torch.bfloat16, device="cuda", seed=0):
    """x (float32), y, the (B, 1, D) gate, shift and scale as chunks of one
    modulation row, dz (``dtype``) and the stream's gradient dx' (float32)."""
    b, n, d = shape
    g = torch.Generator(device).manual_seed(seed)

    def randn(*s, dt=torch.float32, std=1.0):
        return (torch.randn(s, generator=g, device=device) * std).to(dt)

    gate, shift, scale = randn(b, 1, 3 * d, dt=dtype, std=0.3).chunk(3, dim=2)
    return dict(x=randn(b, n, d), y=randn(b, n, d, dt=dtype), gate=gate, shift=shift,
                scale=scale, dz=randn(b, n, d, dt=dtype), dxs=randn(b, n, d))


def fused(t, residual):
    y, gate = (t["y"], t["gate"]) if residual else (None, None)
    xs, _, mean, rstd = A.adaln_forward(t["x"], t["shift"], t["scale"], EPS, y, gate)
    return A.adaln_backward(t["dz"], t["dxs"], xs, mean, rstd, t["scale"], y, gate)


def plain(t, residual):
    y, gate = (t["y"], t["gate"]) if residual else (None, None)
    xs, _, mean, rstd = A.adaln_forward_plain(t["x"], t["shift"], t["scale"], EPS, y, gate)
    return A.adaln_backward_plain(t["dz"], t["dxs"], xs, mean, rstd, t["scale"], y, gate)


def unfused(t, residual):
    """The model's torch sequence before the kernels (``models/dit.py``'s
    ``_norm``, ``_modulate`` and gated residual), forward and backward."""
    leaves = {k: t[k].detach().requires_grad_() for k in ("x", "y", "gate", "shift", "scale")}
    x = leaves["x"]
    xs = x + leaves["gate"] * leaves["y"] if residual else x
    norm = F.layer_norm(xs, (xs.shape[2],), eps=EPS).to(t["dz"].dtype)
    z = norm * (1 + leaves["scale"]) + leaves["shift"]
    torch.autograd.backward([xs, z], [t["dxs"], t["dz"]])
    return [v.grad for v in leaves.values()]


def loop_ms(fn, inner=INNER):
    """Device ms a call of ``fn``, over ``inner`` calls queued behind a ~50 ms
    device sleep, so that the host's launches run ahead of the device."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def turns(a, b, inner=INNER, n=5):
    """Medians of ``a`` and ``b`` timed in turns a, b, b, a."""
    ta, tb = [], []
    for _ in range(n):
        ta.append(loop_ms(a, inner))
        tb.append(loop_ms(b, inner))
        tb.append(loop_ms(b, inner))
        ta.append(loop_ms(a, inner))
    return statistics.median(ta), statistics.median(tb)


def report(case, ms, nbytes, **extra):
    row = dict(case=case, ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               share=nbytes / HBM_BYTES_PER_S * 1e3 / ms, **extra)
    print(json.dumps(row), flush=True)
    return row


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_adaln needs a CUDA device")
    print(json.dumps({"card": card(), "torch": torch.__version__, "shape": SHAPE}), flush=True)
    t = inputs()
    elems = t["x"].numel()
    rows = []
    for kind, residual in (("interior", True), ("first", False)):
        nbytes = sum(BYTES[kind]) * elems
        k, pl = turns(lambda: fused(t, residual), lambda: plain(t, residual))
        k2, un = turns(lambda: fused(t, residual), lambda: unfused(t, residual))
        rows.append(report(f"{kind} fused", k, nbytes, again=k2,
                           tiles=[A.tiling(SHAPE[2]), A.tiling(SHAPE[2], True)]))
        rows.append(report(f"{kind} plain twin", pl, nbytes))
        rows.append(report(f"{kind} unfused model sequence", un, nbytes))
    return rows


if __name__ == "__main__":
    main()
