"""Timing and profiling utilities.

Counterpart of ``bndm_tpu/utils/timing.py``: host-clock timing of calls that
are synchronised on the device (``torch.cuda.synchronize`` in place of
``block_until_ready``), the mean excluding the first (warm-up) call, and a
``torch.profiler`` trace in place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class Timer:
    """Collects per-call wall times; mean excludes the first (warmup) call."""

    def __init__(self, name=""):
        self.name = name
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self):
        if len(self.times) <= 1:
            return float(np.mean(self.times)) if self.times else float("nan")
        return float(np.mean(self.times[1:]))

    @property
    def total(self):
        return float(np.sum(self.times))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn, *args, iters=10, warmup=2, device="cuda", **kwargs):
    """Device-synchronized benchmark of ``fn``; returns (mean_s, out). Each
    call is followed by a synchronise of ``device`` (nothing to wait for on
    the CPU), so the host clock covers the device's work."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
        _sync(device)
    return (time.perf_counter() - t0) / iters, out


def pass_ms(fn, x, inner=20, device="cuda"):
    """Milliseconds per pass of ``inner`` chained passes ``x = fn(x)`` run
    back to back, after one warm-up loop (the counterpart of one
    ``lax.scan`` of ``fn`` behind a host fetch): CUDA events around the loop
    on a CUDA device, the host clock on the CPU."""

    def loop():
        y = x
        for _ in range(inner):
            y = fn(y)
        return y

    loop()
    _sync(device)
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner
    t0 = time.perf_counter()
    loop()
    return (time.perf_counter() - t0) * 1e3 / inner


@contextlib.contextmanager
def profile_trace(logdir):
    """torch.profiler trace of the block: CPU activity, and CUDA activity
    when CUDA is available. Writes ``logdir/trace_<pid>_<ns>.json``, a Chrome
    trace (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
