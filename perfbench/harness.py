"""What every driver shares: the device's identity and peak memory, CUDA-event
step times, a profiled sub-window reduced to kernel intervals, idle gaps and
the host's spans, and the comparison's numbers with their limits."""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from perfbench import yardstick

SPAN = "perfbench."
# host events the profiler records of its own work, not the program's
PROFILER_OWN = ("Activity Buffer Request",)


def device_info(device, count=1):
    info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu", "count": count, "memory_peak_bytes": 0}
    if info["platform"] == "gpu":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return info


def stage(ctx, name):
    """Log the seconds since the process started as set-up reaches
    ``name``."""
    print(f"set-up {name}: {time.perf_counter() - ctx.t_start:.3f} s", file=sys.stderr,
          flush=True)


def log_intervals(what, seconds):
    """Log the window's intervals: count, median, 95th percentile, largest,
    and how many took over twice the median."""
    if seconds:
        med = statistics.median(seconds)
        print(f"{what}s: {len(seconds)}, median {1e3 * med:.3f} ms, p95 "
              f"{1e3 * p95(seconds):.3f} ms, max {1e3 * max(seconds):.3f} ms, "
              f"{sum(v > 2 * med for v in seconds)} over twice the median", file=sys.stderr)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Marks:
    """CUDA events recorded on the stream, read after the window: no host
    sync while it runs. On the CPU the host clock after each call."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self):
        """Seconds between consecutive marks."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def p95(values):
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def profiled(fn, device, counters=dict):
    """Trace ``fn`` twice under torch.profiler. First the device alone
    (little host overhead): its kernels, their union over the window from
    the first kernel's start to the last one's end, the top operations.
    Then with the host's operations and the benchmark's spans: what the
    host was doing in the ten longest idle gaps. ``counters()`` reads the
    program's launch counters; ``calls`` holds their change over the first
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    before = counters()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        fn()
        sync(device)
    after = counters()
    kernels, _ = _events(prof)
    lo = min((s for _, s, _ in kernels), default=0.0)
    hi = max((e for _, _, e in kernels), default=0.0)
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    out = {"window_s": (hi - lo) / 1e6, "busy_s": yardstick.busy([k[1:] for k in kernels]) / 1e6,
           "kernels": kernels, "kernel_count": len(kernels),
           "calls": {k: after[k] - before[k] for k in after},
           "device_ops": sorted(([n, v] for n, v in by_name.items()), key=lambda kv: -kv[1])[:10]}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN + "window"):
            fn()
            sync(device)
    out["breakdown"] = {"device_ops": out.pop("device_ops"), "idle_gaps": idle_gaps(prof)}
    return out


def _annotation(e):
    """Whether a device event only mirrors a host span on the device's
    timeline (a user annotation), rather than work the device did."""
    if getattr(e, "is_user_annotation", None) and e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _events(prof):
    """(device work, host ops) as (name, start_us, end_us) from the
    profiler's own event list: kernels, copies and fills on the device."""
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        item = (e.name(), s, s + e.duration_ns() / 1e3)
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif not _annotation(e):
            kernels.append(item)
    return kernels, host


def idle_gaps(prof):
    """The ten longest gaps without device work inside the span
    ``perfbench.window``, each named by the benchmark span and the innermost
    host operation running at its middle."""
    kernels, host = _events(prof)
    win = [h for h in host if h[0] == SPAN + "window"]
    lo, hi = (win[0][1], win[0][2]) if win else (0.0, 0.0)
    inside = [(s, e) for _, s, e in kernels if e > lo and s < hi]
    gaps = sorted(yardstick.gaps(inside, lo, hi), key=lambda g: g[0] - g[1])[:10]
    spans = [h for h in host if h[0].startswith(SPAN) and h[0] != SPAN + "window"]
    ops = [h for h in host if not h[0].startswith(SPAN) and h[0] not in PROFILER_OWN]
    return [[_host_at(spans, ops, (a + b) / 2), (b - a) / 1e6] for a, b in gaps]


def _host_at(spans, ops, t):
    """'<benchmark span> > <innermost host op>' running at time ``t``."""
    def inner(items):
        live = [h for h in items if h[1] <= t <= h[2]]
        return min(live, key=lambda h: h[2] - h[1])[0] if live else None

    span = inner(spans)
    name = (span[len(SPAN):] if span else "outside") + " > " + (inner(ops) or "idle host")
    return name[:200]


def kernel_seconds(trace, patterns):
    """Device seconds of the kernels whose name holds one of ``patterns``."""
    return sum((e - s) / 1e6 for n, s, e in trace["kernels"] if any(p in n for p in patterns))


class Checks:
    """The numbers the run compares, each with its limit: within when the
    number is at or below it (an exact comparison has the limit 0)."""

    def __init__(self):
        self.items, self.notes = [], []

    def add(self, name, value, limit):
        self.items.append((name, float(value), float(limit)))

    def note(self, name, value):
        """A reading the cell prints and does not hold to a limit."""
        self.notes.append((name, float(value)))

    @property
    def correct(self):
        return bool(self.items) and all(math.isfinite(v) and v <= lim
                                        for _, v, lim in self.items)

    def as_dict(self):
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def print(self, file=sys.stderr):
        for n, v in self.notes:
            print(f"reading {n}: {v!r} (not compared)", file=file)
        for n, v, lim in self.items:
            ok = "ok" if math.isfinite(v) and v <= lim else "FAILS"
            print(f"check {n}: {v!r} limit {lim!r} {ok}", file=file)
        print(f"correct: {self.correct}", file=file, flush=True)


def relative_gap(a, b):
    """|a - b| / |b| of two numbers."""
    return abs(a - b) / abs(b)


def norm_gaps(prog, ref, keys=None):
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and the median
    leaf's. ``prog``, ``ref``: {leaf: norm}."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in ref)
    worst, at = 0.0, None
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not (g <= worst):
            worst, at = g, k
    return worst, at
