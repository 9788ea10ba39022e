"""Timing, profiling and the program's spans.

Counterpart of ``bndm_tpu/utils/timing.py``: chained passes timed with CUDA
events (``pass_ms``), and a ``torch.profiler`` trace in place of
``jax.profiler``'s (``profile_trace``).

Spans mark the phases of the program's own work (the train step's, the data
feed's, the sampler's and the decode's): ``with span("train.forward"):``.
A span is recorded while a ``torch.profiler`` profile records; otherwise
``span()`` returns one shared object that does nothing, and costs the check
of one module-level flag. A recorded span enters ``record_function("bndm." + name)``, so that
the profiler's trace shows it beside the device's kernels, and keeps a
:class:`SpanRecord` in memory until ``take_spans()``. A span reads host
clocks only: it never synchronises the device nor reads a device value.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "bndm."
# spans kept between two take_spans(); later ones are counted, not kept
MAX_SPANS = 200_000


class SpanRecord(NamedTuple):
    name: str  # "bndm.<phase>", the name of its record_function range
    parent: Optional[str]  # the enclosing span on the same thread
    thread: int  # threading.get_ident()
    main: bool  # whether the thread is the main thread
    # time.time_ns(): the clock of torch.profiler's host events (start_ns())
    start_ns: int
    end_ns: int
    cpu_ns: int  # the thread's CPU time over the span (time.thread_time_ns)


_records: list = []
_dropped = 0
_lock = threading.Lock()
_open = threading.local()  # per thread: the names of the open spans


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "range", "t0", "c0")

    def __init__(self, name):
        self.name = PREFIX + name

    def __enter__(self):
        stack = getattr(_open, "names", None)
        if stack is None:
            stack = _open.names = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        cpu = time.thread_time_ns() - self.c0
        t1 = time.time_ns()
        self.range.__exit__(*exc)
        _open.names.pop()
        rec = SpanRecord(self.name, self.parent, threading.get_ident(),
                         threading.current_thread() is threading.main_thread(), self.t0, t1,
                         cpu)
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name):
    """A context manager around one phase of the program's work, named
    ``"bndm." + name`` (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def take_spans():
    """The spans recorded since the last call, in the order they ended; the
    next call starts afresh."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def spans_dropped():
    """How many spans found the record full (``MAX_SPANS`` kept), over the
    life of the process."""
    return _dropped


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
    when CUDA is available, with the program's spans (``bndm.*`` ranges:
    they are recorded while the profile records). Writes
    ``logdir/trace_<pid>_<ns>.json``, a Chrome trace (open it in
    chrome://tracing or Perfetto)."""
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
