"""The program's own spans in a traced run, for the metrics that read them.

The program (``bndm_tpu_torch/utils/timing.py``) records its spans while a
torch.profiler profile records, so both of the harness's profiled passes
leave spans behind. :func:`of` keeps those of the first pass, the
device-only one (the least host overhead). A program without spans, or a
trace without kernels, gives none.

Until ``harness.profiled()`` stores the first pass's ``take_spans()`` in
the record under ``trace["program_spans"]`` itself, :func:`_device_pass`
stands in for it: after the run, in the same process and once, it drains
the program's records and keeps the spans that started before the first
pass's last kernel ended (the profiler's clock). It goes, with its time
filter, once the harness keeps the spans.
"""

from __future__ import annotations

import sys


def of(rec):
    """The device-only pass's program spans of a traced run's record
    (``SpanRecord``s: name, parent, thread, main, start_ns, end_ns,
    cpu_ns), taken from the program once and kept in the record under
    ``trace["program_spans"]``."""
    tr = rec.get("trace")
    if not tr:
        return []
    if "program_spans" not in tr:
        tr["program_spans"] = _device_pass(tr)
    return tr["program_spans"]


def _device_pass(tr):
    timing = sys.modules.get("bndm_tpu_torch.utils.timing")
    take = getattr(timing, "take_spans", None)
    ends = [e for _, _, e in tr.get("kernels", ())]
    if take is None or not ends:
        return []
    last_ns = 1e3 * max(ends)
    return [s for s in take() if s.start_ns <= last_ns]


def per_step_ms(rec, names, off_cpu=False):
    """Milliseconds a traced step that the main thread spent in the spans
    ``names`` (wall time; with ``off_cpu``, wall time less the thread's CPU
    time), over ``trace["items"]``; None without program spans."""
    spans = of(rec)
    if not spans:
        return None
    ns = sum(s.end_ns - s.start_ns - (s.cpu_ns if off_cpu else 0)
             for s in spans if s.main and s.name in names)
    return ns / 1e6 / rec["trace"]["items"]


def cover_pct(rec, names):
    """Percent of the main thread's wall time over the traced steps, from
    its first span's start to its last span's end, spent inside the spans
    ``names``; None without program spans."""
    main = [s for s in of(rec) if s.main]
    if not main:
        return None
    wall = max(s.end_ns for s in main) - min(s.start_ns for s in main)
    inside = sum(s.end_ns - s.start_ns for s in main if s.name in names)
    return 100.0 * inside / wall


def mean_ms(rec, name, main):
    """The mean wall time, in ms, of the spans ``name`` on the main thread
    (``main``) or on the others; None where there are none."""
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in of(rec) if s.name == name and s.main == main]
    return sum(ms) / len(ms) if ms else None
