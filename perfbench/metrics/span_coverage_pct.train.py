"""Percent of the main thread's wall time over the traced steps that lies
inside the program's ``data.next`` and ``train.step`` spans, in the
device-only pass (``perfbench/spans.py``). The rest is the benchmark's own
loop (its host-to-device copy of the batch) and the harness, which no
program span sees."""

from perfbench import spans


def read(rec):
    return spans.cover_pct(rec, {"bndm.data.next", "bndm.train.step"})
