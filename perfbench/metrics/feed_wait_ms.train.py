"""Milliseconds a traced step that the main thread spent in the program's
``data.next`` spans: the wait at the loader's queue (``BatchLoader``), or
the gather and float32 cast of a batch from the latent cache, in the
device-only pass (the program's spans, ``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.data.next"})
