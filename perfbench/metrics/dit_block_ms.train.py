"""Milliseconds a traced step that the main thread spent in the program's
``dit.block`` spans: the host's cost of dispatching the DiT's blocks in the
forward, in the device-only pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.dit.block"})
