"""Milliseconds a traced step that the main thread spent in the program's
``train.backward`` span (``loss.backward()``: autograd's device thread
dispatches while the main thread waits), in the device-only pass
(``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.train.backward"})
