"""Milliseconds a traced step that the main thread spent in the program's
``train.forward`` span: the loss function, the noise draw (K1/K2) and the
UNet's forward dispatched, in the device-only pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.train.forward"})
