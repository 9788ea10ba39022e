"""Milliseconds a traced step that the main thread spent in the program's
``train.optimizer`` span (the clip, the optimizers' steps, the clamp), in
the device-only pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.train.optimizer"})
