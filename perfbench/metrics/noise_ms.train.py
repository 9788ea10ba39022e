"""Milliseconds a traced step that the main thread spent in the program's
``train.noise`` span: the host's side of the noise draw inside the loss
function (``get_noise``: the K2 launch in the pixel step, K1's in the
latent step), in the device-only pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.per_step_ms(rec, {"bndm.train.noise"})
