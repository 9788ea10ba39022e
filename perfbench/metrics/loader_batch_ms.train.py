"""The mean wall time, in ms, of the loader's ``data.decode`` spans: one
batch decoded by its thread pool and stacked, on the producer thread of
``BatchLoader``, in the device-only pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(rec):
    return spans.mean_ms(rec, "bndm.data.decode", main=False)
