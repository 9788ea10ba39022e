"""The DiT's attention against its roofline: the least time of one call,
forward and backward (``perfbench/attention.py``, at the cell's batch, the
configuration's tokens and width), over the device time per call of the
attention kernels the configuration names, in the profiled steps (the calls
counted by the program's ``attention.calls``)."""

from perfbench import attention, harness


def read(rec):
    tr, names = rec["trace"], rec["config"].get("kernels", {}).get("attn")
    if not tr or not names or not tr["calls"].get("attn"):
        return None
    secs = harness.kernel_seconds(tr, names) / tr["calls"]["attn"]
    if secs <= 0:
        return None
    s = rec["config"]["dit"]
    n = (s["input_size"] // s["patch_size"]) ** 2
    return 100.0 * attention.bound_s(rec["traffic"]["batch_size"], n, s["hidden_size"]) / secs
