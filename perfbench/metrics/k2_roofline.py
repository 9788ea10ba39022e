"""K2 (the fused RNG -> L-matmul -> mix) against its roofline: the least
time of one call at the step's (n, M) on the card (the yardstick's bytes
at the HBM peak, the triangular product at the TF32 peak) over the device
time of its kernels per call in the profiled steps (the kernels the
configuration names; the calls counted by the program's launch counter)."""

from perfbench import harness, yardstick


def read(rec):
    tr, names = rec["trace"], rec["config"]["kernels"].get("k2")
    if not tr or not names or not tr["calls"].get("k2"):
        return None
    secs = harness.kernel_seconds(tr, names) / tr["calls"]["k2"]
    if secs <= 0:
        return None
    m = rec["traffic"]["batch_size"] * rec["config"]["unet"]["in_channels"]
    return 100.0 * yardstick.kernel_bound_s("k2", 4096, m)[0] / secs
