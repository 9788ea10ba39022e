"""The DiT's fused adaLN kernels against their roofline: the least time of
one train step's adaLN units (``perfbench/adaln.py``, at the cell's batch,
the configuration's tokens, width and depth) over the device time a profiled
step of the kernels whose names hold ``bndm_adaln``. A program without
them reads nothing."""

from perfbench import adaln, harness

KERNELS = ["bndm_adaln"]


def read(rec):
    tr, s = rec["trace"], rec["config"].get("dit")
    if not tr or not s or not tr["items"]:
        return None
    secs = harness.kernel_seconds(tr, KERNELS) / tr["items"]
    if secs <= 0:
        return None
    n = (s["input_size"] // s["patch_size"]) ** 2
    bound = adaln.bound_s(rec["traffic"]["batch_size"], n, s["hidden_size"], s["depth"])
    return 100.0 * bound / secs
