"""The share of a sampling batch (its chain, decode and conversion to uint8)
in which no kernel runs on the device: the union of the kernel intervals of
one profiled batch (traced without the host's operations) against the mean
batch time of the measured window, which ran without the profiler."""

import statistics


def read(rec):
    tr, run = rec["trace"], rec["run"]
    if not tr or not tr["kernel_count"] or not run["batch_s"]:
        return None
    busy = tr["busy_s"] / tr["items"]
    return 100.0 * (1.0 - busy / statistics.mean(run["batch_s"]))
