"""The share of a train step in which no kernel runs on the device: the
union of the kernel intervals of the profiled steps (traced without the
host's operations), per step, against the mean step time of the measured
window, which ran without the profiler and its overhead."""


def read(rec):
    tr, run = rec["trace"], rec["run"]
    if not tr or not tr["kernel_count"] or not run["steps"]:
        return None
    busy = tr["busy_s"] / tr["items"]
    return 100.0 * (1.0 - busy / (run["seconds"] / run["steps"]))
