"""The main thread's CPU time per train step over the measured window
(``time.thread_time``), outside the profiled sub-window."""


def read(rec):
    run = rec["run"]
    return 1e3 * run["host_cpu_s"] / run["steps"] if run["steps"] else None
