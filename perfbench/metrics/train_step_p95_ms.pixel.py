"""The 95th percentile of the measured window's step intervals (CUDA events
recorded on the stream after each step), in a cell where the host's
stalls spread it too widely between runs to bound it end to end."""


def read(rec):
    return rec["run"]["step_p95_ms"]
