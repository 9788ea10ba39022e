"""Milliseconds of one batch's decode: CUDA events around it in the
measured window, averaged over the batches."""

import statistics


def read(rec):
    run = rec["run"]
    return 1e3 * statistics.mean(run["decode_s"]) if run["decode_s"] else None
