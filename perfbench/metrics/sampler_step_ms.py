"""Milliseconds per sampler step: CUDA events around each batch's
``sample_iadb`` call in the measured window, over its steps, averaged."""

import statistics


def read(rec):
    run = rec["run"]
    if not run["chain_s"]:
        return None
    return 1e3 * statistics.mean(run["chain_s"]) / run["steps"]
