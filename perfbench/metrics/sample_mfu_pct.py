"""The sampling batch's share of the card's dense bf16 peak: the chain's
UNet forwards and the decode's operations (``perfbench/flops.py``) over the
mean time of a batch's chain, decode and conversion to uint8 in the
measured window."""

import statistics

from perfbench.yardstick import PEAK_BF16_FLOP_S


def read(rec):
    run = rec["run"]
    if not run["batch_s"]:
        return None
    return 100.0 * run["flops_per_batch"] / statistics.mean(run["batch_s"]) / PEAK_BF16_FLOP_S
