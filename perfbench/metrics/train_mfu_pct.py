"""The train step's share of the card's dense bf16 peak: three forward
passes' operations of the UNet at the cell's batch (forward, and the
backward's two products; from ``perfbench/flops.py``) per step, over the
measured window's mean step time."""

from perfbench.yardstick import PEAK_BF16_FLOP_S


def read(rec):
    run = rec["run"]
    if not run["steps"]:
        return None
    return 100.0 * run["flops_per_step"] * run["steps"] / run["seconds"] / PEAK_BF16_FLOP_S
