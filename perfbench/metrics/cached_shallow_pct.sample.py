"""The share of the cached chain's model calls that ran only the outer
shell: 100 x the shell calls over all the calls the sampler made in the
measured window (the driver's counts; 218 of 250 a batch at 250 steps and
``cache_interval`` 8). None for a chain without a shell."""


def read(rec):
    run = rec["run"]
    calls = run.get("full_calls", 0) + run.get("shallow_calls", 0)
    return 100.0 * run["shallow_calls"] / calls if calls else None
