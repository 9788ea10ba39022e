"""One module a kind of traffic: ``run(ctx)`` drives the program for one
run of a cell and returns its outcome (see ``perfbench/run.py``)."""
