"""CPU tests of the benchmark (``python -m pytest perfbench/tests``); the
``gpu``-marked ones run the controls at the cells' sizes on the card."""
