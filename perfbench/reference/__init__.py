"""The plain reference the benchmark judges the program by: float32 PyTorch,
written from the models' and the method's published description. It
imports nothing of the program and takes nothing the program made.

A configuration file names its model in a ``reference`` entry::

    "reference": {"forward": "perfbench.reference.nets:unet",
                  "spec": "perfbench.reference.nets:unet_spec",
                  "settings": "unet", "input": [4, 32, 32]}

``forward(P, settings, x, t, q)`` is the float32 model over the parameter
dict ``P``, inputs ``x`` (B, *input) and timesteps ``t`` (B,), with ``q``
applied to every operand of a product; ``spec(settings)`` gives
{name: shape} of its parameters; ``settings`` is the key of the
configuration that holds the model's widths. A configuration of another
backbone names its own functions, in a module of its own."""

from __future__ import annotations

import importlib


def _resolve(path):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def model_of(config):
    """(forward, spec, settings) of the model ``config``'s ``reference``
    entry names."""
    ref = config["reference"]
    return _resolve(ref["forward"]), _resolve(ref["spec"]), config[ref["settings"]]
