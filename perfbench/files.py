"""What every cell and configuration of ``BENCHMARK.json`` needs before it
can run, found by name under a checkout's root:

* each cell: its configuration and that configuration's file, its traffic
  file ``perfbench/traffic/<cell>.json`` with limits, the driver the traffic
  names (``perfbench/drivers/<driver>.py``), the model the configuration's
  ``reference`` entry names (``perfbench.reference.model_of``), a reader
  ``perfbench/metrics/<metric>.py`` of every metric it reports; and it
  reports ``setup_s``, one more end-to-end metric and a per-layer metric,
  each per-layer one moving an end-to-end metric the cell reports;
* each configuration: some cell uses it, and its reference model's
  parameters add up to its declared ``parameters`` (a number, or a dict
  keyed by the reference entry's ``settings``).

A configuration of another backbone passes with new files alone: its own
configuration, traffic, driver and reference module."""

from __future__ import annotations

import json
import math
import os

from perfbench.reference import model_of


def _json(root, path):
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def check_cell(bench, root, name):
    """The problems of cell ``name``, as strings (none where all is well)."""
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    confs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in confs:
        return [f"{name}: no configuration {cell['config']!r}"]
    files = [confs[cell["config"]]["file"], os.path.join("perfbench", "traffic", name + ".json")]
    missing = [f for f in files if not os.path.exists(os.path.join(root, f))]
    if missing:
        return [f"{name}: no file {f}" for f in missing]
    problems = []
    config, traffic = (_json(root, f) for f in files)
    if config.get("name") != cell["config"]:
        problems.append(f"{name}: the configuration file names {config.get('name')!r}")
    if not traffic.get("limits"):
        problems.append(f"{name}: the traffic file holds no limits")
    driver = os.path.join(root, "perfbench", "drivers", traffic["driver"] + ".py")
    if not os.path.exists(driver):
        problems.append(f"{name}: no driver {traffic['driver']!r}")
    forward, spec, settings = model_of(config)
    if not (callable(forward) and spec(settings)):
        problems.append(f"{name}: the configuration's reference model has no parameters")
    e2e = {m["name"]: m for m in bench["end_to_end"] if _reports(m, name)}
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    if "setup_s" not in e2e or len(e2e) < 2 or not layer:
        problems.append(f"{name}: reports {sorted(e2e)} end to end and {len(layer)} per layer")
    for m in layer:
        if m["moves"] not in e2e:
            problems.append(f"{name}: {m['name']} moves {m['moves']}, which the cell lacks")
        if not os.path.exists(os.path.join(root, "perfbench", "metrics", m["name"] + ".py")):
            problems.append(f"{name}: no reader of {m['name']}")
    return problems


def parameters(config):
    """(counted, declared) parameters of the configuration's reference
    model."""
    _, spec, settings = model_of(config)
    counted = sum(math.prod(s) for s in spec(settings).values())
    declared = config["parameters"]
    if isinstance(declared, dict):
        declared = declared[config["reference"]["settings"]]
    return counted, declared


def check_configs(bench, root):
    """The problems of the configurations, as strings."""
    used = {w["config"] for w in bench["workloads"]}
    problems = [f"configuration {c['name']} is used by no cell"
                for c in bench["configs"] if c["name"] not in used]
    for c in bench["configs"]:
        counted, declared = parameters(_json(root, c["file"]))
        if counted != declared:
            problems.append(f"configuration {c['name']}: {counted} parameters, "
                            f"{declared} declared")
    return problems


def check(bench, root):
    """Every problem of ``bench``'s cells and configurations under
    ``root``, as strings: none where all is well."""
    problems = check_configs(bench, root)
    for w in bench["workloads"]:
        problems += check_cell(bench, root, w["name"])
    return problems
