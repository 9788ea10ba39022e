"""BENCHMARK.json and the files it names: found by name, parsed, and within
the benchmark's limits on names, units and keys."""

import importlib.util
import json
import os
import re
import shutil

import pytest

from perfbench import files
from perfbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert len(b["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                               for w in b["command"])
    assert os.path.exists(os.path.join(ROOT, b["command"][1]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    names = [x["name"] for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files_and_reports(cell):
    assert files.check_cell(_bench(), ROOT, cell) == []


@pytest.mark.parametrize("metric", [m["name"] for m in _bench()["per_layer"]])
def test_every_metric_has_its_reader(metric):
    path = os.path.join(ROOT, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("m_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_each_config_is_used_and_counts_its_parameters():
    b = _bench()
    assert files.check_configs(b, ROOT) == []
    assert files.check(b, ROOT) == []
    pixel = _json("perfbench/configs/cat64_bndm.json")
    assert files.parameters(pixel) == (113676678, 113676678)
    latent = _json("perfbench/configs/celeba256_latent.json")
    assert files.parameters(latent) == (25845512, 25845512)


def test_the_check_finds_what_is_missing(tmp_path):
    b = _bench()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    assert files.check(b, str(tmp_path)) == []
    os.remove(tmp_path / "perfbench" / "metrics" / "cached_shallow_pct.sample.py")
    os.remove(tmp_path / "perfbench" / "traffic" / "celeba256_latent.train.json")
    b["configs"].append(dict(b["configs"][0], name="unused"))
    found = files.check(b, str(tmp_path))
    assert any("cached_shallow_pct.sample" in p for p in found)
    assert any("celeba256_latent.train.json" in p for p in found)
    assert any("unused" in p for p in found)
