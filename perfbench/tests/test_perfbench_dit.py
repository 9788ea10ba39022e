"""The DiT-XL/2 configuration and its cell ``celeba256_dit_xl2.train``: the
benchmark's checks pass with them; the reference counts DiT-XL/2's
parameters and FLOPs; the attention bound's arithmetic; a whole run of the
cell's driver on the CPU at a tiny DiT is judged correct; a program without
the DiT fails at once; the two new readers read a tiny traced record and
give None without one; the reference loads nothing of the program."""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bndm_tpu_torch.utils.timing import SpanRecord
from perfbench import attention, files, flops, run
from perfbench.tests.tiny import ROOT

torch.set_num_threads(1)

CELL = "celeba256_dit_xl2.train"
# a block at batch 1: qkv, proj, fc1, fc2, adaLN and the two attention products
BLOCK_FLOPS = 8_471_642_112
OUTSIDE_FLOPS = 36_864_000  # the patch conv, the time MLP, the final layer's adaLN and linear
TINY_DIT = {"hidden_size": 64, "depth": 2, "num_heads": 4}


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs", "celeba256_dit_xl2.json")) as f:
        return json.load(f)


def _tiny():
    config, traffic = _config(), run.cell_files(run.load_bench(), CELL)[2]
    config["dit"].update(TINY_DIT)
    config["port"]["dit_config"].update(preset="tiny", dtype="float32")
    traffic = dict(traffic, batch_size=4, latents=16, checked_steps=3, warmup_steps=1,
                   trace_steps=1)
    return config, traffic


def _read(metric, rec):
    path = os.path.join(ROOT, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("m_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def test_the_checks_pass_with_the_new_configuration_and_cell():
    bench = run.load_bench()
    assert files.check(bench, ROOT) == []
    assert files.parameters(_config()) == (673_681_568, 673_681_568)
    e2e = {m["name"] for m in run.metrics_of(bench, CELL, False)}
    layer = {m["name"] for m in run.metrics_of(bench, CELL, True)}
    assert e2e == {"train_images_per_s", "train_step_p95_ms", "setup_s"}
    assert {"attn_roofline", "dit_block_ms.train", "train_mfu_pct"} <= layer
    assert "k1_roofline" not in layer  # its reader reads a UNet's in_channels


def test_the_reference_counts_dit_xl2s_flops():
    config = _config()
    assert flops.model_forward(config, 1) == 28 * BLOCK_FLOPS + OUTSIDE_FLOPS == 237_242_843_136
    assert flops.model_forward(config, 128) == 128 * 237_242_843_136
    for depth, want in ((0, OUTSIDE_FLOPS), (1, BLOCK_FLOPS + OUTSIDE_FLOPS)):
        cut = dict(config, dit=dict(config["dit"], depth=depth))
        assert flops.model_forward(cut, 1) == want


def test_the_attention_bound():
    b, n, d = 128, 256, 1152
    assert attention.forward_flops(b, n, d) == 4 * b * n * n * d
    assert attention.backward_bytes(b, n, d) == 2 * attention.forward_bytes(b, n, d) \
        == 8 * b * n * d * 2
    # both passes bound by their bytes at 3.35 TB/s: 90.1 + 180.3 us
    assert attention.bound_s(b, n, d) == pytest.approx((8 + 16) * b * n * d / 3.35e12)
    assert round(attention.bound_s(b, n, d) * 1e6, 1) == 270.4


def test_a_whole_run_of_the_cell_is_correct_on_the_cpu():
    config, traffic = _tiny()
    result, _ = run.run_cell(CELL, 2**31 + 11, 0.3, 0, device="cpu", config=config,
                             traffic=traffic, t_start=time.perf_counter())
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"train_images_per_s", "train_step_p95_ms", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_a_program_without_the_dit_fails_at_once(monkeypatch):
    config, traffic = _tiny()
    ctx, driver = run.make_ctx(CELL, 3, 0.1, 0, "cpu", config, traffic, time.perf_counter())
    monkeypatch.setitem(sys.modules, "bndm_tpu_torch.models.dit", None)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        driver.run(ctx)
    assert not hasattr(ctx, "inputs") and time.perf_counter() - t0 < 5


def _kernels(config, seconds_per_call, calls):
    names = config["kernels"]["attn"]
    per = seconds_per_call * 1e6 / len(names)
    out, t = [["nvjet_gemm", 0.0, 1e3]], 1e3
    for _ in range(calls):
        for n in names:
            out.append([n + "_x", t, t + per])
            t += per
    return out


def test_attn_roofline_reads_its_kernels():
    config = _config()
    bound = attention.bound_s(128, 256, 1152)
    rec = {"trace": {"kernels": _kernels(config, 4 * bound, 56), "calls": {"attn": 56, "k1": 2}},
           "config": config, "traffic": {"batch_size": 128}}
    assert _read("attn_roofline", rec) == pytest.approx(25.0)
    assert _read("attn_roofline", {"trace": None, "config": config,
                                   "traffic": {"batch_size": 128}}) is None
    rec["trace"]["calls"] = {"k1": 2}  # a program without the counter
    assert _read("attn_roofline", rec) is None


def _span(name, start_ms, wall_ms, parent):
    ms = 1_000_000
    return SpanRecord("bndm." + name, parent, 1, True, start_ms * ms, (start_ms + wall_ms) * ms, 0)


def test_dit_block_ms_reads_the_block_spans():
    steps = []
    for t in (0, 100):
        steps += [_span("dit.block", t + 20 + 2 * i, 1.5, "bndm.train.forward")
                  for i in range(28)]
        steps += [_span("dit.embed", t + 19, 1, "bndm.train.forward"),
                  _span("train.forward", t + 18, 70, "bndm.train.step")]
    rec = {"trace": {"items": 2, "kernels": [["k", 0.0, 1.0]], "program_spans": steps}}
    assert _read("dit_block_ms.train", rec) == pytest.approx(28 * 1.5)
    assert _read("dit_block_ms.train", {"trace": None}) is None
    assert _read("dit_block_ms.train", {"trace": {"items": 2, "kernels": [["k", 0.0, 1.0]],
                                                  "program_spans": []}}) is None


def test_the_reference_loads_nothing_of_the_program():
    code = ("import perfbench.reference.dit, perfbench.attention, perfbench.flops\n"
            "import sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ,
                         PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "bndm_tpu", "bndm_tpu_torch"}


def test_the_existing_cells_are_untouched_by_the_new_one():
    bench = run.load_bench()
    for w in bench["workloads"]:
        if w["name"] != CELL:
            names = {m["name"] for m in run.metrics_of(bench, w["name"], True)}
            assert not names & {"attn_roofline", "dit_block_ms.train"}
