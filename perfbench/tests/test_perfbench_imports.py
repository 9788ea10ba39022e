"""What a run loads and where it refuses to run: no JAX and no JAX package
in the harness's process, nothing of the program in the reference's, no
result without a card, and none in a directory that holds only the
benchmark's own files."""

import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bndm_tpu"}


def _modules(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = _modules("import time, torch\n"
                      "from perfbench import run\n"
                      "from perfbench.tests.tiny import tiny\n"
                      "torch.set_num_threads(1)\n"
                      "c, t = tiny('celeba256_latent.sample')\n"
                      "run.run_cell('celeba256_latent.sample', 5, 0.1, 1, device='cpu', config=c,"
                      " traffic=t, t_start=time.perf_counter())\n"
                      "import perfbench.drivers.train_pixel, perfbench.drivers.train_latent, "
                      "perfbench.drivers.sample_latent_cached, perfbench.files")
    assert not loaded & FORBIDDEN
    assert "bndm_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules("import perfbench.reference.nets, perfbench.reference.noise, "
                      "perfbench.reference.train, perfbench.reference.sample, "
                      "perfbench.flops, perfbench.yardstick, perfbench.weights, "
                      "perfbench.files")
    assert not loaded & (FORBIDDEN | {"bndm_tpu_torch"})


def _run(cwd):
    """A run with every card hidden from it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "cat64_bndm.train",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
