"""Room for a configuration of another backbone: on a copy of the benchmark
with new files alone (a stand-in model, a two-layer MLP over the latent,
its reference in a module of its own; its configuration, traffic and
driver, which hands its own program model to the latent cell's loop; its
cell appended to BENCHMARK.json and to the ``workloads`` of the metrics it
reports), the cell passes ``perfbench.files.check``, the harness counts its
FLOPs and follows its first train steps in the shared reference, and a
whole run of it on the CPU is judged correct. Also:
the existing configurations count what they counted, and their reference
steps through ``model_of`` are those of the UNet named directly."""

import filecmp
import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import flops, run, weights
from perfbench.drivers import _train
from perfbench.reference import model_of, nets, train
from perfbench.tests.tiny import ROOT, tiny

torch.set_num_threads(1)

STANDIN = '''"""A two-layer MLP over the flattened latent and its timestep."""
import torch.nn.functional as F
import torch


def forward(P, s, x, t, q):
    b = x.shape[0]
    h = torch.cat([x.flatten(1), t.reshape(b, 1).to(x.dtype)], dim=1)
    h = F.silu(F.linear(q(h), q(P["fc1.weight"]), q(P["fc1.bias"])))
    out = F.linear(q(h), q(P["fc2.weight"]), q(P["fc2.bias"]))
    return out.reshape(b, s["out_channels"], *x.shape[2:])


def spec(s):
    pixels = s["res"] ** 2
    return {"fc1.weight": (s["hidden"], s["channels"] * pixels + 1), "fc1.bias": (s["hidden"],),
            "fc2.weight": (s["out_channels"] * pixels, s["hidden"]),
            "fc2.bias": (s["out_channels"] * pixels,)}
'''
DRIVER = '''"""The stand-in's training: the latent cell's loop, feed and reference with
the stand-in's own program model."""
import torch
import torch.nn.functional as F

from perfbench.drivers import train_latent
from perfbench.drivers.train_latent import inputs  # noqa: F401 (the control's)


class MLP(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        pixels = s["res"] ** 2
        self.s = s
        self.fc1 = torch.nn.Linear(s["channels"] * pixels + 1, s["hidden"])
        self.fc2 = torch.nn.Linear(s["hidden"], s["out_channels"] * pixels)

    def forward(self, x, t):
        b = x.shape[0]
        h = torch.cat([x.flatten(1), t.reshape(b, 1).to(x.dtype)], dim=1)
        out = self.fc2(F.silu(self.fc1(h)))
        return out.reshape(b, self.s["out_channels"], *x.shape[2:])


def build(ctx, init):
    model = MLP(ctx.config["mlp"]).to(ctx.device)
    model.load_state_dict(init, strict=True)
    return model


def run(ctx):
    return train_latent.run(ctx, build_model=build)
'''
MLP = {"channels": 4, "res": 32, "hidden": 16, "out_channels": 8}
PARAMS = 16 * (4 * 1024 + 1) + 16 + 8 * 1024 * 16 + 8 * 1024
PROBE = '''
import json, time
import torch
torch.set_num_threads(1)
from perfbench import files, flops, run
from perfbench.drivers import _train
root = run.ROOT
bench = run.load_bench(root)
ctx, driver = run.make_ctx("mlp_latent.train", 7, 0.0, 0, "cpu", root=root)
ctx.inputs = driver.inputs(ctx)
losses, grad1, delta = _train.reference_steps(ctx, 2)
result, _ = run.run_cell("mlp_latent.train", 7, 0.3, 0, device="cpu", root=root,
                         t_start=time.perf_counter())
print(json.dumps({"root": root, "problems": files.check(bench, root),
                  "flops": flops.model_forward(ctx.config, 4), "losses": losses,
                  "grad1": sorted(grad1), "delta": delta, "result": result}))
'''


def _standin_tree(tmp):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "perfbench", "configs", "celeba256_latent.json")) as f:
        latent = json.load(f)
    new = {
        "mlp_standin.py": STANDIN,
        "perfbench/drivers/train_mlp.py": DRIVER,
        "perfbench/configs/mlp_latent.json": json.dumps({
            "name": "mlp_latent", "parameters": PARAMS, "mlp": MLP, "train": latent["train"],
            "port": {"train_config": latent["port"]["train_config"]},
            "reference": {"forward": "mlp_standin:forward", "spec": "mlp_standin:spec",
                          "settings": "mlp", "input": [4, 32, 32]}}),
        "perfbench/traffic/mlp_latent.train.json": json.dumps({
            "driver": "train_mlp", "batch_size": 4, "latents": 16, "checked_steps": 3,
            "warmup_steps": 1, "trace_steps": 1,
            "limits": {"loss_gap": 1.5e-3, "grad_gap": 0.016, "change_gap": 0.1}})}
    for path, text in new.items():
        with open(os.path.join(tmp, path), "w") as f:
            f.write(text)
    bench_path = os.path.join(tmp, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "mlp_latent", "source": "https://example.org/mlp",
                             "file": "perfbench/configs/mlp_latent.json", "reduced": [],
                             "why": "a stand-in backbone"})
    bench["workloads"].append({"name": "mlp_latent.train", "config": "mlp_latent",
                               "traffic": "train", "chips": 1, "why": "a stand-in cell"})
    # and the cell's name appended to the metrics it reports, nothing else
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_images_per_s", "train_mfu_pct"):
            m["workloads"].append("mlp_latent.train")
    with open(bench_path, "w") as f:
        json.dump(bench, f)


def test_a_second_backbone_needs_new_files_only(tmp_path):
    tmp = str(tmp_path)
    _standin_tree(tmp)
    cmp = filecmp.dircmp(os.path.join(ROOT, "perfbench"), os.path.join(tmp, "perfbench"),
                         ignore=[".cache", "__pycache__"])

    def changed(d, pre):
        out = [pre + f for f in d.diff_files]
        for name, sub in d.subdirs.items():
            out += changed(sub, pre + name + "/")
        return out

    assert changed(cmp, "perfbench/") == []
    # the copy's benchmark first, the program from the repository
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([tmp, ROOT]))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert os.path.realpath(got["root"]) == os.path.realpath(tmp)
    assert got["problems"] == []
    assert got["flops"] == 2 * 4 * (16 * (4 * 1024 + 1) + 8 * 1024 * 16)
    assert len(got["losses"]) == 2 and all(math.isfinite(v) for v in got["losses"])
    assert got["grad1"] == sorted(["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"])
    assert all(v > 0 for v in got["delta"].values())
    assert got["result"]["correct"] and got["result"]["attempted"] > 0
    assert set(got["result"]["metrics"]) == {"train_images_per_s", "setup_s"}


def test_the_existing_configurations_count_what_they_counted():
    bench = run.load_bench()
    configs = {}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            configs[c["name"]] = json.load(f)
    pixel, latent = configs["cat64_bndm"], configs["celeba256_latent"]
    assert flops.model_forward(pixel, 1) == flops.unet_forward(pixel["unet"], 1, 64) \
        == 31062917120
    assert flops.model_forward(latent, 1) == flops.unet_forward(latent["unet"], 1, 32) \
        == 11541938176
    assert flops.vae_decode(latent["vae"], 1, 32) == 622187282432
    assert flops.model_forward(pixel, 64) == 64 * 31062917120


@pytest.mark.parametrize("cell", ["cat64_bndm.train", "celeba256_latent.train"])
def test_reference_steps_through_model_of_are_the_unets(cell):
    config, traffic = tiny(cell)
    forward, spec, settings = model_of(config)
    assert (forward, spec, settings) == (nets.unet, nets.unet_spec, config["unet"])
    ctx, driver = run.make_ctx(cell, 2**31 + 5, 0.0, 0, "cpu", config, traffic,
                               time.perf_counter())
    ctx.inputs = driver.inputs(ctx)
    losses, grad1, delta = _train.reference_steps(ctx, 2)
    P = weights.make(nets.unet_spec(config["unet"]), ctx.seed, "cpu")
    P0 = {k: v.clone() for k, v in P.items()}
    ref_losses, first, P = train.run_steps(P, nets.unet, config["unet"], config["train"],
                                           ctx.inputs.data(2), [(ctx.seed, k) for k in range(2)],
                                           ctx.inputs.L)
    assert losses == ref_losses
    assert grad1 == {k: float(g.norm()) for k, g in first.items()}
    assert delta == {k: float((P[k] - P0[k]).norm()) for k in P}
