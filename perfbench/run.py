"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m perfbench.run ...``) from the root of a checkout. The cell
is an entry of ``BENCHMARK.json``'s ``workloads``; its traffic file
``perfbench/traffic/<cell>.json`` names the driver (``perfbench/drivers/
<driver>.py``) that runs it, and its configuration's file holds the sizes.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, each read by ``perfbench/metrics/<metric>.py`` from the
run's record and a profiled sub-window after the measured one. Every run
compares what the timed path produced with the plain reference in
``perfbench/reference`` and prints each number compared beside its limit,
last on standard error and under ``checks`` in the result.

Exits non-zero without a result where CUDA is missing or has fewer devices
than the cell asks for, where the program is not in the checkout, and
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "bndm_tpu")


def load_bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(bench, workload, root=ROOT):
    """(cell, configuration, traffic) of ``workload``, read by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic", workload + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(bench, workload, trace):
    """The metric entries a run of ``workload`` reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def read_metric(name, record, root=ROOT):
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_ctx(workload, seed, seconds, trace, device="cuda", config=None, traffic=None,
             t_start=None, root=ROOT):
    """A run's context: the cell's configuration and traffic (``config`` and
    ``traffic`` replace the cell's files where given), the run's arguments,
    and the driver the traffic names."""
    from perfbench import flops

    cell, conf_file, traffic_file = cell_files(load_bench(root), workload, root)
    ctx = types.SimpleNamespace(
        workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, config=config or conf_file, traffic=traffic or traffic_file,
        t_start=T_START if t_start is None else t_start, flops=flops, chips=cell["chips"])
    return ctx, importlib.import_module("perfbench.drivers." + ctx.traffic["driver"])


def run_cell(workload, seed, seconds, trace, device="cuda", config=None, traffic=None,
             t_start=None, root=ROOT):
    """Run ``workload`` once on ``device``; ``config`` and ``traffic``
    replace the cell's files where given. Returns the result (a dict) and
    the run's checks."""
    import torch

    # full float32 where the program or the reference computes in it, as the
    # program's CLIs run (their disable_tf32) and as the controls were read
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = load_bench(root)
    ctx, driver = make_ctx(workload, seed, seconds, trace, device, config, traffic, t_start, root)
    out = driver.run(ctx)
    metrics = {}
    if trace:
        record = {"run": out["record"], "trace": out["trace"], "config": ctx.config,
                  "traffic": ctx.traffic}
        for m in metrics_of(bench, workload, True):
            value = read_metric(m["name"], record, root)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in metrics_of(bench, workload, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": out["checks"].correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": out["device"]}
    if trace:
        result["device"]["busy_s"] = out["trace"]["busy_s"]
        result["device"]["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = out["checks"].as_dict()
    return result, out["checks"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if importlib.util.find_spec("bndm_tpu_torch") is None:
        print("the program (bndm_tpu_torch) is not in this checkout", file=sys.stderr)
        return 4
    import torch

    chips = cell_files(load_bench(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    print(f"set-up torch and the card ready: {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result, checks = run_cell(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 5
    checks.print()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
