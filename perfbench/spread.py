"""Run a cell once a seed, each run a fresh process as the benchmark's
check runs it, and summarise: per metric the values, the median and the
spread (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median); per
compared number the largest reading.

    python3 -m perfbench.spread --workload <cell> --seconds <s> --seeds 1 2 3 \\
        [--trace 1] [--out <file>.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                              "--workload", args.workload, "--seed", str(seed), "--seconds",
                              str(args.seconds), "--trace", str(args.trace)],
                             cwd=ROOT, capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        row = {"seed": seed, "rc": out.returncode, "wall_s": time.perf_counter() - t0}
        row["stderr"] = "\n".join(line for line in out.stderr.splitlines()
                                  if "Warning" not in line)[-2500:]
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            pass
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    ok = [r["result"] for r in rows if "result" in r]
    summary = {"workload": args.workload, "runs": len(rows), "results": len(ok),
               "correct": sum(bool(r["correct"]) for r in ok), "metrics": {}, "checks": {}}
    for name in sorted({m for r in ok for m in r["metrics"]}):
        vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
        summary["metrics"][name] = {"values": vals, "median": statistics.median(vals),
                                    "spread": spread(vals)}
    for name in sorted({c for r in ok for c in r["checks"]}):
        vals = [r["checks"][name]["value"] for r in ok]
        summary["checks"][name] = {"max": max(vals), "values": vals}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
