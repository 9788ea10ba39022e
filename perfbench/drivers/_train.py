"""The closed training loop both training drivers run, and its check.

Set-up builds the program's train state once, drives it from the seed
through its first ``checked_steps`` steps with the window's own call and
feed (keys (seed, 0), (seed, 1), ...), reads what the check needs, warms
up ``warmup_steps`` more, and hands the same state to the window. The
window starts steps until ``--seconds`` have passed, then synchronises:
the rate is every image of every step over that time, the tail the 95th
percentile of the steps' intervals between CUDA events recorded on the
stream after each step (the first against one at the window's start).

The check: the reference follows the first steps from the same initial
weights, data and keys, and three numbers are held to the limits of the
cell's traffic file (one without a limit there is printed, not held): the
worst step's loss gap; the first gradient as the optimizer got it
(AdamW's first moment after one step, over 1 - beta1), the worst leaf's
gap of norms; the change of the weights over the checked steps, the worst
leaf's gap of norms, leaving out leaves whose reference gradient is under
a thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch
from torch.profiler import record_function

from perfbench import harness, weights
from perfbench.harness import SPAN
from perfbench.reference import model_of, nets, train


def _norms(tensors):
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).cpu().tolist()


def _first_gradient(program, beta1):
    """Per leaf, the norm of the first gradient as the optimizer got it:
    AdamW's first moment after one step, over 1 - beta1 (nought where the
    optimizer holds none)."""
    state = program.optimizer.state
    return _norms([state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in state.get(p, {})
                   else torch.zeros_like(p) for p in program.params.values()])


def run(ctx, make_program):
    """``make_program()`` builds the program: its ``.params`` {name:
    parameter}, ``.optimizer`` (the torch optimizer whose state holds the
    first moments), ``.next_batch()`` (the feed), ``.step(batch, key) ->
    {"loss": tensor}``, ``.counters()`` (the program's launch counters),
    ``.close()``. Returns the driver's outcome (see ``perfbench/run.py``)."""
    tr, cfg = ctx.traffic, ctx.config
    device, seed = ctx.device, ctx.seed
    harness.stage(ctx, "inputs made")
    program = make_program()
    harness.stage(ctx, "program built")
    names = list(program.params)
    p0 = [p.detach().clone() for p in program.params.values()]
    losses = []
    beta1 = cfg["train"]["betas"][0]
    n_check = tr["checked_steps"]
    for k in range(n_check):
        losses.append(program.step(program.next_batch(), (seed, k))["loss"])
        if k == 0:
            grad1 = dict(zip(names, _first_gradient(program, beta1)))
    delta = dict(zip(names, _norms([p.detach() - q for p, q in
                                    zip(program.params.values(), p0)])))
    del p0
    harness.stage(ctx, "checked steps run")
    step = n_check
    for _ in range(tr["warmup_steps"]):
        program.step(program.next_batch(), (seed, step))
        step += 1
    harness.sync(device)
    losses = [float(v) for v in losses]
    setup_s = time.perf_counter() - ctx.t_start

    marks = harness.Marks(device)
    marks.mark()
    t0, c0 = time.perf_counter(), time.thread_time()
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        program.step(program.next_batch(), (seed, step))
        marks.mark()
        step += 1
        steps += 1
    harness.sync(device)
    t1, c1 = time.perf_counter(), time.thread_time()
    intervals = marks.intervals_s()
    harness.log_intervals("step", intervals)
    batch = tr["batch_size"]
    rec = {"steps": steps, "seconds": t1 - t0, "host_cpu_s": c1 - c0,
           "step_p95_ms": 1e3 * harness.p95(intervals) if intervals else None,
           "flops_per_step": 3 * ctx.flops.model_forward(cfg, batch)}
    trace = None
    if ctx.trace:
        def traced():
            nonlocal step
            for _ in range(tr["trace_steps"]):
                with record_function(SPAN + "loader"):
                    b = program.next_batch()
                with record_function(SPAN + "train_step"):
                    program.step(b, (seed, step))
                step += 1

        trace = harness.profiled(traced, device, program.counters)
        trace["items"] = tr["trace_steps"]
    attempted = step - n_check - tr["warmup_steps"]
    program.close()
    device_info = harness.device_info(device)
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare((losses, grad1, delta), reference_steps(ctx, n_check))
    checks = harness.Checks()
    for name, value in numbers.items():
        if name in tr["limits"]:
            checks.add(name, value, tr["limits"][name])
        else:
            checks.note(name, value)
    return {"setup_s": setup_s,
            "e2e": {"train_images_per_s": batch * steps / (t1 - t0),
                    "train_step_p95_ms": 1e3 * harness.p95(intervals)},
            "record": rec, "trace": trace, "checks": checks, "device": device_info,
            "attempted": attempted, "failed": 0}


def reference_steps(ctx, n, q=nets.exact, keep=None):
    """The reference's (losses, first-gradient norms, change norms) over the
    first ``n`` steps of the configuration's model (``model_of``), from the
    seed's initial weights (the driver's ``inputs``), with ``q`` applied
    to every operand of a product (the identity; a lower precision for the
    control) and ``keep`` samples of each batch (all; half for a fault)."""
    inp = ctx.inputs
    forward, _, settings = model_of(ctx.config)
    P = weights.make(inp.spec, ctx.seed, ctx.device)
    P0 = {k: v.clone() for k, v in P.items()}
    losses, first, P = train.run_steps(P, forward, settings, ctx.config["train"], inp.data(n),
                                       [(ctx.seed, k) for k in range(n)], inp.L, q, keep)
    return (losses, {k: float(g.norm()) for k, g in first.items()},
            {k: float((P[k] - P0[k]).norm()) for k in P})


def compare(prog, ref):
    """The three numbers of the check from the program's and the reference's
    (losses, first-gradient norms, change norms)."""
    (losses, grad1, delta), (ref_losses, ref_grad1, ref_delta) = prog, ref
    med = statistics.median(ref_grad1.values())
    moving = [k for k in ref_grad1 if ref_grad1[k] >= 1e-3 * med]
    return {"loss_gap": max(harness.relative_gap(a, b) for a, b in zip(losses, ref_losses)),
            "grad_gap": harness.norm_gaps(grad1, ref_grad1)[0],
            "change_gap": harness.norm_gaps(delta, ref_delta, moving)[0]}
