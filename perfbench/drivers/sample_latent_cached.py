"""Latent IADB sampling through the feature-reuse (cached) chain, with the
decode: per batch, x0 drawn from the seed (standard normal latents),
``bndm_tpu_torch.samplers.iadb.sample_iadb_cached`` over the two calls of
``bndm_tpu_torch.serving.cached_forwards`` of the bf16 serving UNet (every
``cache_interval``-th step the full forward, which also returns the trunk
output at the UNet's ``cache_depth``; the steps between only the outer
shell around that trunk output), then the decode and the images on the
host as uint8, as the latent CLI serves with ``--cache_interval``. Batches
follow one another (a closed loop); the window, the rate and the decode
are those of ``sample_latent``.

The two calls the sampler makes go through a recorder that counts each
kind and keeps, at the steps the seed picks, its inputs, its output and
the trunk output a shell step was given (references, no copy). Of the
finished batches, ``checked_batches`` are kept for the check by a
reservoir drawn from the seed, so that the kept tensors of two batches at
most outlive their batch.

The check, on those batches: the first step's input is the batch's x0
(exactly); at each kept full step the reference UNet's output against the
program's (``unet_gap``); at each kept shell step the reference outer shell
(``perfbench.reference.nets.unet_shell``), given the trunk output the
program's shell was given, against the program's output (``shallow_gap``);
the sampler's updates (``update_gap``, exact) and the decode
(``decode_gap``), as ``sample_latent`` compares them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import datagen, harness
from perfbench.drivers import sample_latent as plain
from perfbench.harness import SPAN
from perfbench.reference import nets, sample


class _Recorder:
    """The two calls of the cached chain, ``apply_full(x, t) -> (d, deep)``
    and ``apply_shallow(x, t, deep) -> d``, counted by kind and keeping
    (x, t, d, deep) at the steps in ``keep`` of each batch (``deep`` None
    for a full step)."""

    def __init__(self, apply_full, apply_shallow, keep):
        self._full, self._shallow, self.keep = apply_full, apply_shallow, keep
        self.i, self.kept = 0, {}
        self.calls = {"full": 0, "shallow": 0}

    def start(self):
        self.i, self.kept = 0, {}

    def _record(self, kind, x, t, d, deep):
        if self.i in self.keep:
            self.kept[self.i] = (x, t, d, deep)
        self.i += 1
        self.calls[kind] += 1

    def full(self, x, t):
        d, deep = self._full(x, t)
        self._record("full", x, t, d, None)
        return d, deep

    def shallow(self, x, t, deep):
        d = self._shallow(x, t, deep)
        self._record("shallow", x, t, d, deep)
        return d


def picks(seed, nb_steps, count, interval):
    """The kept steps: ``sample_latent``'s (the first, the last, ``count``
    drawn from the seed, each with its successor) and the full step that
    starts each one's group of ``interval`` steps."""
    kept = plain._picks(seed, nb_steps, count)
    return sorted(set(kept) | {i - i % interval for i in kept})


def split(kept):
    """({step: (x, t, d)} of the full steps, {step: (x, t, d, deep)} of the
    shell steps) of a batch's kept steps."""
    return ({i: v[:3] for i, v in kept.items() if v[3] is None},
            {i: v for i, v in kept.items() if v[3] is not None})


def shell_gaps(P_u, unet_cfg, kept, depth, q=nets.exact, model=None):
    """Per kept shell step, the worst sample's relative L2 gap between the
    shell's output (the kept one, or ``model``'s at the kept inputs) and the
    reference shell's (with ``q`` on its products) around the same trunk
    output."""
    out = []
    for i in sorted(kept):
        x, t, d, deep = kept[i]
        with torch.no_grad():
            if model is not None:
                d = model(x, t, deep_feature=deep)
            d_ref = nets.unet_shell(P_u, unet_cfg, x.float(), t, deep.float(), depth, q)
        err = (d.float() - d_ref).flatten(1).norm(dim=1) / d_ref.flatten(1).norm(dim=1)
        out.append(float(err.max()))
    return out


def run(ctx):
    from bndm_tpu_torch.samplers.iadb import sample_iadb_cached
    from bndm_tpu_torch.serving import cached_forwards

    cfg, tr, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    unet_cfg, vae_cfg = cfg["unet"], cfg["vae"]
    res, steps, bs = unet_cfg["sample_size"], tr["steps"], tr["batch_size"]
    every, depth = tr["cache_interval"], tr["cache_depth"]
    unet, decode = plain.build_program(ctx, cache_depth=depth)
    harness.stage(ctx, "program built")
    shape = (tr["x0_batches"], bs, unet_cfg["in_channels"], res, res)
    x0s = datagen.normal(seed, 2, shape, device)
    keep = picks(seed, steps, tr["checked_steps"], every)
    model = _Recorder(*cached_forwards(unet), set(keep))

    def one_batch(x0):
        model.start()
        return sample_iadb_cached(model.full, model.shallow, x0, nb_steps=steps,
                                  cache_interval=every, two_head=True)

    with torch.no_grad():
        t = torch.full((bs,), 1.0, device=device)
        for _ in range(tr["warmup_forwards"]):
            unet(x0s[0], t, deep_feature=unet(x0s[0], t, return_deep=True)[1])
    decode(x0s[0])
    harness.sync(device)
    setup_s = time.perf_counter() - ctx.t_start

    rng = np.random.default_rng((int(seed), 11))
    slots = tr["checked_batches"]
    checked, n, failed = [], 0, 0
    marks = harness.Marks(device)
    t0, c0 = time.perf_counter(), time.thread_time()
    t_end = t0
    while time.perf_counter() - t0 < ctx.seconds:
        x0 = x0s[n % len(x0s)]
        marks.mark()
        z = one_batch(x0)
        marks.mark()
        out = decode(z)
        marks.mark()
        imgs = sample.to_uint8(out)
        marks.mark()
        imgs = imgs.cpu()
        failed += bs - len(imgs)
        slot = n if n < slots else int(rng.integers(0, n + 1))
        if slot < slots:
            checked[slot:slot + 1] = [(n, z, model.kept, imgs)]
        n += 1
        t_end = time.perf_counter()
    c1 = time.thread_time()
    iv = marks.intervals_s()
    chain_s, decode_s = iv[0::4], iv[1::4]
    batch_s = [a + b + c for a, b, c in zip(chain_s, decode_s, iv[2::4])]
    harness.log_intervals("batch", batch_s)
    calls = dict(model.calls)
    flops = (calls["full"] * ctx.flops.unet_forward(unet_cfg, bs, res)
             + calls["shallow"] * ctx.flops.unet_shell_forward(unet_cfg, bs, res, depth)) / n
    flops += ctx.flops.vae_decode(vae_cfg, bs, res)
    rec = {"batches": n, "seconds": t_end - t0, "host_cpu_s": c1 - c0, "steps": steps,
           "chain_s": chain_s, "decode_s": decode_s, "batch_s": batch_s,
           "flops_per_batch": flops, "full_calls": calls["full"],
           "shallow_calls": calls["shallow"]}
    trace = None
    if ctx.trace:
        def traced():
            with record_function(SPAN + "sample_chain"):
                z = one_batch(x0s[0])
            with record_function(SPAN + "vae_decode"):
                imgs = sample.to_uint8(decode(z))
            with record_function(SPAN + "to_host"):
                imgs.cpu()

        trace = harness.profiled(traced, device)
        trace["items"] = 1
    device_info = harness.device_info(device)
    del unet, decode, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    checks = _check(ctx, checked, x0s, keep)
    return {"setup_s": setup_s, "e2e": {"sample_images_per_s": n * bs / (t_end - t0)},
            "record": rec, "trace": trace, "checks": checks, "device": device_info,
            "attempted": n * bs, "failed": failed}


def _check(ctx, checked, x0s, keep):
    cfg, tr = ctx.config, ctx.traffic
    P_u = plain.unet_weights(ctx, nets.unet_spec(cfg["unet"]))
    _, da, dg = sample.coefficients(tr["steps"])
    start = unet_gap = shallow_gap = update_gap = decode = 0.0
    for b, z, kept, _ in checked:
        full, shell = split(kept)
        start = max(start, float((kept[0][0] - x0s[b % len(x0s)]).abs().max()))
        unet_gap = max([unet_gap] + plain.unet_gaps(P_u, cfg["unet"], full))
        shallow_gap = max([shallow_gap] + shell_gaps(P_u, cfg["unet"], shell,
                                                      tr["cache_depth"]))
        update_gap = max(update_gap, plain.update_gaps(kept, keep, z, da, dg))
    del P_u
    if checked:
        P_v = plain.vae_weights(ctx)
        for _, z, _, imgs in checked:
            decode = max(decode, plain.decode_gap(P_v, cfg["vae"], z, imgs,
                                                  tr["reference_rows"]))
    none = float("inf")
    checks = harness.Checks()
    lim = tr["limits"]
    checks.add("start_gap", start if checked else none, 0.0)
    checks.add("unet_gap", unet_gap if checked else none, lim["unet_gap"])
    checks.add("shallow_gap", shallow_gap if checked else none, lim["shallow_gap"])
    checks.add("update_gap", update_gap if checked else none, lim["update_gap"])
    checks.add("decode_gap", decode if checked else none, lim["decode_gap"])
    return checks
