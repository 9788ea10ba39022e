"""Latent IADB sampling with the decode: per batch, x0 drawn from the seed
(standard normal latents), ``bndm_tpu_torch.samplers.iadb.sample_iadb``
through the bf16 serving UNet of ``bndm_tpu_torch.serving.build_model``,
the decode of ``bndm_tpu_torch.models.vae.make_decoder`` in the latent
CLI's chunks, and the images on the host as uint8, one batch after
another (a closed loop).

The window starts batches until ``--seconds`` have passed, taking the x0
drawn at set-up in turn; the rate is every image of every batch over the
time to the last batch's end. The
model the sampler calls is the serving UNet behind a call that keeps, at
the steps the seed picks, its input and output (references, no copy).

The check, on batches drawn from the seed among those finished: the first
step's input is the batch's x0 (exactly); at each kept step the reference
UNet's output against the program's (per sample, relative L2; the worst);
the sampler's update of each kept step against the reference's update of
the same input and model output (relative to the reference's step); and
the reference decode of the program's final latents against its images
(per image, the mean absolute difference in uint8 levels; the worst).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import datagen, harness, weights
from perfbench.drivers import _port
from perfbench.harness import SPAN
from perfbench.reference import nets, sample


class _Recorder:
    """The model the sampler calls: the UNet, keeping (x, t, d) at the steps
    in ``keep`` of each batch."""

    def __init__(self, unet, keep):
        self.unet, self.keep = unet, keep
        self.i, self.kept = 0, {}

    def start(self):
        self.i, self.kept = 0, {}

    def __call__(self, x, t):
        d = self.unet(x, t)
        if self.i in self.keep:
            self.kept[self.i] = (x, t, d)
        self.i += 1
        return d


def _picks(seed, nb_steps, count):
    """The kept steps: the first, the last, and ``count`` more drawn from
    the seed, each with its successor (whose input is the step's result)."""
    rng = np.random.default_rng((int(seed), 7))
    picks = {0, nb_steps - 1}
    picks.update(int(i) for i in rng.choice(nb_steps - 1, size=count, replace=False))
    return sorted(picks | {i + 1 for i in picks if i + 1 < nb_steps})


def build_program(ctx, **unet_changes):
    """The program's serving UNet (``serving.build_model``: cast to bf16,
    eval) and decoder (``make_decoder`` in the cell's chunks), loaded with
    the seed's weights in the configuration's served type.
    ``unet_changes``: fields of the UNet's config set as a serving flag
    sets them (``cache_depth``)."""
    from bndm_tpu_torch.models.vae import AutoencoderKL, make_decoder
    from bndm_tpu_torch.serving import build_model

    cfg, port = ctx.config, ctx.config["port"]
    dt = getattr(torch, cfg["weights_dtype"])
    init = weights.make(nets.unet_spec(cfg["unet"]), ctx.seed, ctx.device, dt)
    mcfg = dataclasses.replace(_port.unet_config(port), **unet_changes)
    unet = build_model(mcfg, init, ctx.device)
    vae = AutoencoderKL(_port.vae_config(port), device="meta")
    vae = vae.to_empty(device=ctx.device)
    vae.load_state_dict(_vae_init(ctx, weights.spec_of(vae)), strict=True)
    return unet, make_decoder(vae.eval(), ctx.traffic["decode_microbatch"])


def _vae_init(ctx, spec_all):
    """The VAE's weights: the decoder's (what the reference reads) from the
    seed, the rest (the encoder's) from the next seed, so that the decoder's
    values do not depend on the encoder's leaves."""
    dec = nets.vae_decode_spec(ctx.config["vae"])
    dt = getattr(torch, ctx.config["weights_dtype"])
    extra = {k: s for k, s in spec_all.items() if k not in dec}
    return {**weights.make(dec, ctx.seed, ctx.device, dt),
            **weights.make(extra, ctx.seed + 1, ctx.device, dt)}


def vae_weights(ctx):
    """The reference decoder's weights, float32."""
    dec = nets.vae_decode_spec(ctx.config["vae"])
    return {k: v.float() for k, v in _vae_init(ctx, dec).items()}


def decode_gap(P_v, vae_cfg, z, imgs, rows, q=nets.exact):
    """The worst image's mean absolute difference, in uint8 levels, between
    the served images ``imgs`` and the reference decode of ``z`` (in blocks
    of ``rows``)."""
    worst = 0.0
    for s in range(0, len(z), rows):
        with torch.no_grad():
            ref = sample.to_uint8(nets.vae_decode(P_v, vae_cfg, z[s:s + rows].float(), q))
        diff = (imgs[s:s + len(ref)].to(ref.device).float() - ref.float()).abs()
        worst = max(worst, float(diff.flatten(1).mean(dim=1).max()))
    return worst


def run(ctx):
    from bndm_tpu_torch.samplers.iadb import sample_iadb

    cfg, tr, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    unet_cfg, vae_cfg = cfg["unet"], cfg["vae"]
    res, steps, bs = unet_cfg["sample_size"], tr["steps"], tr["batch_size"]
    unet, decode = build_program(ctx)
    harness.stage(ctx, "program built")
    shape = (tr["x0_batches"], bs, unet_cfg["in_channels"], res, res)
    x0s = datagen.normal(seed, 2, shape, device)
    keep = _picks(seed, steps, tr["checked_steps"])
    model = _Recorder(unet, set(keep))

    def one_batch(x0):
        model.start()
        z, _ = sample_iadb(model, x0, nb_steps=steps, two_head=True)
        return z

    with torch.no_grad():
        for _ in range(tr["warmup_forwards"]):
            unet(x0s[0], torch.full((bs,), 1.0, device=device))
    decode(x0s[0])
    harness.sync(device)
    setup_s = time.perf_counter() - ctx.t_start

    marks = harness.Marks(device)
    t0, c0 = time.perf_counter(), time.thread_time()
    done, t_end = [], t0
    while time.perf_counter() - t0 < ctx.seconds:
        x0 = x0s[len(done) % len(x0s)]
        marks.mark()
        z = one_batch(x0)
        marks.mark()
        out = decode(z)
        marks.mark()
        imgs = sample.to_uint8(out)
        marks.mark()
        done.append((z, model.kept, imgs.cpu()))
        t_end = time.perf_counter()
    c1 = time.thread_time()
    iv = marks.intervals_s()
    chain_s, decode_s = iv[0::4], iv[1::4]
    batch_s = [a + b + c for a, b, c in zip(chain_s, decode_s, iv[2::4])]
    harness.log_intervals("batch", batch_s)
    n = len(done)
    flops = steps * ctx.flops.unet_forward(unet_cfg, bs, res) + ctx.flops.vae_decode(
        vae_cfg, bs, res)
    rec = {"batches": n, "seconds": t_end - t0, "host_cpu_s": c1 - c0, "steps": steps,
           "chain_s": chain_s, "decode_s": decode_s,
           "batch_s": batch_s, "flops_per_batch": flops}
    trace = None
    if ctx.trace:
        def traced():
            x0 = x0s[0]
            with record_function(SPAN + "sample_chain"):
                z = one_batch(x0)
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

    checks = _check(ctx, done, x0s, keep)
    return {"setup_s": setup_s, "e2e": {"sample_images_per_s": n * bs / (t_end - t0)},
            "record": rec, "trace": trace, "checks": checks, "device": device_info,
            "attempted": n * bs, "failed": sum(bs - len(imgs) for _, _, imgs in done)}


def unet_gaps(P_u, unet_cfg, kept, model=None):
    """Per kept step, the worst sample's relative L2 gap between the UNet's
    output (the kept one, or ``model``'s at the kept input) and the
    reference's."""
    out = []
    for i in sorted(kept):
        x, t, d = kept[i]
        with torch.no_grad():
            if model is not None:
                d = model(x, t)
            d_ref = nets.unet(P_u, unet_cfg, x.float(), t)
        err = (d.float() - d_ref).flatten(1).norm(dim=1) / d_ref.flatten(1).norm(dim=1)
        out.append(float(err.max()))
    return out


def update_gaps(kept, keep, z, da, dg):
    """The worst kept step's gap between the sampler's update (the next kept
    step's input, or the chain's result ``z`` after the last step) and the
    reference's update of the step's input and model output, relative to the
    reference's step. ``kept[i]`` begins with (x, t, d)."""
    worst = 0.0
    for i in keep:
        x, d = kept[i][0], kept[i][2]
        nxt = kept[i + 1][0] if i + 1 in kept else (z if i == len(da) - 1 else None)
        if nxt is not None:
            ref = sample.update(x.float(), d.float(), da[i], dg[i])
            worst = max(worst, float((nxt.float() - ref).norm() / (ref - x.float()).norm()))
    return worst


def unet_weights(ctx, u_spec):
    dt = getattr(torch, ctx.config["weights_dtype"])
    return {k: v.float() for k, v in weights.make(u_spec, ctx.seed, ctx.device, dt).items()}


def _check(ctx, done, x0s, keep):
    tr = ctx.traffic
    rng = np.random.default_rng((int(ctx.seed), 11))
    picked = sorted(rng.choice(len(done), size=min(tr["checked_batches"], len(done)),
                               replace=False).tolist()) if done else []
    P_u = unet_weights(ctx, nets.unet_spec(ctx.config["unet"]))
    _, da, dg = sample.coefficients(tr["steps"])
    start = unet_gap = update_gap = decode = 0.0
    for b in picked:
        z, kept, imgs = done[b]
        start = max(start, float((kept[0][0] - x0s[b % len(x0s)]).abs().max()))
        unet_gap = max([unet_gap] + unet_gaps(P_u, ctx.config["unet"], kept))
        update_gap = max(update_gap, update_gaps(kept, keep, z, da, dg))
    if picked:
        P_v = vae_weights(ctx)
        for b in picked:
            z, _, imgs = done[b]
            decode = max(decode, decode_gap(P_v, ctx.config["vae"], z, imgs,
                                            tr["reference_rows"]))
    none = float("inf")
    checks = harness.Checks()
    lim = tr["limits"]
    checks.add("start_gap", start if picked else none, 0.0)
    checks.add("unet_gap", unet_gap if picked else none, lim["unet_gap"])
    checks.add("update_gap", update_gap if picked else none, lim["update_gap"])
    checks.add("decode_gap", decode if picked else none, lim["decode_gap"])
    return checks
