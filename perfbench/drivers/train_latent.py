"""Latent BNDM training: the ``train_step`` of
``bndm_tpu_torch.train.latent.make_latent_train_step`` with the HF AdamW of
``bndm_tpu_torch.train.schedules_lr.hf_adamw``, fed as the latent CLI's
train loop feeds it: set-up draws the cache's latents from the seed and
writes them into ``TMPDIR`` with the program's ``LatentCacheWriter``; each
step takes its batch from ``LatentCacheDataset.batches`` (shuffled epochs
of key (seed, epoch), the rows gathered from the memory-mapped file and
cast to float32 on the host) and copies it to the card from pageable
memory, on the main thread (no loader thread)."""

from __future__ import annotations

import shutil
import tempfile
import types

import numpy as np
import torch

from perfbench import datagen, harness, weights
from perfbench.drivers import _port, _train
from perfbench.reference import model_of, noise


def unet_model(ctx, init):
    """The program's ``UNet2D`` of the configuration's ``port`` entry on the
    run's device, loaded with ``init``."""
    from bndm_tpu_torch.models.unet2d import UNet2D

    model = UNet2D(_port.unet_config(ctx.config["port"]), device="meta").to_empty(
        device=ctx.device)
    model.load_state_dict(init, strict=True)
    return model


class _Program:
    def __init__(self, ctx, latents, L, model):
        from bndm_tpu_torch.data.latent_cache import LatentCacheDataset, LatentCacheWriter
        from bndm_tpu_torch.ops import cuda_bluenoise
        from bndm_tpu_torch.train.latent import LatentTrainConfig, make_latent_train_step
        from bndm_tpu_torch.train.schedules_lr import hf_adamw

        port, spec = ctx.config["port"], ctx.config["train"]
        args = types.SimpleNamespace(
            gradient_accumulation_steps=1, lr_scheduler=spec["lr_scheduler"],
            learning_rate=spec["lr"], lr_warmup_steps=spec["lr_warmup_steps"],
            adam_beta1=spec["betas"][0], adam_beta2=spec["betas"][1],
            adam_epsilon=spec["eps"], adam_weight_decay=spec["weight_decay"])
        step, init_state = make_latent_train_step(
            LatentTrainConfig(**port["train_config"]), L, hf_adamw(args, spec["lr_total_steps"]))
        self.state = init_state(model.train())
        self._step = step
        self.params = dict(model.named_parameters())
        self.optimizer = self.state.opt.opt
        harness.stage(ctx, "model and train state built")
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        writer = LatentCacheWriter(self.tmp, latents.shape[1:])
        for row in latents:
            writer.add(row)
        writer.finalize()
        del writer
        harness.stage(ctx, "latent cache written")
        self.ds = LatentCacheDataset(self.tmp)
        self.batch, self.seed, self.device = ctx.traffic["batch_size"], ctx.seed, ctx.device
        self.epoch, self.it = 0, None
        self._k1 = cuda_bluenoise.tri_matmul
        self.m = self.batch * latents.shape[1]

    def next_batch(self):
        while True:
            if self.it is None:
                self.it = self.ds.batches(self.batch, seed=(self.seed, self.epoch))
                self.epoch += 1
            try:
                b = next(self.it)
            except StopIteration:
                self.it = None
                continue
            return torch.from_numpy(np.asarray(b)).to(self.device, non_blocking=True)

    def step(self, batch, key):
        return self._step(self.state, batch, key)

    def counters(self):
        return {"k1": self._k1.launches_by_m[self.m]}

    def close(self):
        self.it = self.ds = None
        shutil.rmtree(self.tmp, ignore_errors=True)


def epoch_batches(latents, seed, epoch, batch_size, count):
    """The first ``count`` batches of an epoch as the cache's rules give
    them: a shuffle from ``default_rng((seed, epoch))``, each batch's rows
    in ascending order, float32."""
    rng = np.random.default_rng((int(seed), int(epoch)))
    idx = np.arange(len(latents))
    rng.shuffle(idx)
    return [torch.from_numpy(latents[np.sort(idx[b * batch_size:(b + 1) * batch_size])])
            .float() for b in range(count)]


def inputs(ctx):
    """What set-up makes from the seed and hands to the program and to the
    reference: the cache's latents (float16, on the host, of the shape the
    configuration's ``reference`` entry gives as its ``input``), the
    blue-noise factor, the model's spec (``model_of``); and the batches of
    the first steps as the cache's rules give them."""
    tr = ctx.traffic
    bs = tr["batch_size"]
    _, spec, settings = model_of(ctx.config)
    shape = (tr["latents"], *ctx.config["reference"]["input"])
    latents = datagen.normal(ctx.seed, 1, shape, ctx.device, torch.float16).cpu().numpy()

    def data(n):
        nb, out = len(latents) // bs, []
        for epoch in range(-(-n // nb)):
            out += epoch_batches(latents, ctx.seed, epoch, bs, min(nb, n - epoch * nb))
        return [x.to(ctx.device) for x in out]

    return types.SimpleNamespace(spec=spec(settings), L=noise.make_L(device=ctx.device),
                                 latents=latents, data=data)


def run(ctx, build_model=unet_model):
    """The cell's run; ``build_model(ctx, init)`` builds the program's model
    (a configuration of another backbone passes its own)."""
    inp = ctx.inputs = inputs(ctx)
    return _train.run(ctx, lambda: _Program(
        ctx, inp.latents, inp.L, build_model(ctx, weights.make(inp.spec, ctx.seed, ctx.device))))
