"""Pixel BNDM training: ``bndm_tpu_torch.train.pixel.PixelTrainer.step``
fed by ``bndm_tpu_torch.data.imagefolder.BatchLoader`` (shuffled epochs,
random flips, its decode threads) over a folder of procedural PNGs that
set-up writes into ``TMPDIR``, as the pixel CLI's train mode runs them."""

from __future__ import annotations

import shutil
import tempfile
import types

import numpy as np
import torch

from perfbench import datagen, harness, weights
from perfbench.drivers import _port, _train
from perfbench.reference import nets, noise


class _Program:
    def __init__(self, ctx, images, L, init):
        from bndm_tpu_torch.data.imagefolder import BatchLoader, ImageFolderDataset
        from bndm_tpu_torch.models.unet2d import UNet2D
        from bndm_tpu_torch.ops import cuda_bluenoise
        from bndm_tpu_torch.train.pixel import PixelTrainer, TrainConfig

        port = ctx.config["port"]
        mcfg = _port.unet_config(port)
        model = UNet2D(mcfg, device="meta").to_empty(device=ctx.device)
        model.load_state_dict(init, strict=True)
        harness.stage(ctx, "model loaded")
        tcfg = dict(port["train_config"])
        tcfg["gamma_defaults"] = tuple(tcfg["gamma_defaults"])
        self.trainer = PixelTrainer(model.train(), TrainConfig(**tcfg), L, seed=ctx.seed)
        self.params = dict(model.named_parameters())
        self.optimizer = self.trainer.state.opt
        harness.stage(ctx, "model and train state built")
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        datagen.write_pngs(images, self.tmp)
        harness.stage(ctx, "images written")
        tr = ctx.traffic
        ds = ImageFolderDataset(self.tmp, images.shape[1], random_flip=True, seed=ctx.seed)
        self.loader = BatchLoader(ds, tr["batch_size"], seed=ctx.seed,
                                  num_threads=tr["loader_threads"])
        self.epoch, self.it = 0, None
        self.device = ctx.device
        self._k2 = cuda_bluenoise.fused_bluenoise_flat

    def next_batch(self):
        while True:
            if self.it is None:
                self.it = self.loader.epoch(self.epoch)
                self.epoch += 1
            try:
                b = next(self.it)
            except StopIteration:
                self.it = None
                continue
            return torch.from_numpy(b).to(self.device, non_blocking=True)

    def step(self, batch, key):
        return self.trainer.step(batch, key)

    def counters(self):
        return {"k2": self._k2.launches}

    def close(self):
        if self.it is not None:
            self.it.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def epoch_batches(images, seed, epoch, batch_size, count):
    """The first ``count`` batches of an epoch as the loader's rules give
    them: a shuffle and a flip draw from ``default_rng((seed, epoch))``,
    images over 255, CHW."""
    rng = np.random.default_rng((int(seed), int(epoch)))
    idx = np.arange(len(images))
    rng.shuffle(idx)
    flips = rng.random(len(images)) < 0.5
    out = []
    for b in range(count):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        x = torch.from_numpy(images[sel]).float() / 255.0
        x = torch.where(torch.from_numpy(flips[sel])[:, None, None, None], x.flip(2), x)
        out.append(x.permute(0, 3, 1, 2).contiguous())
    return out


def inputs(ctx):
    """What set-up makes from the seed and hands to the program and to the
    reference: the images, the blue-noise factor, the model's spec; and the
    batches of the first steps as the loader's rules give them."""
    unet_cfg = ctx.config["unet"]
    res, bs = unet_cfg["sample_size"], ctx.traffic["batch_size"]
    images = datagen.procedural_images(ctx.seed, ctx.traffic["images"], res, ctx.device)

    def data(n):
        return [2.0 * x.to(ctx.device) - 1.0 for x in epoch_batches(images, ctx.seed, 0, bs, n)]

    return types.SimpleNamespace(unet_cfg=unet_cfg, spec=nets.unet_spec(unet_cfg), res=res,
                                 L=noise.make_L(device=ctx.device), images=images, data=data)


def run(ctx):
    inp = ctx.inputs = inputs(ctx)
    ctx.flops_forward = lambda b: ctx.flops.unet_forward(inp.unet_cfg, b, inp.res)
    return _train.run(ctx, lambda: _Program(ctx, inp.images, inp.L,
                                            weights.make(inp.spec, ctx.seed, ctx.device)))
