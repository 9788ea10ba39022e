"""Memory-mapped latent cache of the latent pipeline.

The port's own copy of ``bndm_tpu/data/latent_cache.py`` (numpy): the
pipeline VAE-encodes every training image (x2 for hflip) once and stores
the fp16 latents in one flat ``latents.npy``, memory-mapped at read time,
with a ``meta.json`` beside it. ``batches(seed=(seed, epoch))`` draws the
JAX package's order exactly (``np.random.default_rng`` of the same seed).
"""

from __future__ import annotations

import json
import os

import numpy as np

from bndm_tpu_torch.utils.timing import span


class LatentCacheWriter:
    def __init__(self, path, latent_shape, dtype=np.float16):
        self.path = path
        self.latent_shape = tuple(latent_shape)
        self.dtype = np.dtype(dtype)
        os.makedirs(path, exist_ok=True)
        self._items = []

    def add(self, latent):
        latent = np.asarray(latent, self.dtype)
        assert latent.shape == self.latent_shape, (latent.shape, self.latent_shape)
        self._items.append(latent)

    def finalize(self):
        arr = np.stack(self._items) if self._items else np.zeros((0, *self.latent_shape), self.dtype)
        np.save(os.path.join(self.path, "latents.npy"), arr)
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump({"count": len(self._items), "shape": list(self.latent_shape),
                       "dtype": self.dtype.name}, f)
        return len(self._items)


class LatentCacheDataset:
    def __init__(self, path):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.latents = np.load(os.path.join(path, "latents.npy"), mmap_mode="r")

    def __len__(self):
        return self.meta["count"]

    def __getitem__(self, idx):
        return np.asarray(self.latents[idx], np.float32)

    def batches(self, batch_size, shuffle=True, seed=0, drop_last=True,
                shard_index=0, shard_count=1):
        rng = np.random.default_rng(seed)
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        idx = idx[shard_index::shard_count][:len(self) // shard_count]  # equal per shard
        nb = len(idx) // batch_size if drop_last else -(-len(idx) // batch_size)
        for b in range(nb):
            sel = idx[b * batch_size:(b + 1) * batch_size]
            with span("data.next"):
                batch = np.asarray(self.latents[np.sort(sel)], np.float32)
            yield batch
