"""Host-side image data: ImageFolder listing, transforms and synthetic trees.

Counterpart of ``bndm_tpu/data/imagefolder.py`` for the serving slice: the
reference's torchvision transform (Resize(shorter side) -> CenterCrop ->
optional horizontal flip -> ToTensor) written with PIL and numpy. Outputs are
float32 CHW in [0, 1]. The JAX package's native C++ transform and its
``BatchLoader`` come to the port later (ROADMAP.md, queue 1 item 6 and the
training slice).
"""

from __future__ import annotations

import os

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp")


def _list_images(root):
    files = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(_EXTS):
                files.append(os.path.join(dirpath, n))
    files.sort()
    return files


def _resized_dims(w, h, res):
    """torchvision Resize(res) output dims: shorter side -> res, keep aspect."""
    if w <= h:
        return res, max(res, int(round(h * res / w)))
    return max(res, int(round(w * res / h))), res


def _load_and_transform(path, res, hflip, crop_u=None):
    """``crop_u``: None for center crop (torchvision CenterCrop), or a
    (u_top, u_left) pair in [0, 1) mapped over the valid offset range — the
    torchvision RandomCrop behavior HF train_unconditional uses when
    --center_crop is absent (reference ddim_diffusers.py:539)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    nw, nh = _resized_dims(w, h, res)
    if crop_u is None:
        top = left = -1  # center
    else:
        top = int(crop_u[0] * (nh - res + 1))
        left = int(crop_u[1] * (nw - res + 1))

    img = img.resize((nw, nh), Image.BILINEAR)
    if top < 0:
        left = (nw - res) // 2
        top = (nh - res) // 2
    img = img.crop((left, top, left + res, top + res))
    a = np.asarray(img, dtype=np.float32) / 255.0  # HWC
    if hflip:
        a = a[:, ::-1, :]
    return np.ascontiguousarray(np.transpose(a, (2, 0, 1)))  # CHW, torch-ready


class ImageFolderDataset:
    def __init__(self, root, res, random_flip=True, seed=0, random_crop=False):
        self.files = _list_images(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.res = res
        self.random_flip = random_flip
        self.random_crop = random_crop
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def get(self, idx, hflip=False, crop_u=None):
        return _load_and_transform(self.files[idx], self.res, hflip, crop_u)


def make_synthetic_folder(root, n=8, res=64, seed=0):
    """Write a tiny synthetic ImageFolder tree (for tests/demos)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    cls = os.path.join(root, "class0")
    os.makedirs(cls, exist_ok=True)
    for i in range(n):
        arr = (rng.uniform(0, 255, (res, res, 3))).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(cls, f"img_{i:04d}.png"))
    return root


def make_procedural_folder(root, n=4096, res=64, seed=0):
    """Write a structured procedural ImageFolder tree — a learnable offline
    stand-in for the reference's photo datasets (r5, VERDICT r4 #3: no
    network, so sustained training runs use procedural data instead of
    AFHQ/LSUN). Each image is a smooth random field: a 2-4 term sum of 2-D
    sinusoid color gradients plus 1-3 soft gaussian blobs — low-entropy,
    spatially correlated content a diffusion model demonstrably learns
    (loss curve artifact committed from the r5 training run), unlike
    :func:`make_synthetic_folder`'s uniform noise.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    cls = os.path.join(root, "class0")
    os.makedirs(cls, exist_ok=True)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    for i in range(n):
        img = np.zeros((res, res, 3), np.float32)
        for _ in range(rng.integers(2, 5)):
            fx, fy = rng.uniform(-3, 3, 2)
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
            img += wave[..., None] * rng.uniform(0.1, 0.5, 3).astype(np.float32)
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.1, 0.9, 2)
            s = rng.uniform(0.05, 0.25)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
            img += blob[..., None] * rng.uniform(-0.8, 0.8, 3).astype(np.float32)
        img = (img - img.min()) / (np.ptp(img) + 1e-8)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(cls, f"img_{i:05d}.png"))
    return root
