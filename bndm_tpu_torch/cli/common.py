"""Shared CLI plumbing: devices, run-folder naming, L loading, weights IO.

Counterpart of ``bndm_tpu/cli/common.py``. The reference encodes run
identity in the output directory name computed from flag values and *finds*
checkpoints at test time by recomputing that name; the convention is
reproduced exactly, so the JAX CLI and this one share run folders.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bndm_tpu_torch.ops.cov import load_cov_L


def resolve_device(name="cuda"):
    """The torch device an entry point runs on. CUDA unless the caller asks
    for the CPU; raises when CUDA was asked for and is missing, rather than
    carrying on quietly on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device=cpu to run on the CPU")
    return dev


def disable_tf32():
    """Full fp32 for float32 matmuls and convolutions. cuDNN runs fp32
    convolutions in TF32 by default (10-bit mantissa); the JAX reference's
    fp32 path does not."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_generator(device, *seeds):
    """A ``torch.Generator`` on ``device`` seeded from a path of integers
    (e.g. (seed, batch index)): distinct paths give independent streams."""
    s = int(np.random.SeedSequence([int(v) for v in seeds]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def output_folder_name(opt):
    """Reference run-folder naming."""
    outer = (
        f"results_gaussianBN_{opt.conditional_type}" if opt.is_conditional else "results_gaussianBN"
    )
    if opt.scheduler_gamma == "linear" or opt.optimize_scheduler_param:
        name = f"{opt.dataset}_{opt.noise_type}_{opt.scheduler_gamma}_outc{opt.out_channel}_seed{opt.seed}"
    else:
        remap = "_remap" if opt.remap else ""
        name = (
            f"{opt.dataset}_{opt.noise_type}_{opt.scheduler_gamma}_{opt.scheduler_param}"
            f"_{opt.scheduler_param_s}_{opt.scheduler_param_e}_outc{opt.out_channel}{remap}_seed{opt.seed}"
        )
    return os.path.join(outer, name)


def noise_folder_name(noise_type):
    return {
        "gaussianBN": "gwn2gbn",
        "gaussian": "gwn",
        "gaussianRN": "gwn2grn",
        "GBN": "gbn",
    }[noise_type]


def load_L_for(noise_type, bluenoise_dir="bluenoise"):
    kind = "red" if noise_type == "gaussianRN" else "blue"
    return load_cov_L(res=64, dimension=3, kind=kind,
                      search_dirs=(".", bluenoise_dir), cache_dir=bluenoise_dir)


def load_params(path):
    """A flat ``.npz`` params file (as the JAX package's ``save_params``
    writes it, keys 'params/a/b/leaf') -> nested dict of numpy arrays."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def load_pixel_unet_params(out_dir):
    """Weights for the pixel CLI's test path, as a torch state_dict on the
    CPU: the JAX package's ``model.npz`` first (carried across by
    ``state_dict_from_flax``), else the reference's torch ``model.ckpt`` at
    the same path."""
    from bndm_tpu_torch.models.convert import (canonical_state_dict,
                                               load_torch_checkpoint,
                                               state_dict_from_flax)

    npz = os.path.join(out_dir, "model.npz")
    if os.path.exists(npz):
        return state_dict_from_flax(load_params(npz))
    ckpt = os.path.join(out_dir, "model.ckpt")
    if os.path.exists(ckpt):
        print(f"loading reference torch checkpoint: {ckpt}")
        return canonical_state_dict(load_torch_checkpoint(ckpt))
    raise FileNotFoundError(f"no model.npz or model.ckpt in {out_dir}")


def _to_numpy(arr):
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def save_image_grid(arr_nchw, path):
    """Write each image of a [-1, 1] NCHW batch to ``path.format(i)``."""
    from PIL import Image

    a = _to_numpy(arr_nchw)
    a = np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    a = (np.transpose(a, (0, 2, 3, 1)) * 255).astype(np.uint8)
    for i, img in enumerate(a):
        Image.fromarray(img).save(path.format(i))


class AsyncImageWriter:
    """Background PNG encoder for gallery-scale eval.

    Encoding on a daemon thread overlaps PIL with the next batch's sampling.
    A bounded queue applies back-pressure so at most ``max_queue`` batches of
    pixels are in flight. Encode errors are captured and re-raised on the
    next submit()/close(), never silently dropped.
    """

    def __init__(self, max_queue: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_queue)
        self._err = None
        self._n = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                arr, path = item
                save_image_grid(arr, path)
                self._n += arr.shape[0]
            except Exception as e:  # noqa: BLE001 — surfaced on submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, arr_nchw, path):
        if self._err:
            raise self._err
        self._q.put((_to_numpy(arr_nchw), path))

    def close(self):
        """Drain the queue, stop the thread, re-raise any encode error.
        Returns the number of images written."""
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
        return self._n
